"""The port's serving tier on the CPU: the round batcher, ``attest_many``
and ``prove_many``, the process backend, ``StreamingVerifier`` and
``verify_batch``, and exact launch counters under threads.

The committed goldens are the oracle (``tests/data/golden{,_llama}_*.bin``,
made by the JAX package): nothing is proved or verified on JAX here.  The
JAX package appears only to hold the port's v2 frame reader against its
own on the golden stream."""
import os
import sys
import threading
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest
import torch

from repro.api import codec as JCODEC
from repro_torch import api
from repro_torch.api import codec
from repro_torch.core import blocks as B
from repro_torch.core import field as F
from repro_torch.core import sumcheck as SC
from repro_torch.core.transcript import Transcript
from repro_torch.runtime import engine as E

DATA = os.path.join(os.path.dirname(__file__), "data")
MODELS = {
    "gpt2": dict(cfg=dict(family="gpt2", d=8, dff=16, heads=1, kv_heads=1,
                          dh=8, seq=4),
                 seeds=(1234, 5678), prefix="golden", name="golden-model"),
    "llama": dict(cfg=dict(family="llama", d=8, dff=16, heads=2, kv_heads=1,
                           dh=4, seq=4),
                  seeds=(4321, 8765), prefix="golden_llama",
                  name="golden-llama"),
}
POLICY = api.VerifyPolicy(pcs_queries=1)
TOKENS = np.arange(3, dtype=np.int32)


def _read(name):
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _query(cfg, seed):
    qrng = np.random.default_rng(seed)
    return np.clip(np.round(qrng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256),
                   -32768, 32767).astype(np.int64)


def _bytes(att, version, prove_seconds=0.0):
    """Wire bytes with the prove_seconds telemetry set (the goldens carry
    the JAX run's)."""
    att.prove_seconds = prove_seconds
    att.__dict__.pop("_wire_cache", None)
    return att.to_bytes(version)


class Model:
    """A golden toy: config, weights, query, golden bytes, and services on
    the CPU that share one weight cache (the setup runs once)."""

    def __init__(self, family):
        m = MODELS[family]
        self.cfg = B.BlockCfg(**m["cfg"])
        self.weights = [B.init_weights(self.cfg,
                                       np.random.default_rng(m["seeds"][0]))]
        self.query = _query(self.cfg, m["seeds"][1])
        self.name = m["name"]
        self.gold = {v: _read(f"{m['prefix']}_{v}.bin")
                     for v in ("card", "v1", "v2")}
        self.gold_seconds = api.Attestation.from_bytes(
            self.gold["v1"], device="cpu").prove_seconds
        self.cache = E.WeightCommitCache()

    def service(self, **kw):
        return api.ProofService([self.cfg], self.weights, default_queries=1,
                                name=self.name, device="cpu",
                                weight_cache=self.cache, **kw)

    def golden_bytes(self, att):
        return (_bytes(att, 1, self.gold_seconds),
                _bytes(att, 2, self.gold_seconds))


@pytest.fixture(scope="module")
def models():
    return {f: Model(f) for f in MODELS}


@pytest.fixture(scope="module")
def process_services(models):
    """One resident process-backed service per family: each spawns its two
    worker processes once, on its first attest."""
    svcs = {f: m.service(workers=2, backend="process")
            for f, m in models.items()}
    yield svcs
    for svc in svcs.values():
        svc.close()


# ---------------------------------------------------------------------------
# The golden bytes through every serving path.
# ---------------------------------------------------------------------------
def test_default_is_two_workers(models):
    with models["gpt2"].service() as svc:
        assert svc.workers == 2


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_two_thread_workers_give_the_goldens(models, family):
    """workers=2 (the round batcher installed) proves the golden query to
    the JAX package's card, v1 and v2 bytes."""
    m = models[family]
    with m.service(workers=2) as svc:
        card = svc.model_card.to_bytes()
        att = svc.attest(m.query, POLICY, tokens=TOKENS)
        assert svc.last_report.launch_waves > 0
    assert card == m.gold["card"]
    assert m.golden_bytes(att) == (m.gold["v1"], m.gold["v2"])


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_process_backend_gives_the_goldens(models, process_services,
                                           family):
    m = models[family]
    svc = process_services[family]
    att = svc.attest(m.query, POLICY, tokens=TOKENS)
    assert m.golden_bytes(att) == (m.gold["v1"], m.gold["v2"])
    jobs = svc.last_report.process_jobs
    assert len(jobs) == 1 and jobs[0]["pid"] != os.getpid()
    # the child's kernel launches (none: the CPU runs the plain versions)
    assert jobs[0]["launches"] == dict.fromkeys(jobs[0]["launches"], 0)
    assert "sumcheck_round" in jobs[0]["launches"]
    # the weight ints and range tape stay behind; the tensors cross as
    # shared memory, so the job is a few KB whatever the weights' size
    assert jobs[0]["payload_bytes"] < 64 << 10


def test_attest_many_equals_serial_attests(models, process_services):
    """Three queries in one window, on two threads (their sum-checks share
    K3 calls) and on the process fleet: each equals its serial workers=1
    attest, and the golden query its golden bytes."""
    m = models["gpt2"]
    queries = [m.query, _query(m.cfg, 1), _query(m.cfg, 2)]
    twins = [_bytes(api.Attestation.from_bytes(m.gold["v2"], device="cpu"),
                    2)]
    with m.service(workers=1) as serial:
        twins += [_bytes(serial.attest(q, POLICY, tokens=TOKENS), 2)
                  for q in queries[1:]]
    with m.service(workers=2) as svc:
        atts = svc.attest_many(queries, [POLICY] * 3, [TOKENS] * 3)
        report = svc.last_report
    assert report.batch_size == 3 and report.jobs == 3
    assert report.batched_claims > 0
    assert [_bytes(a, 2) for a in atts] == twins
    atts = process_services["gpt2"].attest_many(queries, [POLICY] * 3,
                                                [TOKENS] * 3)
    assert [_bytes(a, 2) for a in atts] == twins
    assert m.golden_bytes(atts[0]) == (m.gold["v1"], m.gold["v2"])


def test_process_backend_raises_when_a_worker_dies(models,
                                                   process_services):
    """A worker process that dies fails its window with BrokenProcessPool
    (nothing waits for it forever); the next attest spawns a new fleet and
    gives the golden bytes."""
    m = models["gpt2"]
    svc = process_services["gpt2"]
    svc.attest(m.query, POLICY, tokens=TOKENS)      # the fleet is up
    pool = svc.engine_for(1)._pool
    for proc in list(pool._processes.values()):
        proc.kill()
    with pytest.raises(BrokenProcessPool):
        svc.attest(m.query, POLICY, tokens=TOKENS)
    att = svc.attest(m.query, POLICY, tokens=TOKENS)
    assert svc.engine_for(1)._pool is not pool
    assert m.golden_bytes(att) == (m.gold["v1"], m.gold["v2"])


def test_attest_many_rejects_mixed_pcs_queries(models):
    m = models["gpt2"]
    with m.service(workers=2) as svc:
        with pytest.raises(AssertionError, match="pcs_queries"):
            svc.attest_many([m.query, m.query],
                            [POLICY, api.VerifyPolicy(pcs_queries=2)])
        assert svc.attest_many([]) == []


# ---------------------------------------------------------------------------
# The round batcher.
# ---------------------------------------------------------------------------
def _claim(seed, d, n):
    rng = np.random.default_rng(seed)
    fs = tuple(torch.as_tensor(rng.integers(0, F.P, (n, 4))) for _ in range(d))
    for f in fs:
        f.view(-1)[:4] = torch.tensor([0, 1, F.P - 1, F.P - 2])
    tr = Transcript(f"claim{seed}", "cpu")
    tr.absorb_int(seed)
    return fs, tr


def _direct(fs, tr):
    proof, point = SC.prove(list(fs), tr)
    return proof, point, tr.state


def _run_batched(claims, batcher):
    """Every claim on its own registered thread, all released at once."""
    out, errors = {}, []
    gate = threading.Barrier(len(claims))

    def worker(i, fs, tr):
        batcher.register()
        try:
            gate.wait(timeout=30)
            proof, point = SC.prove(list(fs), tr)
            out[i] = (proof, point, tr.state)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            batcher.deregister()

    SC.add_round_batcher(batcher)
    try:
        threads = [threading.Thread(target=worker, args=(i, *c))
                   for i, c in enumerate(claims)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        SC.remove_round_batcher(batcher)
    return out, errors


def test_batcher_padded_k_equals_direct_prove():
    """Three same-shape claims (K = 3, padded to 4 with zero rows and zero
    states) and one of another shape, from four threads: every proof,
    point and sponge state equals the direct K = 1 prove."""
    shapes = [(2, 16), (2, 16), (2, 16), (3, 8)]
    claims = [_claim(i, d, n) for i, (d, n) in enumerate(shapes)]
    want = [_direct(*_claim(i, d, n)) for i, (d, n) in enumerate(shapes)]
    batcher = E.SumcheckRoundBatcher(timeout=5.0)
    got, errors = _run_batched(claims, batcher)
    assert not errors, errors
    for i, (proof, point, state) in enumerate(want):
        gp, gpt, gst = got[i]
        assert np.array_equal(gp.round_polys, proof.round_polys)
        assert gp.round_polys.dtype == np.uint32
        assert np.array_equal(gp.final_evals, proof.final_evals)
        assert torch.equal(gpt, point) and torch.equal(gst, state)
    assert batcher.batched_claims == 3
    assert batcher.launch_waves == 2
    assert batcher.wave_shapes == {(2, 16, 3): 1, (3, 8, 1): 1}
    # one flush ran both groups; every thread was in, so no timeout
    assert (batcher.flushes, batcher.timeout_flushes) == (1, 0)
    assert batcher.timeout_gather_seconds == 0.0
    assert batcher.flush_seconds > 0.0
    assert SC._ROUND_BATCHERS == ()


def test_batcher_timeout_flushes_a_partial_wave():
    """A registered thread that never submits a claim holds its peer's
    wave until the straggler timeout; the batcher counts that flush and
    its wait apart, and the proof equals the direct prove."""
    batcher = E.SumcheckRoundBatcher(timeout=0.05)
    idle_in, release = threading.Event(), threading.Event()

    def idle_peer():
        batcher.register()
        idle_in.set()
        release.wait(timeout=30)
        batcher.deregister()

    peer = threading.Thread(target=idle_peer)
    peer.start()
    idle_in.wait(timeout=30)
    try:
        got, errors = _run_batched([_claim(5, 2, 16)], batcher)
    finally:
        release.set()
        peer.join(timeout=30)
    assert not errors, errors
    want = _direct(*_claim(5, 2, 16))
    assert np.array_equal(got[0][0].round_polys, want[0].round_polys)
    assert (batcher.flushes, batcher.timeout_flushes) == (1, 1)
    assert batcher.timeout_gather_seconds >= 0.05
    assert batcher.gather_seconds == batcher.timeout_gather_seconds
    assert batcher.batched_claims == 0


def test_batcher_bypassed_by_unregistered_threads():
    batcher = E.SumcheckRoundBatcher()
    SC.add_round_batcher(batcher)
    try:
        fs, tr = _claim(7, 2, 8)
        proof, point = SC.prove(list(fs), tr)
    finally:
        SC.remove_round_batcher(batcher)
    want = _direct(*_claim(7, 2, 8))
    assert np.array_equal(proof.round_polys, want[0].round_polys)
    assert batcher.launch_waves == 0


def test_batcher_failure_raises_on_every_claim(monkeypatch):
    """A stacked K3 call that fails raises on each thread whose claim it
    carried; nothing falls back to per-claim calls."""
    def broken(factors, states):
        raise RuntimeError("injected K3 failure")
    monkeypatch.setattr(E.K3, "prove_rounds", broken)
    batcher = E.SumcheckRoundBatcher(timeout=5.0)
    got, errors = _run_batched([_claim(i, 2, 16) for i in range(2)],
                               batcher)
    assert not got and len(errors) == 2
    assert all("injected K3 failure" in str(e) for e in errors)
    assert batcher.launch_waves == 0


# ---------------------------------------------------------------------------
# Launch counters under threads.
# ---------------------------------------------------------------------------
def test_launch_counters_exact_under_threads():
    """Two threads drive every wrapper's counter function many times: the
    totals are exact (a bare += on a module global can lose updates)."""
    from repro_torch.kernels import modmatmul as K4
    from repro_torch.kernels import ntt_kernel as K2
    from repro_torch.kernels import poseidon2_kernel as K1
    from repro_torch.kernels import sumcheck_fold as K5
    from repro_torch.kernels import sumcheck_round as K3
    n, threads = 20000, 2
    long_plan = K2.plan(1 << 16, 1 << 14)
    before = dict(K1=K1.launches, K2=K2.launches, K2L=K2.long_launches,
                  K3=K3.launches, K4=K4.launches, K5=K5.launches,
                  s2=K2.launch_shapes[(3, 1 << 16, 1 << 14)],
                  s4=K4.launch_shapes[(4, 5, 6)])

    def drive():
        for _ in range(n):
            K1._count()
            K2._count(long_plan, 3, 1 << 16, 1 << 14)
            K3._count(3)
            K4._count(4, 5, 6)
            K5._count()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=drive) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    total = n * threads
    assert K1.launches - before["K1"] == total
    assert K2.launches - before["K2"] == 2 * total
    assert K2.long_launches - before["K2L"] == 2 * total
    assert K3.launches - before["K3"] == 3 * total
    assert K4.launches - before["K4"] == total
    assert K5.launches - before["K5"] == total
    assert K2.launch_shapes[(3, 1 << 16, 1 << 14)] - before["s2"] == total
    assert K4.launch_shapes[(4, 5, 6)] - before["s4"] == total


# ---------------------------------------------------------------------------
# Streaming and batch verification of the JAX-made golden stream.
# ---------------------------------------------------------------------------
def _frame_edges(wire):
    """Byte offsets where the v2 stream's prefix and each frame end."""
    edges = [codec._STREAM_PREFIX]
    off = codec._STREAM_PREFIX
    while off < len(wire):
        blen = int.from_bytes(wire[off + 4:off + 12], "big")
        off += codec._FRAME_HEADER + blen
        edges.append(off)
    assert off == len(wire)
    return edges


def _cuts(wire):
    """Every frame edge, one byte either side of it, and the frame
    headers' own field boundaries."""
    out = set()
    for e in _frame_edges(wire):
        out |= {e - 1, e, e + 1, e + 4, e + 12}
    return sorted(c for c in out if 0 < c < len(wire))


def _stream(models, chunks, **kw):
    m = models["gpt2"]
    sv = api.StreamingVerifier(m.query, m.gold["card"], POLICY,
                               device="cpu", **kw)
    reports = []
    for c in chunks:
        reports += sv.feed(c)
    return reports, sv.finish()


def test_streaming_accepts_golden_byte_by_byte(models):
    wire = models["gpt2"].gold["v2"]
    reports, final = _stream(models, [wire[i:i + 1]
                                      for i in range(len(wire))])
    assert final.ok and final.complete, final.reason
    assert final.checked_layers == 1 and final.attestation_bytes == len(wire)
    interim = [r for r in reports if not r.complete]
    assert [r.checked_layers for r in interim] == [0, 1]
    assert all(r.ok for r in reports)


def test_streaming_accepts_golden_cut_at_frame_edges(models):
    wire = models["gpt2"].gold["v2"]
    cuts = [0] + _cuts(wire) + [len(wire)]
    _, final = _stream(models, [wire[a:b] for a, b in zip(cuts, cuts[1:])])
    assert final.ok, final.reason


def test_streaming_rejects_reordered_and_truncated(models):
    wire = models["gpt2"].gold["v2"]
    e = _frame_edges(wire)         # prefix, HEAD, LAYR, END
    swapped = wire[:e[1]] + wire[e[2]:e[3]] + wire[e[1]:e[2]]
    _, final = _stream(models, [swapped])
    assert not final.ok and "manifest" in final.reason
    for keep in (e[2], e[3] - 1, e[1] + 10):
        _, final = _stream(models, [wire[:keep]])
        assert not final.ok and "truncated" in final.reason, final.reason
    _, final = _stream(models, [wire + b"\x00"])
    assert not final.ok and "after END" in final.reason


def test_streaming_flood_caps(models):
    wire = models["gpt2"].gold["v2"]
    reports, final = _stream(models, [wire[:64]] + [b""] * 6,
                             max_stalled_feeds=4)
    assert not final.ok and "zero-progress" in final.reason
    assert [r.ok for r in reports] == [False]
    reports, final = _stream(models, [wire[i:i + 128]
                                      for i in range(0, len(wire), 128)],
                             max_buffered_bytes=256)
    assert not final.ok and "buffered" in final.reason


def test_one_shot_verify_equals_streaming(models):
    m = models["gpt2"]
    for v in ("v1", "v2"):
        rep = api.verify(m.gold[v], m.query, m.gold["card"], POLICY,
                         device="cpu")
        assert rep.ok and rep.checked_layers == 1, rep.reason
    bad = bytearray(m.gold["v2"])
    bad[len(bad) // 2] ^= 0x01
    one = api.verify(bytes(bad), m.query, m.gold["card"], POLICY,
                     device="cpu")
    _, streamed = _stream(models, [bytes(bad)])
    assert not one.ok and one.reason == streamed.reason


def test_verify_batch_isolates_and_rejects_bad_card(models):
    m = models["gpt2"]
    bad = bytearray(m.gold["v2"])
    bad[-50] ^= 0x04
    wires = [bytes(bad), m.gold["v2"], m.gold["v1"]]
    reps = api.verify_batch(wires, [m.query] * 3, m.gold["card"], POLICY,
                            device="cpu")
    assert not reps[0].ok and reps[0].reason
    assert reps[1].ok and reps[2].ok, (reps[1].reason, reps[2].reason)
    reps = api.verify_batch(wires[1:], [m.query] * 2, b"not-a-card",
                            device="cpu")
    assert len(reps) == 2
    assert all(not r.ok and "card" in r.reason for r in reps)


def test_frame_reader_agrees_with_jax_at_every_edge(models):
    """The port's and the JAX package's v2 readers, fed the golden stream
    split at each cut: the same frame kinds come out of each feed, the
    same bytes stay buffered, and both accept the end."""
    wire = models["gpt2"].gold["v2"]

    def run(mod, parts):
        r = mod.FrameReader(b"ATTN")
        steps = []
        for p in parts:
            steps.append(([k for k, _ in r.feed(p)], len(r.buf), r.mpos,
                          r.done))
        r.finish()
        return steps

    for c in _cuts(wire):
        parts = [wire[:c], wire[c:]]
        assert run(codec, parts) == run(JCODEC, parts), c
    for keep in _cuts(wire):       # truncated: both readers refuse to finish
        for mod in (codec, JCODEC):
            r = mod.FrameReader(b"ATTN")
            r.feed(wire[:keep])
            with pytest.raises(mod.CodecError):
                r.finish()
