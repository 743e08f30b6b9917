"""The port's five CUDA kernels against their plain versions, the golden
attestation, and the soundness analysis, on the card.  Skipped where there
is no card; on one:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports the JAX package, which the
card's machine need not have; nothing here imports it.)"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

P = 2013265921
DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _words(seed, shape, dev):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.int64)
    flat = a.reshape(-1)
    k = min(4, flat.size)
    flat[:k] = [0, 1, P - 1, P - 2][:k]
    return torch.as_tensor(a, device=dev)


def _same(a, b):
    torch.cuda.synchronize()
    return a.shape == b.shape and bool((a == b).all().item())


def test_k1_poseidon2(dev):
    from repro_torch.kernels import poseidon2_kernel as K1
    for L in (1, 8, 13, 64):
        e = _words(L, (33, L), dev)
        assert _same(K1.hash_rows(e), K1.sponge_plain(None, e, L, 1, 8))
    l, r = _words(1, (40, 8), dev), _words(2, (40, 8), dev)
    assert _same(K1.compress_pairs(l, r), K1.compress_plain(l, r))
    s = _words(3, (300, 16), dev)
    assert _same(K1.permute_batch(s), K1.permute_plain(s))
    for a, b in zip(K1.squeeze(s[:2].contiguous(), 2), K1.squeeze_plain(s[:2], 2)):
        assert _same(a, b)
    v = _words(4, (2, 36), dev)
    assert _same(K1.sponge(s[:2].contiguous(), v, 4, 9),
                 K1.sponge_plain(s[:2], v, 4, 9))


def test_k1_single_row_sponges(dev):
    """The transcript's absorbs: one row from a given state, 16 lanes on one
    state and the other half-warp idle; a chain of up to 512 permutations."""
    from repro_torch.kernels import poseidon2_kernel as K1
    st = _words(5, (1, 16), dev)
    for L in (1, 4, 8, 9, 3243, 4096):
        e = _words(10 + L, (1, L), dev)
        assert _same(K1.sponge(st, e, L), K1.sponge_plain(st, e, L))
        assert _same(K1.sponge(None, e, L, 1, 8), K1.sponge_plain(None, e, L, 1, 8))
    # Transcript.absorb_each: k rows of w words as k tagged segments
    for k, w in ((3, 4), (21, 4), (5, 9), (2, 16)):
        e = _words(100 + k * w, (1, k * w), dev)
        assert _same(K1.sponge(st, e, w, k), K1.sponge_plain(st, e, w, k))


def test_k1_partial_warps(dev):
    """Row counts that leave warps partly full (two rows per warp, eight per
    block): the lanes past the last row still shuffle and store nothing."""
    from repro_torch.kernels import poseidon2_kernel as K1
    for n in (1, 3, 17, 33):
        e = _words(n, (n, 24), dev)
        assert _same(K1.hash_rows(e), K1.sponge_plain(None, e, 24, 1, 8))
        s = _words(50 + n, (n, 16), dev)
        assert _same(K1.permute_batch(s), K1.permute_plain(s))
    s = _words(6, (3, 16), dev)
    for nblocks in range(1, 10):
        for a, b in zip(K1.squeeze(s, nblocks), K1.squeeze_plain(s, nblocks)):
            assert _same(a, b)
    for n in (1, 7, 33):
        l, r = _words(60 + n, (n, 8), dev), _words(70 + n, (n, 8), dev)
        assert _same(K1.compress_pairs(l, r), K1.compress_plain(l, r))


def test_k2_ntt(dev):
    from repro_torch.kernels import ntt_kernel as K2
    for lg in range(1, 13):
        x = _words(lg, (5, 1 << lg), dev)
        for inv in (False, True):
            assert _same(K2.ntt_rows(x, inv), K2.ntt_rows_plain(x, inv))


def test_k2_rs_encode(dev):
    """The RS entry (unpadded rows in) against its plain version (pad, then
    the transform): every shape an attest and the setup launch, c = 1 and
    2, rows that leave a block part full, blowups 1, 2, 4, 8."""
    from repro_torch.kernels import ntt_kernel as K2
    cases = [(1024, 1024, 4), (256, 512, 4), (160, 64, 4), (512, 1024, 4),
             (1024, 2048, 4)]
    for c in (1, 2, 16, 512):
        for blowup in (1, 2, 4, 8):
            if c * blowup > 1:
                rpb = K2.rows_per_block(c * blowup)
                cases += [(1, c, blowup), (rpb + 1, c, blowup), (3 * rpb - 1, c, blowup)]
    for rows, c, blowup in cases:
        x = _words(rows * 7 + c + blowup, (rows, c), dev)
        before = K2.launches
        got = K2.rs_encode_rows(x, blowup)
        assert K2.launches - before == 1
        assert _same(got, K2.rs_encode_rows_plain(x, blowup)), (rows, c, blowup)
    for lg in (13, 14, 15):      # 2^15: the longest rows the card takes
        x = _words(lg, (3, 1 << lg), dev)
        for inv in (False, True):
            assert _same(K2.ntt_rows(x, inv), K2.ntt_rows_plain(x, inv))
    for c, blowup in ((1 << 13, 4), (1 << 12, 8)):
        x = _words(c + blowup, (2, c), dev)
        assert _same(K2.rs_encode_rows(x, blowup), K2.rs_encode_rows_plain(x, blowup))
    x = _words(21, (1, 1 << 21), dev)      # past the longest row (2^20)
    with pytest.raises(ValueError):
        K2.ntt_rows(x)


def test_k2_long_rows(dev):
    """Rows of 2^16 .. 2^20 words (two launches: 2^15-word blocks gathered
    at a stride, then the top stages) against the plain version: both
    transforms, the RS encode at blowups 4 (the weight, helper and
    verifier rows of a TinyLlama-width layer), 2 and 8, edge words
    planted, a single row and an odd row count; then 300 and 161 rows, so
    the first launch's persistent blocks and the top stages' grid-stride
    loop each take several turns.  Both launches count as long-row ones."""
    from repro_torch.kernels import ntt_kernel as K2
    for lg, rows in ((16, 3), (17, 3), (18, 1), (20, 1), (16, 300), (17, 161)):
        n = 1 << lg
        x = _words(lg + rows, (rows, n), dev)
        for inv in (False, True):
            before, long_before = K2.launches, K2.long_launches
            got = K2.ntt_rows(x, inv)
            assert K2.launches - before == 2
            assert K2.long_launches - long_before == 2
            assert _same(got, K2.ntt_rows_plain(x, inv)), (lg, rows, inv)
        for blowup in (2, 4, 8):
            msg = _words(lg + blowup + rows, (rows, n // blowup), dev)
            assert _same(K2.rs_encode_rows(msg, blowup),
                         K2.rs_encode_rows_plain(msg, blowup)), (lg, rows, blowup)
    msg = _words(5, (5, 1 << 14), dev)      # the verifier's Fp4 row: 4 + 1 rows
    long_before = K2.long_launches
    assert _same(K2.rs_encode_rows(msg, 4), K2.rs_encode_rows_plain(msg, 4))
    short = _words(6, (5, 1 << 13), dev)    # 2^15 words: one launch, not long
    assert _same(K2.rs_encode_rows(short, 4), K2.rs_encode_rows_plain(short, 4))
    assert K2.long_launches - long_before == 2


def test_k3_sumcheck_rounds(dev):
    from repro_torch.kernels import sumcheck_round as K3
    for d in (1, 2, 3):
        for K in (1, 3):
            for lg in (1, 4, 8, 12):
                fs = [_words(100 * d + 10 * K + lg + t, (K, 1 << lg, 4), dev)
                      for t in range(d)]
                st = _words(7 * lg + d, (K, 16), dev)
                for a, b in zip(K3.prove_rounds(fs, st),
                                K3.prove_rounds_plain(fs, st)):
                    assert _same(a, b)


def test_k3_tail_and_head_boundaries(dev):
    """n around the tail length (one block per claim, all rounds in shared
    memory) and above it (head rounds, ping-pong buffers): all four outputs,
    and the launches the plan predicts."""
    from repro_torch.kernels import sumcheck_round as K3
    for d in (1, 2, 3):
        nt = K3.tail_len(d)
        for K in (1, 3):
            for n in (2, nt // 2, nt, 2 * nt, 1 << 17):
                fs = [_words(1000 * d + 10 * K + n.bit_length() + t, (K, n, 4), dev)
                      for t in range(d)]
                st = _words(3 * n.bit_length() + d, (K, 16), dev)
                before = K3.launches
                got = K3.prove_rounds(fs, st)
                assert K3.launches - before == K3.plan(d, n, K).launches
                for a, b in zip(got, K3.prove_rounds_plain(fs, st)):
                    assert _same(a, b), (d, K, n)


def test_k3_threads_with_different_shared_memory(dev):
    """Two threads prove claims whose tail blocks ask for the most and far
    less dynamic shared memory (d = 3 at n_tail, d = 1 at n = 256), as a
    ProofService with thread workers does: every launch succeeds and every
    result equals the plain version."""
    import threading
    from repro_torch.kernels import sumcheck_round as K3
    inputs = {}
    for d, n in ((3, K3.tail_len(3)), (1, 256)):
        fs = [_words(50 * d + t, (1, n, 4), dev) for t in range(d)]
        st = _words(d, (1, 16), dev)
        inputs[d] = (fs, st, K3.prove_rounds_plain(fs, st))
    errors = []

    def run(d):
        fs, st, want = inputs[d]
        try:
            for i in range(50):
                if not all(_same(a, b) for a, b in zip(K3.prove_rounds(fs, st), want)):
                    errors.append((d, i, "differs"))
        except RuntimeError as e:
            errors.append((d, str(e)))

    threads = [threading.Thread(target=run, args=(d,)) for d in inputs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:4]


def test_k4_modmatmul(dev):
    from repro_torch.kernels import modmatmul as K4
    for (M, K, N) in ((4, 512, 1024), (4, 1, 3), (11, 33, 70), (9, 2, 40)):
        a, b = _words(M, (M, K), dev), _words(N, (K, N), dev)
        assert _same(K4.modmatmul(a, b), K4.modmatmul_plain(a, b))


def test_k4_plan_cases(dev):
    """M = 1, 4, 5, 11, 64; odd K; K below a warp of pairs; long K at
    narrow N; ragged and odd N; K = 0; one launch a call."""
    from repro_torch.kernels import modmatmul as K4
    shapes = [(M, K, N) for M in (1, 4, 5, 11) for K, N in
              ((1, 3), (7, 9), (31, 64), (33, 70), (256, 512))]
    shapes += [(4, 32, 64), (4, 1024, 1024), (4, 1024, 2048), (4, 1026, 1024),
               (3, 1025, 38), (4, 2048, 64), (4, 1024, 40), (4, 1022, 40),
               (64, 256, 4), (4, 0, 8)]
    for M, K, N in shapes:
        a, b = _words(M + K, (M, K), dev), _words(K + N, (K, N), dev)
        before = K4.launches
        got = K4.modmatmul(a, b)
        assert K4.launches - before == 1
        assert _same(got, K4.modmatmul_plain(a, b)), (M, K, N)


def test_k2_k4_threads(dev):
    """Two threads, one running K4 and one the RS entry, each at two shapes
    with different plans (K4: narrow N with long K, and the weight shape;
    K2: two row lengths and blowups), 50 calls each: every result equal to
    the plain version."""
    import threading
    from repro_torch.kernels import modmatmul as K4
    from repro_torch.kernels import ntt_kernel as K2
    a1, b1 = _words(1, (4, 1024), dev), _words(2, (1024, 40), dev)
    a2, b2 = _words(3, (4, 512), dev), _words(4, (512, 1024), dev)
    x1, x2 = _words(5, (256, 512), dev), _words(6, (33, 64), dev)
    jobs = {
        "K4": [(lambda: K4.modmatmul(a1, b1), K4.modmatmul_plain(a1, b1)),
               (lambda: K4.modmatmul(a2, b2), K4.modmatmul_plain(a2, b2))],
        "K2": [(lambda: K2.rs_encode_rows(x1, 4), K2.rs_encode_rows_plain(x1, 4)),
               (lambda: K2.rs_encode_rows(x2, 8), K2.rs_encode_rows_plain(x2, 8))],
    }
    errors = []

    def run(name):
        try:
            for i in range(50):
                fn, want = jobs[name][i % 2]
                if not _same(fn(), want):
                    errors.append((name, i, "differs"))
        except RuntimeError as e:
            errors.append((name, str(e)))

    threads = [threading.Thread(target=run, args=(k,)) for k in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:4]


def test_k5_sumcheck_fold(dev):
    """Against the plain version, one launch a call; 2^24 pairs' worth of
    words takes 64-bit offsets past 2^31 bytes."""
    from repro_torch.kernels import sumcheck_fold as K5
    cases = [(d, lg) for d in (1, 2, 3) for lg in (1, 2, 3, 5, 8, 9, 12, 17)]
    cases += [(2, 19), (1, 20), (2, 24)]   # more pairs than threads in the grid
    for d, lg in cases:
        fs = [_words(1000 * d + 10 * lg + t, (1 << lg, 4), dev)
              for t in range(d)]
        c = _words(7 * lg + d, (4,), dev)
        pg, pfolded = K5.fold_round_plain(fs, c)
        before = K5.launches
        g, folded = K5.fold_round(fs, c)
        assert K5.launches - before == 1, (d, lg)
        assert _same(g, pg), (d, lg)
        assert len(folded) == d and all(_same(a, b) for a, b in zip(folded, pfolded))
        del fs, pfolded, folded
    # the 16-byte loads need 16-byte aligned operands: a view one int64
    # word in raises
    words = _words(5, (65 * 4,), dev)
    skew = words[1:1 + 64 * 4].view(64, 4)
    c = _words(6, (4,), dev)
    with pytest.raises(ValueError, match="aligned"):
        K5.fold_round([skew, skew], c)
    with pytest.raises(ValueError, match="aligned"):
        K5.fold_round([words[:64 * 4].view(64, 4)], words[1:5])


def test_analysis_cli_on_card(dev):
    """``python -m repro_torch.analysis --all --mutants`` on the card: zero
    findings, every kernel equal to its plain version on edge words, all
    six mutants caught."""
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--all", "--mutants"],
        cwd=root, env=env, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "[analysis] OK" in proc.stdout


def test_golden_attestation_on_card(dev):
    from repro_torch import api
    from repro_torch.core import blocks as B
    cfg = B.BlockCfg(family="gpt2", d=8, dff=16, heads=1, kv_heads=1, dh=8,
                     seq=4)
    weights = [B.init_weights(cfg, np.random.default_rng(1234))]
    qrng = np.random.default_rng(5678)
    query = np.clip(np.round(qrng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256),
                    -32768, 32767).astype(np.int64)
    with api.ProofService([cfg], weights, default_queries=1, workers=1,
                          name="golden-model", device=dev) as svc:
        att = svc.attest(query, api.VerifyPolicy(pcs_queries=1),
                         tokens=np.arange(3, dtype=np.int32))
    gold = {}
    for v in (1, 2):
        with open(os.path.join(DATA, f"golden_v{v}.bin"), "rb") as fh:
            gold[v] = fh.read()
    att.prove_seconds = api.Attestation.from_bytes(gold[1]).prove_seconds
    att.__dict__.pop("_wire_cache", None)
    assert att.to_bytes(1) == gold[1]
    assert att.to_bytes(2) == gold[2]


def _golden_toy():
    from repro_torch.core import blocks as B
    cfg = B.BlockCfg(family="gpt2", d=8, dff=16, heads=1, kv_heads=1, dh=8,
                     seq=4)
    weights = [B.init_weights(cfg, np.random.default_rng(1234))]
    qrng = np.random.default_rng(5678)
    query = np.clip(np.round(qrng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256),
                    -32768, 32767).astype(np.int64)
    with open(os.path.join(DATA, "golden_v2.bin"), "rb") as fh:
        gold = fh.read()
    return cfg, weights, query, gold


def _golden_v2(att, gold):
    from repro_torch import api
    att.prove_seconds = api.Attestation.from_bytes(gold).prove_seconds
    att.__dict__.pop("_wire_cache", None)
    return att.to_bytes(2)


def test_round_batcher_k2_on_card(dev):
    """Two golden queries in one window on two worker threads: their
    sum-checks meet in K = 2 K3 calls, and both attestations are the
    golden bytes."""
    from repro_torch import api
    from repro_torch.kernels import sumcheck_round as K3
    cfg, weights, query, gold = _golden_toy()
    with api.ProofService([cfg], weights, default_queries=1, workers=2,
                          name="golden-model", device=dev) as svc:
        tok = np.arange(3, dtype=np.int32)
        before = K3.launches
        atts = svc.attest_many([query, query],
                               [api.VerifyPolicy(pcs_queries=1)] * 2,
                               [tok, tok])
        report = svc.last_report
    assert K3.launches > before
    assert report.batched_claims > 0
    assert any(k == 2 for (_, _, k) in report.wave_shapes)
    assert [_golden_v2(a, gold) for a in atts] == [gold, gold]


def _child_receive(device, blob):
    """Spawned side of the IPC check: device bytes allocated before and
    after unpickling a CUDA tensor, and the tensor's sum."""
    import pickle
    torch.cuda.set_device(torch.device(device))
    torch.cuda.init()
    before = torch.cuda.memory_allocated()
    t = pickle.loads(blob)
    after = torch.cuda.memory_allocated()
    total = int(t.sum().item())
    del t
    return before, after, total


def test_process_backend_ipc_without_copy(dev):
    """A 256 MiB CUDA tensor pickled as the process backend pickles its
    jobs crosses as an IPC handle of a few hundred bytes: the spawned
    child reads it with its allocated memory flat, and once the child has
    let it go the parent frees it at once (its allocation back at its
    baseline, nothing held over for the child).  Then the golden query
    through two worker processes gives the golden bytes, its job's payload
    stays small with the child's allocation flat, and after ``close()``
    the parent's allocation is back at its baseline."""
    import gc
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing.reduction import ForkingPickler

    from repro_torch import api
    spawn = torch.multiprocessing.get_context("spawn")
    base = torch.cuda.memory_allocated(dev)
    x = torch.arange(1 << 25, dtype=torch.int64, device=dev)
    want = int(x.sum().item())
    blob = bytes(ForkingPickler.dumps(x))
    assert len(blob) < 4096
    with ProcessPoolExecutor(1, mp_context=spawn) as pool:
        before, after, total = pool.submit(_child_receive, str(dev),
                                           blob).result()
    assert after == before
    assert total == want
    del x
    assert torch.cuda.memory_allocated(dev) == base

    cfg, weights, query, gold = _golden_toy()
    policy = api.VerifyPolicy(pcs_queries=1)
    tok = np.arange(3, dtype=np.int32)

    def service(**kw):
        return api.ProofService([cfg], weights, default_queries=1, workers=2,
                                name="golden-model", device=dev, **kw)
    with service() as svc:      # the parent's lazily built constants
        svc.attest(query, policy, tokens=tok)
    del svc
    gc.collect()
    base = torch.cuda.memory_allocated(dev)
    with service(backend="process") as svc:
        att = svc.attest(query, policy, tokens=tok)
        jobs = svc.last_report.process_jobs
    del svc
    gc.collect()
    assert torch.cuda.memory_allocated(dev) == base
    assert _golden_v2(att, gold) == gold
    assert len(jobs) == 1 and jobs[0]["allocated_after_payload"] == 0
    assert jobs[0]["launches"]["sumcheck_round"] > 0
    assert jobs[0]["payload_bytes"] < 64 << 10


def _train_step_run(arch, device, steps, compress):
    """``make_train_step`` on a smoke config at float32 compute, weights
    drawn on the CPU from seed 0 and moved to ``device``; the losses, grad
    norms and final bf16 weights (as float32 host arrays)."""
    import dataclasses
    from repro_torch._tree import leaves, tree_map
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import adamw, compression
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    params = tree_map(lambda p: p.to(device),
                      M.init(cfg, sh, torch.Generator().manual_seed(0), "cpu"))
    opt = adamw.AdamWCfg(lr=1e-3, warmup_steps=1, total_steps=steps)
    step = T.make_train_step(cfg, sh, opt, T.TrainCfg(
        microbatches=2, compress_grads=compress, remat=True))
    st = adamw.init(params)
    ef = compression.init_ef(params)
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab, 0), 4, 16)
    metrics = []
    for _ in range(steps):
        toks, labels = (torch.from_numpy(a).to(device, torch.int64)
                        for a in pipe.next_batch())
        params, st, ef, m = step(params, st, ef, toks, labels)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, [p.float().cpu().numpy() for p in leaves(params)]


@pytest.mark.parametrize("compress,steps", [(False, 3), (True, 1)])
@pytest.mark.parametrize("arch", ["gpt2_small", "tinyllama_1_1b", "gemma3_1b"])
def test_train_step_on_card_equals_cpu(dev, arch, compress, steps):
    """The training step computes the same on the card as on the CPU,
    within tests/test_torch_train_step.py's tolerances (loss and grad
    norm rtol 1e-4; every weight within 2 lr k + 2^-7 |p|, at most 0.5%
    of them different).  With int8 compression one step: a code that
    rounds the other way moves its weight by 2 lr, which changes the next
    step's gradients well past float32 rounding.  TF32 stays off: the
    float32 matmuls are float32."""
    assert not torch.backends.cuda.matmul.allow_tf32
    card, card_w = _train_step_run(arch, dev, steps, compress)
    cpu, cpu_w = _train_step_run(arch, torch.device("cpu"), steps, compress)
    for (a, b), (c, d) in zip(card, cpu):
        assert a == pytest.approx(c, rel=1e-4) and b == pytest.approx(d, rel=1e-4)
    changed = total = 0
    for a, b in zip(card_w, cpu_w):
        diff = np.abs(a - b)
        assert np.all(diff <= 2 * 1e-3 * steps + 2.0 ** -7 * np.abs(b))
        changed += int(np.count_nonzero(diff))
        total += b.size
    assert changed <= 0.005 * total


def _zoo_smoke_run(arch, device):
    """A zoo smoke config at float32, weights drawn on the CPU from seed 0
    (embedding x 50, as tests/test_torch_models.py scales it) and moved to
    ``device``: no-cache logits (whisper with a seeded enc_input) and 6
    greedy tokens of ``generate`` with the LUT ops off, on the host."""
    import dataclasses
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    gen = torch.Generator().manual_seed(0)
    params = M.init(cfg, sh, gen, "cpu")
    params["embed"] = params["embed"] * 50.0
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    enc = None
    if cfg.encoder is not None:
        enc = torch.randn((2, cfg.encoder.frames, cfg.d), generator=gen)
        enc = enc.to(device)
    params = tree_map(lambda p: p.to(device), params)
    with torch.no_grad():
        logits, _, _ = M.forward(cfg, sh, params, prompt.to(device),
                                 enc_input=enc)
    toks = S.generate(cfg, sh, params, prompt.to(device),
                      S.ServeCfg(max_new_tokens=6), use_lut=False)
    return logits.cpu(), toks.cpu()


@pytest.mark.parametrize("arch", ["grok_1_314b", "moonshot_v1_16b_a3b",
                                  "jamba_v0_1_52b", "qwen2_vl_72b",
                                  "whisper_small", "xlstm_350m"])
def test_zoo_smoke_twin_on_card_equals_cpu(dev, arch):
    """The MoE (both dispatches), M-RoPE, the encoder with cross-attention,
    Mamba and xLSTM compute the same on the card as on the CPU: logits
    within tests/test_torch_models.py's exact-path tolerance (rtol 1e-4,
    atol 1e-4 x the largest |logit|), greedy tokens equal."""
    card, card_toks = _zoo_smoke_run(arch, dev)
    cpu, cpu_toks = _zoo_smoke_run(arch, torch.device("cpu"))
    scale = float(cpu.abs().max())
    torch.testing.assert_close(card, cpu, rtol=1e-4, atol=1e-4 * scale)
    assert torch.equal(card_toks, cpu_toks)


def test_dryrun_estimate_on_card(dev):
    """The dry run's estimate of a one-device cell held against the same
    step on the card, as chip_smoke's dryrun phase holds it
    (``dryrun.check_on_card``): qwen1.5-0.5b decode_32k cut to batch 2 (a
    cache of 32768 a layer, ~7 GB): the bytes ``memory_allocated`` gains
    for the arguments within the caching allocator's rule applied to each
    tensor, the bytes requested equal to the estimate, the peak within
    10%, FlopCounterMode's count equal to the meta trace's."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    cell, _ = D.build_cell("qwen1_5_0_5b", "decode_32k",
                           mesh=make_debug_mesh(1, 1), batch=2)
    got = D.check_on_card(cell, dev,
                          torch.Generator(device=dev).manual_seed(0))
    assert not got["misses"], got["misses"]
    assert got["flops"] == got["estimate"]["flops_traced"] > 0
