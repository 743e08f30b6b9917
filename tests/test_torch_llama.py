"""The llama block family of repro_torch against the JAX package: RMSNorm,
RoPE, grouped-query attention and the SiLU-gated MLP.  Weights, quantized
forward traces, layouts, the RoPE/gate ops and the soundness accounting are
compared exactly; the 1-layer llama golden attestation
(tests/data/gen_golden_llama.py, written by the JAX package after its own
verifier accepted it) is proved by the port on the CPU byte for byte,
accepted by the port's verifier and linted.  Nothing is proved on JAX
here."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import blocks as JB
from repro.core import chain as JCH
from repro.core import circuit as JC
from repro.core import pcs as JPCS
from repro.core import qops as JQ
from repro_torch import api
from repro_torch.core import blocks as B
from repro_torch.core import chain as CH
from repro_torch.core import circuit as C
from repro_torch.core import pcs as PCS
from repro_torch.core import qops as Q

DATA = os.path.join(os.path.dirname(__file__), "data")
# the config and seeds of tests/data/gen_golden_llama.py
GOLDEN = dict(family="llama", d=8, dff=16, heads=2, kv_heads=1, dh=4, seq=4)
GOLDEN_WEIGHT_SEED, GOLDEN_QUERY_SEED = 4321, 8765
CONFIGS = [
    # grouped-query attention (2 query heads a KV head), padded dff
    dict(family="llama", d=16, dff=48, heads=4, kv_heads=2, dh=4, seq=4),
    # padded d (the e2c slices), one KV head for both query heads
    dict(family="llama", d=12, dff=40, heads=2, kv_heads=1, dh=8, seq=8),
]


def _read(name):
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _query(cfg, seed):
    qrng = np.random.default_rng(seed)
    return np.clip(np.round(qrng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256),
                   -32768, 32767).astype(np.int64)


def _cfgs(fields):
    jcfg = JB.BlockCfg(**fields)
    cfg = B.BlockCfg.from_fields(**dataclasses.asdict(jcfg))
    return jcfg, cfg


@pytest.mark.parametrize("fields", CONFIGS + [GOLDEN])
def test_cfg_weights_and_forward_match(fields):
    jcfg, cfg = _cfgs(fields)
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    assert (cfg.ln_kind, cfg.act, cfg.has_bias) == \
        (jcfg.ln_kind, jcfg.act, jcfg.has_bias) == ("rmsnorm", "silu", False)
    assert B.weight_shapes(cfg) == JB.weight_shapes(jcfg)
    assert sorted(B.WEIGHT_NAMES_LLAMA) == sorted(JB.WEIGHT_NAMES_LLAMA) \
        == sorted(B.weight_shapes(cfg))
    jw = JB.init_weights(jcfg, np.random.default_rng(7))
    w = B.init_weights(cfg, np.random.default_rng(7))
    assert sorted(jw) == sorted(w) and "w3T" in w
    for k in jw:
        assert np.array_equal(jw[k], w[k]), k
    tw = B.weights_from_numpy(cfg, jw, "cpu")
    assert sorted(tw) == sorted(jw)
    assert all(t.dtype == torch.int64 for t in tw.values())
    for k in jw:
        assert np.array_equal(tw[k].numpy(), jw[k]), k
    x = _query(cfg, 11)
    jy, jtr = JB.block_forward(jcfg, jw, x)
    y, tr = B.block_forward(cfg, tw, torch.as_tensor(x))
    assert np.array_equal(jy, y.numpy())
    assert sorted(jtr) == sorted(tr)
    for k in jtr:
        assert np.array_equal(np.asarray(jtr[k]), tr[k].numpy()), k
    for k in ("qr", "kr", "err_rq", "err_rk", "up", "err_up", "gate",
              "err_gate"):
        assert k in tr


def test_weights_from_numpy_checks_names_and_shapes():
    jcfg, cfg = _cfgs(CONFIGS[0])
    jw = JB.init_weights(jcfg, np.random.default_rng(1))
    with pytest.raises(ValueError):
        B.weights_from_numpy(cfg, {k: v for k, v in jw.items() if k != "w3T"},
                             "cpu")
    bad = dict(jw, w3T=jw["w3T"][:-1])
    with pytest.raises(ValueError):
        B.weights_from_numpy(cfg, bad, "cpu")


def _slice_map(slices):
    return {k: dataclasses.astuple(v) for k, v in slices.items()}


@pytest.mark.parametrize("fields", CONFIGS)
def test_layouts_match(fields):
    """declare_weights / declare_aux: the same layouts, slice maps, packed
    witness words and totals, with and without a witness (the verifier's
    layout); the padded-d config has the e2c counterpart slices and no
    mean-part slices."""
    jcfg, cfg = _cfgs(fields)
    jw = JB.init_weights(jcfg, np.random.default_rng(3))
    for w in (jw, None):
        jb, tb = JC.WitnessBuilder("wt"), C.WitnessBuilder("wt")
        assert JB.declare_weights(jcfg, jb, w) == B.declare_weights(cfg, tb, w)
        (js, jp, jt), (ts, tp, tt) = jb.pack(), tb.pack()
        assert jt == tt and _slice_map(js) == _slice_map(ts)
        assert (jp is None and tp is None) or np.array_equal(jp, tp)
    x = _query(cfg, 5)
    _, jtr = JB.block_forward(jcfg, jw, x)
    _, tr = B.block_forward(cfg, B.weights_from_numpy(cfg, jw, "cpu"),
                            torch.as_tensor(x))
    jtr = JB.prepare_trace(jcfg, {k: np.asarray(v) for k, v in jtr.items()})
    ttr = B.prepare_trace(cfg, B.trace_to_numpy(tr))
    assert sorted(jtr) == sorted(ttr)
    for trj, trt in ((jtr, ttr), (None, None)):
        jb, tb = JC.WitnessBuilder("aux"), C.WitnessBuilder("aux")
        jl, tl = JB.declare_aux(jcfg, jb, trj), B.declare_aux(cfg, tb, trt)
        assert jl == tl
        assert {"qr", "kr", "err_rq", "err_rk", "up", "gate"} <= set(tl)
        assert not any(k.endswith((".mu", ".e1", ".xc")) for k in tl)
        assert ("ln1.e2c" in tl) == bool(cfg.d & (cfg.d - 1))
        (js, jp, jt), (ts, tp, tt) = jb.pack(), tb.pack()
        assert jt == tt and _slice_map(js) == _slice_map(ts)
        assert (jp is None and tp is None) or np.array_equal(jp, tp)
    assert B.lut_int_arrays(cfg, ttr).keys() == \
        JB.lut_int_arrays(jcfg, jtr).keys() >= {"silu_idx", "silu_out"}
    for k, v in JB.lut_int_arrays(jcfg, jtr).items():
        assert np.array_equal(np.asarray(v), B.lut_int_arrays(cfg, ttr)[k])


@pytest.mark.parametrize("dh,seq", [(4, 4), (8, 8), (64, 8), (64, 256)])
def test_rope_and_gate_ops_match(dh, seq):
    assert Q.ROPE_F == JQ.ROPE_F
    jc, js = JQ.rope_tables(dh, seq)
    tc, ts = Q.rope_tables(dh, seq)
    assert np.array_equal(jc, tc) and np.array_equal(js, ts)
    rng = np.random.default_rng(dh + seq)
    x = rng.integers(-4000, 4000, size=(dh, seq)).astype(np.int64)
    want = JQ.q_rope(x, jc, js)
    got = Q.q_rope(torch.as_tensor(x), torch.as_tensor(tc), torch.as_tensor(ts))
    for k in ("y", "err"):
        assert np.array_equal(want[k], got[k].numpy()), k
    g = rng.integers(-2000, 2000, size=(16, seq)).astype(np.int64)
    u = rng.integers(-900, 900, size=(16, seq)).astype(np.int64)
    want = JQ.q_silu_gate(g, u)
    got = Q.q_silu_gate(torch.as_tensor(g), torch.as_tensor(u))
    for k in ("y", "err"):
        assert np.array_equal(want[k], got[k].numpy()), k
    a = rng.integers(-(1 << 18), 1 << 18, size=(16, seq)).astype(np.int64)
    want = JQ.q_act("silu", a, 4)
    got = Q.q_act("silu", torch.as_tensor(a), 4)
    for k in ("idx", "out", "err"):
        assert np.array_equal(want[k], got[k].numpy()), k


@pytest.mark.parametrize("fields", CONFIGS + [
    # TinyLlama-1.1B width (src/repro/configs/tinyllama_1_1b.py), seq 8
    dict(family="llama", d=2048, dff=5632, heads=32, kv_heads=4, dh=64,
         seq=8)])
def test_soundness_bound_matches(fields):
    jcfg, cfg = _cfgs(fields)
    gpt2 = dict(family="gpt2", d=16, dff=64, heads=2, kv_heads=2, dh=8,
                seq=8)
    for mix in ([fields] * 2, [fields, gpt2]):
        j = JCH.soundness_bound([JB.BlockCfg(**f) for f in mix],
                                JPCS.PCSParams(blowup=4, queries=16))
        t = CH.soundness_bound([B.BlockCfg(**f) for f in mix],
                               PCS.PCSParams(blowup=4, queries=16))
        assert j.eps_total == t.eps_total and j.components == t.components
        assert j.bits_layer == t.bits_layer
    assert CH.layer_circuit_stats(cfg) == JCH.layer_circuit_stats(jcfg)


# ---------------------------------------------------------------------------
# The llama golden attestation, proved by the port on the CPU.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden():
    from repro_torch.analysis.replay import ReplayLog, recording
    cfg = B.BlockCfg(**GOLDEN)
    weights = [B.init_weights(cfg, np.random.default_rng(GOLDEN_WEIGHT_SEED))]
    query = _query(cfg, GOLDEN_QUERY_SEED)
    policy = api.VerifyPolicy(pcs_queries=1)
    log = ReplayLog()
    with recording(log):
        with api.ProofService([cfg], weights, default_queries=1, workers=1,
                              name="golden-llama", device="cpu") as svc:
            card = svc.model_card.to_bytes()
            att = svc.attest(query, policy,
                             tokens=np.arange(3, dtype=np.int32))
    gold_v1 = _read("golden_llama_v1.bin")
    att.prove_seconds = api.Attestation.from_bytes(
        gold_v1, device="cpu").prove_seconds
    att.__dict__.pop("_wire_cache", None)
    return dict(card=card, query=query, v1=att.to_bytes(1),
                v2=att.to_bytes(2), gold_v1=gold_v1,
                gold_v2=_read("golden_llama_v2.bin"), log=log)


def test_golden_llama_bytes(golden):
    from repro.api import codec as JCODEC
    assert golden["card"] == _read("golden_llama_card.bin")
    assert JCODEC.pack(b"QURY", golden["query"]) == \
        _read("golden_llama_query.bin")
    assert golden["v1"] == golden["gold_v1"]
    assert golden["v2"] == golden["gold_v2"]


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_port_verifier_accepts_llama_golden(golden, version):
    rep = api.verify(golden["gold_" + version], golden["query"],
                     golden["card"], api.VerifyPolicy(pcs_queries=1),
                     device="cpu")
    assert rep.ok, rep.reason
    assert rep.checked_layers == 1
    data = bytearray(golden["gold_" + version])
    data[len(data) // 2] ^= 0x01
    rep = api.verify(bytes(data), golden["query"], golden["card"],
                     api.VerifyPolicy(pcs_queries=1), device="cpu")
    assert not rep.ok and rep.reason


def test_llama_prove_lints_clean(golden):
    """Fiat-Shamir and tape lints over the recorded llama prove: zero
    findings (RoPE's public tables and the gate rescale included)."""
    from repro_torch.analysis import fs_lint, tape_lint
    log = golden["log"]
    assert any(ev.prover for ev in log.events)
    assert fs_lint.replay_checks(log) == []
    assert tape_lint.replay_checks(log) == []
