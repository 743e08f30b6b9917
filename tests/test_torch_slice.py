"""The slice end to end on the CPU: weights, the quantized forward, LUT
digests, and the golden attestation proved by repro_torch — byte for byte
the committed tests/data/golden_v{1,2}.bin — accepted by both verifiers.
Nothing is proved on JAX here: the goldens stand in for it."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import blocks as JB
from repro.core import chain as JCH
from repro.core import pcs as JPCS
from repro_torch import api
from repro_torch.core import blocks as B
from repro_torch.core import chain as CH
from repro_torch.core import pcs as PCS

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = dict(family="gpt2", d=8, dff=16, heads=1, kv_heads=1, dh=8, seq=4)


def _read(name):
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _query(cfg, seed):
    qrng = np.random.default_rng(seed)
    return np.clip(np.round(qrng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256),
                   -32768, 32767).astype(np.int64)


@pytest.mark.parametrize("fields", [
    dict(family="gpt2", d=16, dff=64, heads=2, kv_heads=2, dh=8, seq=8),
    dict(family="gpt2", d=12, dff=40, heads=2, kv_heads=2, dh=4, seq=4),
])
def test_weights_and_forward_match(fields):
    jcfg = JB.BlockCfg(**fields)
    cfg = B.BlockCfg.from_fields(**dataclasses.asdict(jcfg))
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    jw = JB.init_weights(jcfg, np.random.default_rng(7))
    w = B.init_weights(cfg, np.random.default_rng(7))
    assert sorted(jw) == sorted(w)
    for k in jw:
        assert np.array_equal(jw[k], w[k])
    tw = B.weights_from_numpy(cfg, jw, "cpu")
    assert all(t.dtype == torch.int64 for t in tw.values())
    x = _query(cfg, 11)
    jy, jtr = JB.block_forward(jcfg, jw, x)
    y, tr = B.block_forward(cfg, tw, torch.as_tensor(x))
    assert np.array_equal(jy, y.numpy())
    assert sorted(jtr) == sorted(tr)
    for k in jtr:
        assert np.array_equal(np.asarray(jtr[k]), tr[k].numpy()), k
    # the llama family is ported (tests/test_torch_llama.py): its config
    # builds with the JAX package's norm, activation and bias choices
    llama = dict(family="llama", d=16, dff=64, heads=2, kv_heads=1, dh=8,
                 seq=8)
    lc, jlc = B.BlockCfg(**llama), JB.BlockCfg(**llama)
    assert (lc.ln_kind, lc.act, lc.has_bias) == \
        (jlc.ln_kind, jlc.act, jlc.has_bias) == ("rmsnorm", "silu", False)


def test_lut_digests_and_soundness_bound():
    assert api.lut_table_digests() == japi.lut_table_digests()
    jcfg = JB.BlockCfg(**GOLDEN)
    j = JCH.soundness_bound([jcfg] * 3, JPCS.PCSParams(blowup=4, queries=16))
    t = CH.soundness_bound([B.BlockCfg(**GOLDEN)] * 3,
                           PCS.PCSParams(blowup=4, queries=16))
    assert j.eps_total == t.eps_total and j.components == t.components


@pytest.mark.parametrize("budget,selector,audit", [
    (1.0, "random", 0), (0.5, "uniform", 0), (0.5, "uniform", 1),
    (0.25, "random", 2)])
def test_select_layers_matches(budget, selector, audit):
    pol = dict(budget=budget, selector=selector, audit_random=audit, seed=3)
    assert api.select_layers(api.VerifyPolicy(**pol), 8) == \
        japi.select_layers(japi.VerifyPolicy(**pol), 8)


@pytest.fixture(scope="module")
def golden():
    cfg = B.BlockCfg(**GOLDEN)
    weights = [B.init_weights(cfg, np.random.default_rng(1234))]
    query = _query(cfg, 5678)
    policy = api.VerifyPolicy(pcs_queries=1)
    with api.ProofService([cfg], weights, default_queries=1, workers=1,
                          name="golden-model", device="cpu") as svc:
        card = svc.model_card.to_bytes()
        att = svc.attest(query, policy, tokens=np.arange(3, dtype=np.int32))
        wt = svc.engine_for(1).wt_commits[0]
    gold_v1 = _read("golden_v1.bin")
    att.prove_seconds = api.Attestation.from_bytes(gold_v1).prove_seconds
    att.__dict__.pop("_wire_cache", None)
    return dict(card=card, query=query, v1=att.to_bytes(1),
                v2=att.to_bytes(2), gold_v1=gold_v1,
                gold_v2=_read("golden_v2.bin"), cfg=cfg, wt=wt,
                proof=att.proof)


def test_golden_card_and_bytes(golden):
    assert golden["card"] == _read("golden_card.bin")
    assert golden["v1"] == golden["gold_v1"]
    assert golden["v2"] == golden["gold_v2"]


def test_jax_side_accepts_port_bytes(golden):
    """The port's bytes ARE golden_v{1,2}.bin (test above), which
    tests/test_golden_wire.py verifies with ``repro.api.verify`` (a full
    JAX verify costs minutes of tracing on this CPU).  Here the JAX
    package decodes the port's card and attestations, re-encodes them
    byte for byte, checks every v2 column multiproof against its root, and
    re-derives c_0 from the query."""
    from repro.core import layer_proof as JLP
    from repro.core import merkle as JM
    card = japi.ModelCard.from_bytes(golden["card"])
    assert card.model_id == api.ModelCard.from_bytes(golden["card"]).model_id
    for v in (1, 2):
        att = japi.Attestation.from_bytes(golden[f"v{v}"])
        att.__dict__.pop("_wire_cache", None)
        assert att.to_bytes(v) == golden[f"v{v}"]
    att = japi.Attestation.from_bytes(golden["v2"])
    stores = att.layer_stores()
    assert stores and all(stores)
    for layer in stores:
        for root, mp in layer:
            assert JM.verify_multiproof(np.asarray(root), mp)
    c0 = JLP.commit_boundary(card.arch[0], golden["query"],
                             JPCS.PCSParams(blowup=card.pcs_blowup, queries=1))
    assert np.array_equal(np.asarray(c0.root), att.proof.boundary_roots[0])


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_port_verifier_accepts_goldens(golden, version):
    rep = api.verify(golden["gold_" + version], golden["query"],
                     golden["card"], api.VerifyPolicy(pcs_queries=1),
                     device="cpu")
    assert rep.ok, rep.reason
    assert rep.checked_layers == 1


@pytest.mark.parametrize("where", [0, 7, 60, -5])
def test_port_verifier_rejects_flips(golden, where):
    for version in ("gold_v1", "gold_v2"):
        data = bytearray(golden[version])
        data[where] ^= 0x01
        rep = api.verify(bytes(data), golden["query"], golden["card"],
                         device="cpu")
        assert not rep.ok and rep.reason


def test_weight_setup_and_model_chain_verify(golden):
    from repro_torch.core import layer_proof as LP
    params = PCS.PCSParams(blowup=4, queries=1)
    wt, cfg = golden["wt"], golden["cfg"]
    assert LP.verify_weight_setup(cfg, wt.root, wt.range_tape, params,
                                  device="cpu")
    bad = [("val", np.zeros(4, np.uint32)) if item[0] == "val" else item
           for item in wt.range_tape]
    assert not LP.verify_weight_setup(cfg, wt.root, bad, params, device="cpu")
    proof = golden["proof"]
    assert CH.verify_model([cfg], proof, [wt.root], params,
                           in_root=proof.boundary_roots[0], device="cpu")
    assert not CH.verify_model([cfg], proof, [wt.root], params,
                               out_root=proof.boundary_roots[0], device="cpu")


def test_v1_bytes_reencode_to_v2_on_the_named_device():
    """A decoded attestation re-encodes to v2 where its caller says: the
    device given to ``from_bytes`` or ``to_bytes``, else the card."""
    gold_v1, gold_v2 = _read("golden_v1.bin"), _read("golden_v2.bin")
    assert api.Attestation.from_bytes(gold_v1, "cpu").to_bytes(2) == gold_v2
    att = api.Attestation.from_bytes(gold_v1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            att.to_bytes(2)
    assert att.to_bytes(2, device="cpu") == gold_v2


def test_port_verifier_rejects_wrong_query(golden):
    q = golden["query"].copy()
    q[0, 0] += 1
    rep = api.verify(golden["gold_v2"], q, golden["card"], device="cpu")
    assert not rep.ok and "query binding" in rep.reason
