"""The d=128 golden of the served chain's first layer
(tests/data/gen_golden_d128.py: the JAX package's attestation of
``serve_query(0)`` at the paper's headline width) against the port on the
CPU: the ModelCard of a CPU setup byte for byte, the golden decoded and
re-encoded to the same bytes, the port's verifier accepting it and
rejecting it with one byte flipped.  The prove is compared on the card
(chip_smoke's serve phase)."""
import os

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import blocks as B

DATA = os.path.join(os.path.dirname(__file__), "data")
# the arguments of tests/data/gen_golden_d128.py
CFG = dict(family="gpt2", d=128, dff=512, heads=4, kv_heads=4, dh=32, seq=8)
PCS_BLOWUP, PCS_QUERIES, SEED = 4, 16, 0


def _read(name):
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _query(cfg):
    qrng = np.random.default_rng(SEED + 1)
    return np.clip(np.round(qrng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256),
                   -32768, 32767).astype(np.int64)


@pytest.fixture(scope="module")
def card():
    """The port's ModelCard from a CPU setup of the one-layer service."""
    cfg = B.BlockCfg(**CFG)
    weights = [B.init_weights(cfg, np.random.default_rng(SEED))]
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        with api.ProofService([cfg], weights, pcs_blowup=PCS_BLOWUP,
                              default_queries=PCS_QUERIES, workers=1,
                              name="chip-smoke", device="cpu") as svc:
            return svc.model_card.to_bytes()
    finally:
        torch.set_num_threads(n)


def test_model_card_equals_the_golden(card):
    assert card == _read("golden_d128_card.bin")


def test_golden_decodes_and_reencodes():
    gold = _read("golden_d128_v2.bin")
    att = api.Attestation.from_bytes(gold, device="cpu")
    assert att.prove_seconds == 0.0
    assert att.to_bytes(2, device="cpu") == gold


def test_port_verifies_the_golden(card):
    gold = _read("golden_d128_v2.bin")
    query = _query(B.BlockCfg(**CFG))
    policy = api.VerifyPolicy(pcs_queries=PCS_QUERIES)
    rep = api.verify(gold, query, card, policy, device="cpu")
    assert rep.ok, rep.reason
    flipped = bytearray(gold)
    flipped[len(flipped) // 2] ^= 0x01
    assert not api.verify(bytes(flipped), query, card, policy,
                          device="cpu").ok
