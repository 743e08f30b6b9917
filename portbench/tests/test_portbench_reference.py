"""The reference against the program and the JAX package's goldens on the
CPU, and the work counts of portbench/cost.py against the program's
layouts and the smoke's bounds."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import CHECKOUT, PORTBENCH

from portbench import check, cost, inputs
from portbench import run as R
from portbench.reference import commit as RC
from portbench.reference import forward as RF
from repro_torch import api
from repro_torch.api import codec
from repro_torch.core import blocks as B
from repro_torch.core import circuit as C
from repro_torch.core import layer_proof as LP
from repro_torch.core import pcs as PCS

CPU = torch.device("cpu")
DATA = CHECKOUT / "tests" / "data"
# tests/data/gen_golden.py and gen_golden_llama.py
GOLDENS = {
    "golden": (dict(family="gpt2", d=8, dff=16, heads=1, kv_heads=1, dh=8,
                    seq=4), 1234),
    "golden_llama": (dict(family="llama", d=8, dff=16, heads=2, kv_heads=1,
                          dh=4, seq=4), 4321),
}


def _block(fields):
    cfg = dict(fields)
    seq = cfg.pop("seq")
    return inputs.block(dict(block=cfg), seq), B.BlockCfg(**fields)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_reference_agrees_with_the_jax_goldens(name):
    """The reference's forward and commitments reproduce every root of the
    JAX-made golden card and attestation, and every column it opened."""
    fields, seed = GOLDENS[name]
    block, cfg = _block(fields)
    weights = [B.init_weights(cfg, np.random.default_rng(seed))]
    query = codec.unpack(b"QURY", (DATA / f"{name}_query.bin").read_bytes())
    card = api.ModelCard.from_bytes((DATA / f"{name}_card.bin").read_bytes())
    served = R._served((DATA / f"{name}_v2.bin").read_bytes(),
                       np.asarray(query), True, CPU)
    counts = check.compare(block, weights, card.wt_roots, [served],
                           card.pcs_blowup, CPU)
    assert counts["columns_checked"] > 0
    assert check.correct(counts), counts


def _program_roots(cfg, weights, acts, blowup=4):
    params = PCS.PCSParams(blowup=blowup, queries=2)
    wt = LP.commit_weights(cfg, weights, params, device=CPU)
    return wt.root, [LP.commit_boundary(cfg, h, params, device=CPU).root
                     for h in acts]


@pytest.mark.parametrize("config,seq", [("gpt2-small", 8), ("gpt2-medium", 8),
                                        ("internlm2-1.8b", 8),
                                        ("gpt2-small", 128)])
def test_forward_and_boundary_roots_at_published_widths(config, seq):
    """At a configuration's widths: every activation of the reference's
    replay equals the program's block_forward, and every boundary root the
    program's commitment of it."""
    block = inputs.block(json.loads(
        (PORTBENCH / "configs" / f"{config}.json").read_text()), seq)
    cfg = B.BlockCfg(**{k: block[k] for k in ("family", "d", "dff", "heads",
                                               "kv_heads", "dh", "seq")})
    weights = inputs.weights(block, 1, 11, CPU)
    x = inputs.query(block, 11, 1)
    ref = RF.chain_forward(block, weights, x, CPU)
    h, _ = B.block_forward(cfg, B.weights_from_numpy(cfg, weights[0], CPU),
                           torch.as_tensor(x))
    assert np.array_equal(h.numpy(), ref[1])
    params = PCS.PCSParams(blowup=4, queries=2)
    for a in ref:
        mine = RC.commit_boundary(a, 4, CPU)[0]
        assert np.array_equal(mine, LP.commit_boundary(cfg, a, params,
                                                       device=CPU).root)


@pytest.mark.parametrize("config", ["gpt2-small", "internlm2-1.8b"])
def test_weight_packing_at_published_widths(config):
    """The packed words a layer's weight commitment encodes (too many to
    commit here on the CPU) equal the program's layout word for word."""
    block = inputs.block(json.loads(
        (PORTBENCH / "configs" / f"{config}.json").read_text()), 8)
    cfg = B.BlockCfg(**{k: block[k] for k in ("family", "d", "dff", "heads",
                                               "kv_heads", "dh", "seq")})
    w = inputs.weights(block, 1, 5, CPU)[0]
    wb = C.WitnessBuilder("wt")
    B.declare_weights(cfg, wb, w)
    _, packed, total = wb.pack()
    mine = RC.pack_limbs(RC.weight_arrays(block, w))
    assert len(mine) == total == cost.weight_words(block)
    assert np.array_equal(mine, packed)


@pytest.mark.parametrize("config", ["gpt2-small", "gpt2-medium",
                                    "internlm2-1.8b"])
@pytest.mark.parametrize("seq", [8, 128])
def test_cost_word_counts_follow_the_layouts(config, seq):
    block = inputs.block(json.loads(
        (PORTBENCH / "configs" / f"{config}.json").read_text()), seq)
    cfg = B.BlockCfg(**{k: block[k] for k in ("family", "d", "dff", "heads",
                                               "kv_heads", "dh", "seq")})
    for declare, want in ((B.declare_weights, cost.weight_words(block)),
                          (B.declare_boundary, cost.boundary_words(block)),
                          (B.declare_aux, cost.aux_words(block))):
        wb = C.WitnessBuilder("x")
        declare(cfg, wb, None)
        assert wb.pack()[2] == want, declare.__name__


def test_cost_holds_to_the_smoke_bounds():
    """PERF.md's kernel table: K1 hash_rows 4096 x 512, K3 d=2 n=2^19, K4
    4 x 512 @ 512 x 1024 (chip_smoke.py's bound_ms, k3_bound, k4_bound)."""
    import chip_smoke as S
    cases = [(cost.k1_hash_rows(4096, 512), 0.0121,
              S.bound_ms((4096 * 512 + 4096 * 8) * S.WORD_BYTES,
                         4096 * 64 * S.PERM_MULS)),
             (cost.k3_prove(2, 1 << 19), 0.00501, S.k3_bound(2, 1 << 19)),
             (cost.k4_modmatmul(4, 512, 1024), 0.000633,
              S.k4_bound(4, 512, 1024))]
    for work, table_ms, (smoke_ms, _) in cases:
        assert cost.bound_s(work) * 1e3 == pytest.approx(smoke_ms, rel=1e-12)
        assert cost.bound_s(work) * 1e3 == pytest.approx(table_ms, rel=5e-3)
    assert cost.PERM_MULS == S.PERM_MULS
    assert cost.INT32_OPS_PER_S == S.INT32_OPS_PER_S
    assert cost.k2_encode(1024, 4096, 1024) == (
        1024 * 2048 * 10, (1024 * 1024 + 4096 + 1024 * 4096) * 4)
