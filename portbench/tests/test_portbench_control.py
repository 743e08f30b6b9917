"""The comparison that decides ``correct`` fails what it should: the
control (the reference's own forward in bfloat16, in the program's place)
at a configuration's published widths, and a whole run of the harness
with the program broken underneath in each way a cell can be."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import CHECKOUT

from portbench import check, control, spec
from portbench import run as R
from repro_torch import api

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["gpt2-medium.attest-s8-serial",
                                  "internlm2-1.8b.attest-s8"])
def test_bfloat16_control_fails_and_float32_does_not(cell):
    """float32 and TF32-rounded products are exact at these magnitudes;
    bfloat16 moves every boundary after the input, and the harness's own
    comparison reads it not correct."""
    c = spec.Cell(spec.load_bench(CHECKOUT), cell)
    got = control.readings(c, 9, 1, ("float32", "tf32", "bfloat16"), CPU)
    assert check.correct(got["float32"]) and check.correct(got["tf32"])
    assert got["float32"]["boundary_roots_off"] == 0
    assert not check.correct(got["bfloat16"])
    assert got["bfloat16"]["boundary_roots_off"] == c.config["block"]["layers"]


def _first_attestation_only(orig):
    def attest(self, query, policy=None, tokens=None):
        first = self.__dict__.get("_first")
        if first is None:
            first = self.__dict__["_first"] = orig(self, query, policy, tokens)
        return first
    return attest


def _half_the_query(orig):
    def attest(self, query, policy=None, tokens=None):
        q = np.array(query)
        q[:, q.shape[1] // 2:] = 0
        return orig(self, q, policy, tokens)
    return attest


def _last_boundary_altered(orig):
    def attest(self, query, policy=None, tokens=None):
        att = orig(self, query, policy, tokens)
        last = np.array(att.proof.boundary_roots[-1])
        last[0] ^= 1
        att.proof.boundary_roots[-1] = last
        return att
    return attest


FAULTS = {
    "state returned unchanged": ("attest", _first_attestation_only),
    "half of the query left out": ("attest", _half_the_query),
    "an answer altered where produced": ("attest", _last_boundary_altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_program_is_not_correct(toy, monkeypatch, fault):
    name, wrap = FAULTS[fault]
    monkeypatch.setattr(api.ProofService, name,
                        wrap(getattr(api.ProofService, name)))
    root, bench = toy
    out = R.run_cell(spec.Cell(bench, "toy-gpt2.toy", root), 23, 0.0, False,
                     CPU)
    assert out["correct"] is False
    assert out["checks"]["boundary_roots_off"]["value"] > 0


def test_weights_the_verifier_cannot_catch(toy, monkeypatch):
    """The program commits and proves one weight word other than the one
    it was handed: its own verifier accepts, the reference does not."""
    orig = api.ProofService.__init__

    def init(self, block_cfgs, weights, *a, **kw):
        w = [dict(x) for x in weights]
        w[0]["wqT"] = w[0]["wqT"].copy()
        w[0]["wqT"][0, 0] += 1
        orig(self, block_cfgs, w, *a, **kw)

    monkeypatch.setattr(api.ProofService, "__init__", init)
    root, bench = toy
    out = R.run_cell(spec.Cell(bench, "toy-gpt2.toy", root), 29, 0.0, False,
                     CPU)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"] is False and out["failed"] == 0
    assert checks["rejected"] == 0 and checks["weight_roots_off"] == 1
