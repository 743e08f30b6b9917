"""The benchmark on the card: the control at a cell's own size, and one
short run of a cell through the whole harness.  Skipped without a card;
on the chip: ``python3 -m pytest -q -m cuda portbench/tests``."""
from __future__ import annotations

import pytest
import torch

from conftest import CHECKOUT

from portbench import check, control, spec
from portbench import run as R


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_control_at_the_cells_size(card):
    cell = spec.Cell(spec.load_bench(CHECKOUT), "internlm2-1.8b.attest-s8")
    got = control.readings(cell, 31, 2, control.PRECISIONS, card)
    assert all(check.correct(got[p])
               for p in ("float32", "tf32", "tf32-native"))
    assert not check.correct(got["bfloat16"])
    assert got["bfloat16"]["boundary_roots_off"] == 2


@pytest.mark.cuda
def test_a_short_run_is_correct(card):
    cell = spec.Cell(spec.load_bench(CHECKOUT), "gpt2-medium.attest-s8-serial")
    out = R.run_cell(cell, 37, 1.0, False, card)
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["metrics"]["peak_gib"]["value"] > 1
