"""Soundness static analysis for the port (``python -m repro_torch.analysis``).

Counterpart of ``repro.analysis``.  The paper's formal guarantee (Thm 3.1,
eps < 1e-37 at production sizes) rests on implementation invariants that
no functional test can establish by example:

* **No integer overflow** — the int64 Montgomery arithmetic of
  ``core/field.py`` and the plain versions of the kernels must never let
  an intermediate leave int64, and every declared field output must stay
  in [0, P).  ``ranges.py`` proves this by interval propagation over the
  aten graphs of the plain versions, and holds each CUDA kernel against
  its proved plain version on edge-word inputs on the card.
* **Fiat-Shamir discipline** — every prover-sent value must be absorbed
  before the challenge it gates, challenges must never repeat, and
  transcripts must be domain-separated.  ``fs_lint.py`` checks this with
  an AST pass plus a recording replay of a golden prove.
* **Constraint coverage** — every committed witness slot must be
  constrained by some claim, every claim must reach a PCS opening.
  ``tape_lint.py`` walks the circuit events of a golden prove.

``locks.py`` additionally asserts the documented lock acquisition order
of the port's locks.  ``mutants.py`` holds the seeded-bug corpus that
proves each analysis actually catches its bug class.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Finding:
    """One analysis finding. ``analysis`` names the pass, ``where`` the
    entry point / file / event that anchors it."""
    analysis: str     # "ranges" | "fs" | "tape" | "locks"
    category: str     # short bug-class slug, e.g. "i64-overflow"
    where: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.analysis}:{self.category}] {self.where}: {self.detail}"


class AnalysisError(Exception):
    """The analyzer itself could not complete (coverage gap, bad declaration).

    Distinct from findings: a finding means the *code under analysis* is
    suspect, an AnalysisError means the *analysis* is — both fail."""


def run_ranges(device=None) -> List[Finding]:
    from . import ranges
    return ranges.run(device)


def run_fs(device=None) -> List[Finding]:
    from . import fs_lint
    return fs_lint.run(device=device)


def run_tape(device=None) -> List[Finding]:
    from . import tape_lint
    return tape_lint.run(device=device)


def run_locks(device=None) -> List[Finding]:
    from . import locks
    return locks.run()


ALL_ANALYSES = {
    "ranges": run_ranges,
    "fs": run_fs,
    "tape": run_tape,
    "locks": run_locks,
}
