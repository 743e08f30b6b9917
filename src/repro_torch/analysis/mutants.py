"""Seeded-bug mutation corpus: proof that each analysis catches its class
(mirrors ``repro.analysis.mutants``).

A static analysis that has never seen its bug is a comment, not a gate.
Each ``Mutant`` here monkeypatches one soundness bug into the live code
(restored afterwards), reruns the relevant analysis, and requires a
finding of the expected category (``python -m repro_torch.analysis
--mutants``), so a refactor that silently blinds an analyzer fails the
same way a real bug would.

Replay mutants run the golden prove under the patch; the prove is
*allowed* to crash (a mutated prover often fails its own checks) —
detection is judged on the lint findings over the recorded events, never
on the crash.  Range mutants re-trace the patched field primitives; the
port's counterpart of the JAX package's ``wide-limbs`` (a 17-bit limb
split of the uint32 multiply, which the port does not have) is
``wide-product``, a Montgomery product that scales a*b by R^-1 before its
first reduction and so leaves int64.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, FrozenSet, List, Optional

import numpy as np

from repro_torch.core import field as F

from . import Finding


@dataclasses.dataclass
class Mutant:
    name: str
    analysis: str                  # pass that must flag it
    expect: FrozenSet[str]         # acceptable finding categories
    patch: Callable                # contextmanager installing the bug
    description: str


@dataclasses.dataclass
class MutantResult:
    name: str
    analysis: str
    detected: bool
    findings: List[Finding]
    prove_error: Optional[str]


@contextlib.contextmanager
def _patched(owner, attr: str, bad):
    orig = getattr(owner, attr)
    setattr(owner, attr, bad)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


# ---------------------------------------------------------------------------
# fs mutants — run the golden prove with a broken prover
# ---------------------------------------------------------------------------
def _patch_drop_absorb():
    """Prover sends a tape value to the verifier without absorbing it:
    the next challenge no longer depends on it (classic Frozen Heart)."""
    from repro_torch.core import circuit as C

    def bad(self, val):
        val_np = F.to_np(val)
        self.tape.append(("val", val_np))
        C._notify("on_tape", ctx=self, kind="val", payload=val_np)
        return val                                   # tr.absorb dropped

    return _patched(C.ProverCtx, "put_value", bad)


def _patch_stuck_squeeze():
    """Squeeze stops advancing the sponge: every subsequent challenge on
    the transcript repeats.  Prover and verifier stay consistent (both
    use the broken sponge), so only the lint can see it."""
    from repro_torch.core import poseidon2 as P2
    from repro_torch.core import transcript as T
    from repro_torch.kernels import poseidon2_kernel as K1

    def bad(self, k):
        old = self._state
        _new_state, lanes = K1.squeeze(old.reshape(1, P2.WIDTH),
                                       -(-k // P2.RATE))
        out = lanes[0, :k]                           # state NOT advanced
        if T._RECORDER is not None:
            T._RECORDER.on_squeeze(self, F.to_np(old), F.to_np(old),
                                   F.to_np(out))
        return out

    return _patched(T.Transcript, "_squeeze", bad)


# ---------------------------------------------------------------------------
# tape mutants
# ---------------------------------------------------------------------------
def _patch_unconstrained_commit():
    """An extra commitment is absorbed into the transcript but nothing is
    ever claimed about it — free witness slots."""
    from repro_torch.core import circuit as C
    orig = C.ProverCtx.finalize

    def bad(self):
        self.commit("mutant_unconstrained", np.arange(8, dtype=np.int64))
        return orig(self)

    return _patched(C.ProverCtx, "finalize", bad)


def _patch_dropped_opening():
    """finalize silently drops the last commitment's claims: those
    evaluation claims never reach a PCS opening bundle."""
    from repro_torch.core import circuit as C
    orig = C.ProverCtx.finalize

    def bad(self):
        if self.claims:
            self.claims.popitem(last=True)
        return orig(self)

    return _patched(C.ProverCtx, "finalize", bad)


# ---------------------------------------------------------------------------
# ranges mutants — re-analyze patched field primitives
# ---------------------------------------------------------------------------
def _patch_wide_product():
    """fmul scales a*b by R^-1 before the first % P: (P-1)^2 R^-1 is far
    past 2^63, so the product wraps int64."""
    def bad(a, b):
        return a * b * F.R_INV % F.P

    return _patched(F, "fmul", bad)


def _patch_unreduced_add():
    """fadd without the reduction: outputs in [0, 2P-2], and any add chain
    (NTT butterflies, sum-check folds) leaves the field."""
    def bad(a, b):
        return a + b

    return _patched(F, "fadd", bad)


MUTANTS: List[Mutant] = [
    Mutant("drop-absorb", "fs", frozenset({"dropped-absorb"}),
           _patch_drop_absorb,
           "put_value sends a value without absorbing it"),
    Mutant("stuck-squeeze", "fs",
           frozenset({"stuck-squeeze", "challenge-reuse"}),
           _patch_stuck_squeeze,
           "squeeze no longer advances the sponge state"),
    Mutant("wide-product", "ranges", frozenset({"i64-overflow"}),
           _patch_wide_product,
           "fmul multiplies by R^-1 before reducing and overflows int64"),
    Mutant("unreduced-add", "ranges",
           frozenset({"fp-range", "i64-overflow"}),
           _patch_unreduced_add,
           "fadd skips the reduction"),
    Mutant("unconstrained-commit", "tape",
           frozenset({"unconstrained-commitment"}),
           _patch_unconstrained_commit,
           "extra commitment with no claims"),
    Mutant("dropped-opening", "tape", frozenset({"orphaned-claim"}),
           _patch_dropped_opening,
           "finalize drops the last commitment's openings"),
]


def run_mutant(m: Mutant, device=None) -> MutantResult:
    """Install the mutant, run its analysis on ``device`` (default: the
    card) and judge detection."""
    from . import fs_lint, tape_lint
    prove_error = None
    with m.patch():
        if m.analysis == "ranges":
            from . import ranges
            try:
                findings = ranges.run(device)
            except Exception as e:        # analyzer must not crash on bugs
                return MutantResult(m.name, m.analysis, False, [],
                                    f"analyzer crashed: {e!r}")
        else:
            from .replay import ReplayLog, run_golden_prove
            log = ReplayLog()
            try:
                run_golden_prove(log, device)
            except Exception as e:        # mutated provers may self-destruct
                prove_error = repr(e)
            checker = fs_lint if m.analysis == "fs" else tape_lint
            findings = checker.replay_checks(log)
    detected = any(f.analysis == m.analysis and f.category in m.expect
                   for f in findings)
    return MutantResult(m.name, m.analysis, detected, findings, prove_error)


def run_corpus(only: Optional[str] = None, device=None) -> List[MutantResult]:
    return [run_mutant(m, device) for m in MUTANTS
            if only is None or m.name == only]
