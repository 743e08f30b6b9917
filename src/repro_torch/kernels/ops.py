"""The public kernel surface (mirrors ``repro.kernels.ops``).

Each entry point takes int64 Montgomery tensors and runs where they lie:
on a CUDA tensor it launches its hand-written kernel (K1..K5), on a CPU
tensor it runs the kernel's plain PyTorch version.  The port has one
implementation per device, so there is no kernel-path switch, no
``interpret`` flag and no ``*_pallas`` twin.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.mle import eq_points

from . import modmatmul as _mm
from . import ntt_kernel as _ntt
from . import poseidon2_kernel as _p2
from . import sumcheck_fold as _fold
from . import sumcheck_round as _round


def modmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _mm.modmatmul(a, b)


def poseidon2_permute(states: torch.Tensor) -> torch.Tensor:
    return _p2.permute_batch(states)


def poseidon2_compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    return _p2.compress_pairs(left, right)


def poseidon2_hash(elems: torch.Tensor) -> torch.Tensor:
    return _p2.hash_rows(elems)


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    return _ntt.ntt_rows(x, inverse)


def sumcheck_fold(factors: Sequence[torch.Tensor], c: torch.Tensor):
    return _fold.fold_round(factors, c)


def sumcheck_prove_rounds(factors: Sequence[torch.Tensor],
                          states: torch.Tensor):
    """Fused multi-claim sum-check prover (see sumcheck_round.prove_rounds).
    Single-claim callers may pass (n, 4) factors with a (16,) state and
    read row 0 of each output."""
    if states.ndim == 1:
        factors = [f.unsqueeze(0) for f in factors]
        states = states.unsqueeze(0)
    return _round.prove_rounds(factors, states)


def partial_eval_rows_mm(mat: torch.Tensor, r_rows: torch.Tensor
                         ) -> torch.Tensor:
    """(R, C) Fp matrix, bind row bits at r_rows ((log R, 4)) -> (C, 4)."""
    return _mm.partial_eval_rows_mm(mat, r_rows)


def partial_eval_cols_mm(mat: torch.Tensor, r_cols: torch.Tensor
                         ) -> torch.Tensor:
    """(R, C) Fp matrix, bind col bits at r_cols ((log C, 4)) -> (R, 4):
    mat @ eq as an N = 4 modular matmul."""
    eq = eq_points(r_cols)
    if mat.device.type == "cuda":
        mat, eq = mat.contiguous(), eq.contiguous()
    return _mm.modmatmul(mat, eq)


# ---------------------------------------------------------------------------
# Static-analysis entry registry, consumed by ``repro_torch.analysis.ranges``.
#
# Every public entry point above appears here with its declared input
# bounds, with the names, kinds and shapes of the JAX package's registry
# (less its ``*_pallas`` twins).  The analyzer traces each fn on CPU
# tensors, where it runs the plain version, and on the card runs it again
# through the kernel on edge-word inputs.  Kind "fp" = Montgomery element
# in [0, P).
# ---------------------------------------------------------------------------
def _ae(fn, *args, out="fp"):
    return dict(fn=fn, args=args, out=out)


ANALYSIS_ENTRIES = {
    "modmatmul": _ae(lambda a, b: modmatmul(a, b),
                     ("fp", (8, 8)), ("fp", (8, 8))),
    "poseidon2_permute": _ae(lambda s: poseidon2_permute(s),
                             ("fp", (8, 16))),
    "poseidon2_compress": _ae(lambda l, r: poseidon2_compress(l, r),
                              ("fp", (8, 8)), ("fp", (8, 8))),
    "poseidon2_hash": _ae(lambda x: poseidon2_hash(x), ("fp", (8, 24))),
    "ntt": _ae(lambda x: ntt(x), ("fp", (8, 16))),
    "ntt_inverse": _ae(lambda x: ntt(x, inverse=True), ("fp", (8, 16))),
    "sumcheck_fold": _ae(
        lambda f0, f1, c: sumcheck_fold((f0, f1), c),
        ("fp", (16, 4)), ("fp", (16, 4)), ("fp", (4,))),
    "sumcheck_prove_rounds": _ae(
        lambda f0, f1, st: sumcheck_prove_rounds((f0, f1), st),
        ("fp", (8, 4)), ("fp", (8, 4)), ("fp", (16,))),
    "partial_eval_rows_mm": _ae(lambda m, r: partial_eval_rows_mm(m, r),
                                ("fp", (8, 8)), ("fp", (3, 4))),
    "partial_eval_cols_mm": _ae(lambda m, r: partial_eval_cols_mm(m, r),
                                ("fp", (8, 8)), ("fp", (3, 4))),
}

# K2's rows longer than 2^15 words (two launches, ``ntt_kernel.plan``):
# part (c) of the ranges pass runs these through the kernel against the
# plain version, with the edge words, as it runs every entry above; the
# plain version is shape-generic and (b) proves it at the short shape.
# Both transforms at 2^16 words, the RS encode at blowup 4 into 2^17.
LONG_ROW_ENTRIES = {
    "ntt_long": _ae(lambda x: ntt(x), ("fp", (2, 1 << 16))),
    "ntt_long_inverse": _ae(lambda x: ntt(x, inverse=True),
                            ("fp", (2, 1 << 16))),
    "rs_encode_long": _ae(lambda x: _ntt.rs_encode_rows(x, 4),
                          ("fp", (2, 1 << 15))),
}
