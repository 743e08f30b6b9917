"""K5: one sum-check round with a known challenge — g(0..d) and the fold —
(CUDA, ``csrc/sumcheck_fold.cu``) and its plain version.

Replaces ``repro.kernels.sumcheck_fold.fold_round``.  For one claim of d
Fp4 factors (n, 4) and a challenge c (4,), it returns g (d+1, 4), the round
polynomial's values at X = 0..d summed over the (lo, hi) halves, and the d
folded factors lo + c (hi - lo) of shape (n/2, 4), reading each pair once.
In the protocol g comes before c; this fused form serves a prover that
re-runs the fold pass (``ops.sumcheck_fold``).  ``launches`` counts kernel
launches (two per call: the fold and the reduction of the block partials).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.core import field as F

from . import _build

launches = 0
THREADS = 256
MAX_BLOCKS = 1024
_READY: set = set()


def _check_args(factors: Sequence[torch.Tensor], c: torch.Tensor):
    d = len(factors)
    if not 1 <= d <= 3:
        raise ValueError(f"K5 takes 1..3 factors, got {d}")
    shape = tuple(factors[0].shape)
    if len(shape) != 2 or shape[1] != 4:
        raise ValueError(f"factors must be (n, 4), got {shape}")
    n = shape[0]
    if any(tuple(f.shape) != shape for f in factors):
        raise ValueError("factors must share one shape")
    if n < 2 or n & (n - 1):
        raise ValueError(f"factor length {n} must be a power of two >= 2")
    if tuple(c.shape) != (4,):
        raise ValueError(f"challenge must be (4,), got {tuple(c.shape)}")
    return d, n


def fold_round_plain(factors: Sequence[torch.Tensor], c: torch.Tensor
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    d, n = _check_args(factors, c)
    half = n // 2
    los = [f[:half] for f in factors]
    diffs = [F.f4sub(f[half:], lo) for f, lo in zip(factors, los)]
    cur = list(los)
    evals = []
    for t in range(d + 1):
        if t > 0:
            cur = [F.f4add(x, dd) for x, dd in zip(cur, diffs)]
        prod = cur[0]
        for f in cur[1:]:
            prod = F.f4mul(prod, f)
        evals.append(prod.sum(dim=0) % F.P)
    folded = tuple(F.f4add(lo, F.f4mul(c, dd)) for lo, dd in zip(los, diffs))
    return torch.stack(evals), folded


def _lib() -> ctypes.CDLL:
    lib = _build.load("sumcheck_fold")
    if id(lib) not in _READY:
        vp = ctypes.c_void_p
        lib.sf_fold_round.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_long,
                                      vp, vp, ctypes.c_int, vp, vp, vp, vp, vp]
        lib.sf_fold_round.restype = ctypes.c_int
        _READY.add(id(lib))
    return lib


def _count() -> None:
    _build.bump(globals(), "launches", 2)


def fold_round(factors: Sequence[torch.Tensor], c: torch.Tensor
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """factors: d arrays (n, 4), n a power of two >= 2; c: (4,).  Returns
    (g (d+1, 4), folded factors, d arrays (n/2, 4))."""
    d, n = _check_args(factors, c)
    if c.device.type == "cpu" and all(f.device.type == "cpu" for f in factors):
        return fold_round_plain(factors, c)
    _build.require_cuda_int64(c, *factors)
    dev = c.device
    half = n // 2
    nblocks = max(1, min(-(-half // THREADS), MAX_BLOCKS))
    partial = torch.empty((nblocks, d + 1, 4), dtype=F.I64, device=dev)
    g = torch.empty((d + 1, 4), dtype=F.I64, device=dev)
    folded = torch.empty((d, half, 4), dtype=F.I64, device=dev)
    fp = [_build.ptr(f) for f in factors] + [None] * (3 - d)
    op = [_build.ptr(folded[t]) for t in range(d)] + [None] * (3 - d)
    _count()
    _build.check(_lib().sf_fold_round(
        fp[0], fp[1], fp[2], d, half, _build.ptr(c), _build.ptr(partial),
        nblocks, _build.ptr(g), op[0], op[1], op[2], _build.stream_ptr(c)),
        "sf_fold_round")
    return g, tuple(folded.unbind(0))
