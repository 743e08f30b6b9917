"""K5: one sum-check round with a known challenge — g(0..d) and the fold —
(CUDA, ``csrc/sumcheck_fold.cu``) and its plain version.

Replaces ``repro.kernels.sumcheck_fold.fold_round``.  For one claim of d
Fp4 factors (n, 4) and a challenge c (4,), it returns g (d+1, 4), the round
polynomial's values at X = 0..d summed over the (lo, hi) halves, and the d
folded factors lo + c (hi - lo) of shape (n/2, 4), reading each pair once.
In the protocol g comes before c; this fused form serves a prover that
re-runs the fold pass (``ops.sumcheck_fold``).  One launch per call
(``launches`` counts them): the blocks' partial sums of g are summed inside
it, after a grid-wide sync.  ``plan(d, n)`` is its launch plan.

The pairs come in by 16-byte loads into registers; operands must be
16-byte aligned, and a misaligned one raises.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import field as F

from . import _build

launches = 0
THREADS = 256                 # pairs of a full tile: one a thread
SMS = 132                     # SMs of an H100 SXM (the plan's default)
BLOCKS_PER_SM = 2             # csrc kBlocks
_LIBS: dict = {}              # by device index, once set up
_SMS: dict = {}
# sf_fold_round's packed operands (csrc/sumcheck_fold.cu): f0, f1, f2, c,
# out, half, d, grid
_ARGS = struct.Struct("<8q")


class Plan(NamedTuple):
    """One call's launch: ``grid`` persistent blocks of ``THREADS`` threads
    walk ``tiles`` tiles of ``tile`` pairs (block b takes tiles b, b + grid,
    ...; thread j pair j of each).  ``scratch_words``: the blocks' partial
    rows of g (none for one block, else the launch is cooperative: a
    grid-wide sync before block 0 sums them)."""
    grid: int
    tile: int
    tiles: int
    scratch_words: int


@functools.lru_cache(maxsize=None)
def plan(d: int, n: int, sms: int = SMS) -> Plan:
    half = n // 2
    tiles = -(-half // THREADS)
    grid = min(tiles, sms * BLOCKS_PER_SM)
    return Plan(grid=grid, tile=min(half, THREADS), tiles=tiles,
                scratch_words=grid * (d + 1) * 4 if grid > 1 else 0)


def _check_args(factors: Sequence[torch.Tensor], c: torch.Tensor):
    d = len(factors)
    if not 1 <= d <= 3:
        raise ValueError(f"K5 takes 1..3 factors, got {d}")
    shape = factors[0].shape
    if len(shape) != 2 or shape[1] != 4:
        raise ValueError(f"factors must be (n, 4), got {tuple(shape)}")
    n = shape[0]
    if any(f.shape != shape for f in factors):
        raise ValueError("factors must share one shape")
    if n < 2 or n & (n - 1):
        raise ValueError(f"factor length {n} must be a power of two >= 2")
    if c.shape != (4,):
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


def _lib(index: int) -> ctypes.CDLL:
    """The library, set up once per device (by its index)."""
    lib = _LIBS.get(index)
    if lib is None:
        lib = _build.load("sumcheck_fold")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sf_fold_round.argtypes = [ctypes.c_char_p, vp]
        lib.sf_fold_round.restype = ci
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
        _LIBS[index] = lib
    return lib


def _count() -> None:
    _build.bump(globals(), "launches")


def _require_operands(c: torch.Tensor, factors) -> int:
    """Contiguous int64 operands on one CUDA device, each 16-byte aligned
    (the 16-byte loads and stores need it); returns the device's index."""
    index = c.get_device()
    for t in (c, *factors):
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"kernel operands must share one CUDA device, got {t.device}")
        if t.dtype is not torch.int64:
            raise TypeError(f"kernel operands must be int64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("K5 operands must be 16-byte aligned "
                             f"(a tensor starts at {t.data_ptr():#x})")
    return index


def fold_round(factors: Sequence[torch.Tensor], c: torch.Tensor
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """factors: d arrays (n, 4), n a power of two >= 2; c: (4,).  Returns
    (g (d+1, 4), folded factors, d arrays (n/2, 4))."""
    d, n = _check_args(factors, c)
    if c.device.type == "cpu" and all(f.device.type == "cpu" for f in factors):
        return fold_round_plain(factors, c)
    index = _require_operands(c, factors)
    lib = _lib(index)
    half = n // 2
    p = plan(d, n, _SMS[index])
    # one allocation: the folded factors, g, the partial rows
    rows = d * half + d + 1 + p.scratch_words // 4
    buf = torch.empty((rows, 4), dtype=F.I64, device=c.device)
    parts = buf.split_with_sizes([half] * d + [rows - d * half])
    fp = [f.data_ptr() for f in factors] + [0] * (3 - d)
    _count()
    _build.check(lib.sf_fold_round(_ARGS.pack(
        *fp, c.data_ptr(), buf.data_ptr(), half, d, p.grid),
        _build.stream_ptr(c)), "sf_fold_round")
    return parts[d][:d + 1], parts[:d]
