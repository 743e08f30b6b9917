"""K4: modular matmul C = A @ B mod P (CUDA, ``csrc/modmatmul.cu``) and its
plain version, plus the partial evaluation it serves.

Replaces ``repro.kernels.modmatmul.modmatmul`` and
``repro.kernels.ops.partial_eval_rows_mm``.  No library call computes a
modular product (and CUDA has no int64 matmul), so the plain version forms
the products and reduces the sum once.

``plan(M, K, N)`` says how a call is launched: one kernel, blocks of 4
output columns (one 32-byte sector of a B row) and at most 8 rows of A,
each block over all of K.  Every thread issues the loads of several row
pairs at once, so a block of a few hundred rows costs about one trip to
memory.  At the main path's widths (N = 512 and 1024) that is 128 and 256
blocks for the 132 SMs.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import field as F
from repro_torch.core.mle import eq_points

from . import _build

launches = 0
# calls that reached the card, by (M, K, N)
launch_shapes: collections.Counter = collections.Counter()
COLS = 4                   # output columns per block (one 32-byte sector of a B row)
SLOTS_PER_WARP = 16        # row pairs a warp loads per step
MAX_WARPS = 8
_READY: set = set()


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one (M, K) @ (K, N) call is launched."""
    mt: int                # rows of A per block (1, 2, 4 or 8)
    threads: int           # per block: a warp for every 16 row pairs, at most 8
    blocks: int


@functools.lru_cache(maxsize=256)
def plan(M: int, K: int, N: int) -> Plan:
    mt = 1
    while mt < min(M, 8):
        mt *= 2
    pairs = max(1, -(-K // 2))
    warps = min(MAX_WARPS, -(-pairs // SLOTS_PER_WARP))
    return Plan(mt=mt, threads=32 * warps,
                blocks=-(-N // COLS) * -(-M // mt))


def modmatmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # products < P^2 < 2^62 reduce first, so the K-term sum stays < K P
    prod = a[:, :, None] * b[None, :, :] % F.P                   # (M, K, N)
    return prod.sum(dim=1) % F.P * F.R_INV % F.P


def _lib() -> ctypes.CDLL:
    lib = _build.load("modmatmul")
    if id(lib) not in _READY:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.modmatmul.argtypes = [vp, vp, vp, ci, cl, cl, ci, ci, vp]
        lib.modmatmul.restype = ci
        _READY.add(id(lib))
    return lib


def modmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K), b: (K, N) Montgomery -> (M, N) Montgomery."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"modmatmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return modmatmul_plain(a, b)
    _build.require_cuda_int64(a, b)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=F.I64, device=a.device)
    if M == 0 or N == 0:
        return out
    pl = plan(M, K, N)
    status = _lib().modmatmul(
        _build.ptr(a), _build.ptr(b), _build.ptr(out), M, K, N, pl.mt,
        pl.threads, _build.stream_ptr(a))
    _build.check(status, "modmatmul")
    _count(M, K, N)
    return out


def _count(M: int, K: int, N: int) -> None:
    _build.bump(globals(), "launches")
    _build.bump(launch_shapes, (M, K, N))


def partial_eval_rows_mm(mat: torch.Tensor, r_rows: torch.Tensor
                         ) -> torch.Tensor:
    """(R, C) Fp matrix, bind the row bits at r_rows (log R, 4) -> (C, 4):
    u = eq^T . mat as an M = 4 modular matmul."""
    eq_t = eq_points(r_rows).T
    if mat.device.type == "cuda":
        eq_t, mat = eq_t.contiguous(), mat.contiguous()
    return modmatmul(eq_t, mat).T
