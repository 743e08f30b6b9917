"""K4: modular matmul C = A @ B mod P (CUDA, ``csrc/modmatmul.cu``) and its
plain version, plus the partial evaluation it serves.

Replaces ``repro.kernels.modmatmul.modmatmul`` and
``repro.kernels.ops.partial_eval_rows_mm``.  No library call computes a
modular product (and CUDA has no int64 matmul), so the plain version forms
the products and reduces the sum once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import field as F
from repro_torch.core.mle import eq_points

from . import _build

launches = 0
_READY: set = set()


def modmatmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # products < P^2 < 2^62 reduce first, so the K-term sum stays < K P
    prod = a[:, :, None] * b[None, :, :] % F.P                   # (M, K, N)
    return prod.sum(dim=1) % F.P * F.R_INV % F.P


def _lib() -> ctypes.CDLL:
    lib = _build.load("modmatmul")
    if id(lib) not in _READY:
        vp = ctypes.c_void_p
        lib.modmatmul.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_long,
                                  ctypes.c_long, vp]
        lib.modmatmul.restype = ctypes.c_int
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
    global launches
    launches += 1
    _build.check(_lib().modmatmul(_build.ptr(a), _build.ptr(b),
                                  _build.ptr(out), M, K, N,
                                  _build.stream_ptr(a)), "modmatmul")
    return out


def partial_eval_rows_mm(mat: torch.Tensor, r_rows: torch.Tensor
                         ) -> torch.Tensor:
    """(R, C) Fp matrix, bind the row bits at r_rows (log R, 4) -> (C, 4):
    u = eq^T . mat as an M = 4 modular matmul."""
    eq_t = eq_points(r_rows).T
    if mat.device.type == "cuda":
        eq_t, mat = eq_t.contiguous(), mat.contiguous()
    return modmatmul(eq_t, mat).T
