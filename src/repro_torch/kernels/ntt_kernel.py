"""K2: batched radix-2 NTT along rows (CUDA, ``csrc/ntt.cu``) and its
plain version.

Replaces ``repro.kernels.ntt_kernel.ntt_rows``.  The kernel bit-reverses
each row as it loads it into shared memory and runs every butterfly stage
there; the plain version runs the same stages on int64 tensors.  Rows of
length n need 4n bytes of shared memory; rows longer than the card's
dynamic shared-memory limit raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import field as F
from repro_torch.core import ntt as NTT

from . import _build

launches = 0
MAX_SHARED_BYTES = 232448     # dynamic shared memory of one sm_90 block
_TW: dict = {}
_READY: set = set()


def _twiddles(n: int, inverse: bool, device) -> torch.Tensor:
    key = (n, inverse, str(device))
    t = _TW.get(key)
    if t is None:
        t = F.tensor(NTT._twiddles(n, inverse), device)
        _TW[key] = t
    return t


def ntt_rows_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    rows, n = x.shape
    if n == 1:
        return x
    stages = n.bit_length() - 1
    tw_full = _twiddles(n, inverse, x.device)
    x = x[:, torch.as_tensor(NTT._bitrev(n), device=x.device)]
    for s in range(stages):
        half = 1 << s
        stride = n // (2 * half)
        xe = x.reshape(rows, n // (2 * half), 2, half)
        lo, hi = xe[:, :, 0, :], xe[:, :, 1, :]
        thi = F.fmul(hi, tw_full[::stride][:half])
        x = torch.stack([F.fadd(lo, thi), F.fsub(lo, thi)],
                        dim=2).reshape(rows, n)
    if inverse:
        x = F.fmul(x, F.mont_int(pow(n, F.P - 2, F.P)))
    return x


def _lib() -> ctypes.CDLL:
    lib = _build.load("ntt")
    if id(lib) not in _READY:
        vp = ctypes.c_void_p
        lib.ntt_rows.argtypes = [vp, vp, vp, ctypes.c_long, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_uint32, vp]
        lib.ntt_rows.restype = ctypes.c_int
        _READY.add(id(lib))
    return lib


def rows_per_block(n: int) -> int:
    """Pack short rows several to a block (at least 512 butterflies)."""
    return max(1, 1024 // n)


def ntt_rows(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """x: (rows, n) Montgomery, n a power of two; NTT along each row."""
    if x.ndim != 2:
        raise ValueError(f"ntt_rows wants (rows, n), got {tuple(x.shape)}")
    rows, n = x.shape
    if n & (n - 1):
        raise ValueError(f"NTT length {n} is not a power of two")
    if x.device.type == "cpu":
        return ntt_rows_plain(x, inverse)
    if n == 1:
        return x
    _build.require_cuda_int64(x)
    rpb = rows_per_block(n)
    if 4 * n * rpb > MAX_SHARED_BYTES:
        raise ValueError(f"NTT row of {n} words exceeds the shared-memory limit")
    tw = _twiddles(n, inverse, x.device)
    out = torch.empty_like(x)
    global launches
    launches += 1
    _build.check(_lib().ntt_rows(
        _build.ptr(x), _build.ptr(out), _build.ptr(tw), rows, n,
        n.bit_length() - 1, rpb, int(inverse),
        F.mont_int(pow(n, F.P - 2, F.P)), _build.stream_ptr(x)), "ntt_rows")
    return out
