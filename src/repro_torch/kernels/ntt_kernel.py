"""K2: batched radix-2 NTT along rows, and the Reed-Solomon encode of
unpadded rows (CUDA, ``csrc/ntt.cu``), with their plain versions.

Replaces ``repro.kernels.ntt_kernel.ntt_rows`` and, for the RS encode, the
zero padding that ``repro.core.pcs`` and ``repro.core.ntt`` apply before
it: ``rs_encode_rows(rows, blowup)`` equals ``ntt_rows`` of the rows padded
with zeros to ``c * blowup`` words, but the kernel reads only the c message
words (on a bit-reversed zero-padded row the first log2(blowup) stages
only copy each word to ``blowup`` places).  Both entries run the one
kernel: passes of up to four butterfly stages in registers, shared memory
between passes.  On the card a block transforms a row of n words in 4 n
bytes of shared memory for the plain transform and 4 (n + c) for an encode
(its message is staged apart), so rows up to 2^15 words take one launch.
A longer row, up to 2^20 words, takes two (``plan``): its first 15 stages
as 2^15-word blocks gathered at a stride, then the top stages over global
memory.  Longer rows raise.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import field as F
from repro_torch.core import ntt as NTT

from . import _build

launches = 0
long_launches = 0             # the part of ``launches`` made on rows > 2^15
# calls that reached the card, by (rows, n, c): c < n for an RS encode
launch_shapes: collections.Counter = collections.Counter()
MAX_SHARED_BYTES = 232448     # dynamic shared memory of one sm_90 block
BLOCK_WORDS = 4096            # output words per block: 16 a thread of 256
ROW_LOG_N = 15                # the longest row one block transforms
MAX_SPLIT = 5                 # a long row: at most 2^5 blocks of 2^15 words
MAX_LOG_N = ROW_LOG_N + MAX_SPLIT
_TW: dict = {}
_READY: set = set()


def _twiddles(n: int, inverse: bool, device) -> torch.Tensor:
    key = (n, inverse, str(device))
    t = _TW.get(key)
    if t is None:
        t = F.tensor(NTT._twiddles(n, inverse), device)
        _TW[key] = t
    return t


def stage_table(n: int, inverse: bool) -> np.ndarray:
    """The kernel's twiddles, stage-major, (n, 2) u32: row 2^s + j holds
    w = w_{2^(s+1)}^j as a plain residue (not Montgomery: the kernel's
    Shoup product x w mod P keeps a Montgomery x in Montgomery form) and
    w' = floor(w 2^32 / P), for stage s < log2 n and j < 2^s; row 0 is
    unused."""
    tw = NTT._twiddles(n, inverse).astype(np.int64) * F.R_INV % F.P
    W = np.zeros((n, 2), dtype=np.uint64)
    for s in range(n.bit_length() - 1):
        h = 1 << s
        W[h:2 * h, 0] = tw[::n // (2 * h)][:h]
    W[:, 1] = (W[:, 0] << np.uint64(32)) // np.uint64(F.P)
    return W.astype(np.uint32)


def _stage_table(n: int, inverse: bool, device) -> torch.Tensor:
    key = ("stage", n, inverse, str(device))
    t = _TW.get(key)
    if t is None:
        t = torch.as_tensor(stage_table(n, inverse).view(np.int32), device=device)
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


def rs_encode_rows_plain(rows: torch.Tensor, blowup: int) -> torch.Tensor:
    """The JAX package's encode: pad each row to c * blowup, then NTT."""
    c = rows.shape[1]
    return ntt_rows_plain(torch.nn.functional.pad(rows, (0, c * blowup - c)))


def _lib(device) -> ctypes.CDLL:
    lib = _build.load("ntt")
    key = (str(device), id(lib))
    if key not in _READY:
        vp = ctypes.c_void_p
        lib.ntt_rows.argtypes = [vp, vp, vp, ctypes.c_long, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_uint32, vp]
        lib.ntt_rows.restype = ctypes.c_int
        lib.ntt_rows_long.argtypes = [vp, vp, vp, ctypes.c_long, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_uint32, vp]
        lib.ntt_rows_long.restype = ctypes.c_int
        lib.ntt_set_max_smem.restype = ctypes.c_int
        with torch.cuda.device(device):
            _build.check(lib.ntt_set_max_smem(), "ntt_set_max_smem")
        _READY.add(key)
    return lib


@functools.lru_cache(maxsize=None)
def _n_inv(n: int) -> int:
    return F.mont_int(pow(n, F.P - 2, F.P))


def rows_per_block(n: int) -> int:
    """Pack short rows several to a block (BLOCK_WORDS output words)."""
    return max(1, BLOCK_WORDS // n)


@dataclasses.dataclass(frozen=True)
class Plan:
    split: int            # k: a row is 2^k blocks of 2^15 words (0: one block)
    launches: int         # kernel launches per call
    rows_per_block: int   # rows (virtual rows of 2^15 words if split) a block
    shared_bytes: int     # dynamic shared memory of a block


def plan(n: int, c: int) -> Plan:
    """How the card transforms rows of n words read from c (c = n for the
    plain transform, c < n an RS encode).  Up to 2^15 words: one launch,
    short rows packed several to a block.  Longer: two launches, the first
    running each row as 2^k blocks of 2^15 words (each reads c / 2^k
    message words at stride 2^k), the second the top k stages.  Raises
    where no block's shared memory holds the row, past 2^20 words, or for a
    message shorter than 2^k words."""
    log_n = n.bit_length() - 1
    split = max(0, log_n - ROW_LOG_N)
    if split > MAX_SPLIT:
        raise ValueError(f"NTT row of {n} words exceeds the longest row the "
                         f"kernel takes (2^{MAX_LOG_N} words)")
    if c >> split == 0:
        raise ValueError(f"RS encode of {c} words into {n}: the message is "
                         f"shorter than the {1 << split} blocks of a row")
    m, cm = n >> split, c >> split
    rpb = rows_per_block(m)
    shared = 4 * (m + (cm if c < n else 0)) * rpb
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"NTT row of {n} words ({c} read) exceeds the "
                         "shared-memory limit")
    return Plan(split=split, launches=1 + (split > 0), rows_per_block=rpb,
                shared_bytes=shared)


def _launch(x: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    """rows x c words in (c = n / 2^L), rows x n out, on the card."""
    _build.require_cuda_int64(x)
    rows, c = x.shape
    log_n = n.bit_length() - 1
    L = log_n - (c.bit_length() - 1)
    pl = plan(n, c)
    tw = _stage_table(n, inverse, x.device)
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    lib = _lib(x.device)
    if pl.split:
        status = lib.ntt_rows_long(
            _build.ptr(x), _build.ptr(out), _build.ptr(tw), rows, log_n, L,
            int(inverse), _n_inv(n), _build.stream_ptr(x))
    else:
        status = lib.ntt_rows(
            _build.ptr(x), _build.ptr(out), _build.ptr(tw), rows, log_n, L,
            pl.rows_per_block, int(inverse), _n_inv(n), _build.stream_ptr(x))
    _build.check(status, "ntt_rows")
    if rows:
        _count(pl, rows, n, c)
    return out


def _count(pl: Plan, rows: int, n: int, c: int) -> None:
    _build.bump(globals(), "launches", pl.launches)
    if pl.split:
        _build.bump(globals(), "long_launches", pl.launches)
    _build.bump(launch_shapes, (rows, n, c))


def _pow2(v: int, what: str) -> None:
    if v < 1 or v & (v - 1):
        raise ValueError(f"{what} {v} is not a power of two")


def ntt_rows(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """x: (rows, n) Montgomery, n a power of two; NTT along each row."""
    if x.ndim != 2:
        raise ValueError(f"ntt_rows wants (rows, n), got {tuple(x.shape)}")
    rows, n = x.shape
    _pow2(n, "NTT length")
    if x.device.type == "cpu":
        return ntt_rows_plain(x, inverse)
    if n == 1:
        return x
    return _launch(x, n, inverse)


def rs_encode_rows(rows: torch.Tensor, blowup: int) -> torch.Tensor:
    """rows: (r, c) Montgomery message rows, c a power of two -> (r, c *
    blowup) Reed-Solomon codewords: each row taken as coefficients and
    evaluated on the subgroup of order c * blowup.  Equals
    ``ntt_rows(pad(rows))``."""
    if rows.ndim != 2:
        raise ValueError(f"rs_encode_rows wants (rows, c), got {tuple(rows.shape)}")
    c = rows.shape[1]
    _pow2(c, "message length")
    _pow2(blowup, "blowup")
    if rows.device.type == "cpu":
        return rs_encode_rows_plain(rows, blowup)
    n = c * blowup
    if n == 1:
        return rows
    return _launch(rows, n, False)
