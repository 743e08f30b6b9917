"""K1: batched Poseidon2 (CUDA, ``csrc/poseidon2.cu``) and its plain version.

Replaces ``repro.kernels.poseidon2_kernel`` (``permute_batch``,
``compress_pairs``, ``hash_rows``).  Four entry points share one device
permutation:

* ``permute_batch`` — permute n states;
* ``sponge`` — length-tagged sponge absorption of n rows, optionally from
  given states and over several segments back to back (Merkle leaf hashing
  with ``hash_rows``; the transcript's absorb; the final absorb of K3's
  plain version);
* ``squeeze`` — permute-and-emit the rate lanes, ``nblocks`` times;
* ``compress_pairs`` — 2-to-1 compression with feedforward.

On a CUDA tensor each wrapper launches the kernel; on a CPU tensor it runs
the ``*_plain`` version below, which follows the same schedule in int64.
``launches`` counts kernel launches.

On the card a state is held by 16 lanes (half a warp), one word each, and
a block of ``THREADS`` = 128 holds 8 rows: ``blocks(n)`` is the grid for n
rows.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import field as F
from repro_torch.core import poseidon2 as P2

from . import _build

launches = 0
LANES = P2.WIDTH      # lanes per state on the card
THREADS = 128         # threads per block: 8 states

_R_INV6 = pow(F.R_INV, 6, F.P)
_CONSTS: dict = {}
_READY: set = set()


# ---------------------------------------------------------------------------
# Plain PyTorch version (int64, same schedule as the kernel).
# ---------------------------------------------------------------------------
def _consts(device):
    key = str(device)
    c = _CONSTS.get(key)
    if c is None:
        c = dict(rcf=torch.as_tensor(P2.RC_FULL_M, device=device),
                 rcp=[int(v) for v in P2.RC_PART_M],
                 diag=torch.as_tensor(P2.DIAG, device=device),
                 mext=torch.as_tensor(P2.M_EXT, device=device))
        _CONSTS[key] = c
    return c


def _sbox(x: torch.Tensor) -> torch.Tensor:
    # Montgomery x^7: four Montgomery products give x^7 R^-6
    x2 = x * x % F.P
    x4 = x2 * x2 % F.P
    x7 = x4 * (x2 * x % F.P) % F.P
    return x7 * _R_INV6 % F.P


def _external(s: torch.Tensor, mext: torch.Tensor) -> torch.Tensor:
    return (s.unsqueeze(-2) * mext).sum(-1) % F.P


def permute_plain(states: torch.Tensor) -> torch.Tensor:
    c = _consts(states.device)
    s = _external(states, c["mext"])
    for r in range(P2.RF // 2):
        s = _external(_sbox((s + c["rcf"][r]) % F.P), c["mext"])
    for r in range(P2.RP):
        s0 = _sbox((s[..., :1] + c["rcp"][r]) % F.P)
        s = torch.cat([s0, s[..., 1:]], dim=-1)
        s = (s * c["diag"] + s.sum(-1, keepdim=True)) % F.P
    for r in range(P2.RF // 2, P2.RF):
        s = _external(_sbox((s + c["rcf"][r]) % F.P), c["mext"])
    return s


def sponge_plain(init: Optional[torch.Tensor], elems: torch.Tensor,
                 seg_len: int, nseg: int = 1,
                 out_width: int = P2.WIDTH) -> torch.Tensor:
    n = elems.shape[0]
    if init is None:
        s = torch.zeros((n, P2.WIDTH), dtype=F.I64, device=elems.device)
    else:
        s = init
    tag = F.mont_int(seg_len)
    pad = (-seg_len) % P2.RATE
    segs = elems.reshape(n, nseg, seg_len)
    if pad:
        segs = torch.nn.functional.pad(segs, (0, pad))
    for g in range(nseg):
        lane = s[:, P2.RATE:P2.RATE + 1]
        s = torch.cat([s[:, :P2.RATE], (lane + tag) % F.P,
                       s[:, P2.RATE + 1:]], dim=1)
        for k in range((seg_len + pad) // P2.RATE):
            chunk = segs[:, g, k * P2.RATE:(k + 1) * P2.RATE]
            s = torch.cat([(s[:, :P2.RATE] + chunk) % F.P, s[:, P2.RATE:]],
                          dim=1)
            s = permute_plain(s)
    return s[:, :out_width]


def squeeze_plain(states: torch.Tensor, nblocks: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    lanes = []
    s = states
    for _ in range(nblocks):
        s = permute_plain(s)
        lanes.append(s[:, :P2.RATE])
    return s, torch.cat(lanes, dim=1)


def compress_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    out = permute_plain(torch.cat([left, right], dim=-1))[..., :P2.DIGEST]
    return (out + left) % F.P


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------
def _lib(device) -> ctypes.CDLL:
    lib = _build.load("poseidon2")
    key = (str(device), id(lib))
    if key not in _READY:
        vp, lg = ctypes.c_void_p, ctypes.c_long
        lib.p2_set_constants.argtypes = [vp, vp, vp]
        ci = ctypes.c_int
        lib.p2_permute.argtypes = [vp, vp, lg, ci, vp]
        lib.p2_sponge.argtypes = [vp, vp, lg, lg, ctypes.c_uint32, vp, ci,
                                  lg, ci, vp]
        lib.p2_squeeze.argtypes = [vp, vp, vp, ci, lg, ci, vp]
        lib.p2_compress.argtypes = [vp, vp, vp, lg, ci, vp]
        for fn in (lib.p2_set_constants, lib.p2_permute, lib.p2_sponge,
                   lib.p2_squeeze, lib.p2_compress):
            fn.restype = ctypes.c_int
        upload_constants(lib.p2_set_constants, device)
        _READY.add(key)
    return lib


def upload_constants(set_constants, device) -> None:
    """Copy the round constants into a library's __constant__ memory
    through its ``*_set_constants`` C function."""
    rcf = np.ascontiguousarray(P2.RC_FULL_M, dtype=np.uint32)
    rcp = np.ascontiguousarray(P2.RC_PART_M, dtype=np.uint32)
    diag = np.ascontiguousarray(P2.DIAG_M, dtype=np.uint32)
    with torch.cuda.device(device):
        _build.check(set_constants(
            rcf.ctypes.data_as(ctypes.c_void_p),
            rcp.ctypes.data_as(ctypes.c_void_p),
            diag.ctypes.data_as(ctypes.c_void_p)), "p2_set_constants")


def blocks(n: int) -> int:
    """Grid of a launch over n rows (16 lanes each, 8 rows a block)."""
    return -(-n * LANES // THREADS)


def _count() -> None:
    _build.bump(globals(), "launches")


def permute_batch(states: torch.Tensor) -> torch.Tensor:
    """states: (n, 16) Montgomery -> permuted states."""
    if states.ndim != 2 or states.shape[1] != P2.WIDTH:
        raise ValueError(f"permute_batch wants (n, 16), got {tuple(states.shape)}")
    if states.device.type == "cpu":
        return permute_plain(states)
    _build.require_cuda_int64(states)
    out = torch.empty_like(states)
    lib = _lib(states.device)
    _count()
    n = states.shape[0]
    _build.check(lib.p2_permute(_build.ptr(states), _build.ptr(out), n,
                                blocks(n), _build.stream_ptr(states)),
                 "p2_permute")
    return out


def sponge(init: Optional[torch.Tensor], elems: torch.Tensor, seg_len: int,
           nseg: int = 1, out_width: int = P2.WIDTH) -> torch.Tensor:
    """elems: (n, nseg * seg_len).  Each row starts from ``init`` (or zero
    states); each segment adds the length tag seg_len to lane RATE and is
    absorbed in RATE chunks (zero-padded), one permutation per chunk.
    Returns the first ``out_width`` lanes of the final states."""
    if elems.ndim != 2 or elems.shape[1] != seg_len * nseg:
        raise ValueError(f"sponge wants (n, {seg_len * nseg}), got {tuple(elems.shape)}")
    if init is not None and tuple(init.shape) != (elems.shape[0], P2.WIDTH):
        raise ValueError("sponge init must be (n, 16)")
    if not 0 < out_width <= P2.WIDTH:
        raise ValueError("out_width must be in 1..16")
    if elems.device.type == "cpu":
        return sponge_plain(init, elems, seg_len, nseg, out_width)
    _build.require_cuda_int64(elems, *(() if init is None else (init,)))
    n = elems.shape[0]
    out = torch.empty((n, out_width), dtype=F.I64, device=elems.device)
    lib = _lib(elems.device)
    _count()
    _build.check(lib.p2_sponge(
        None if init is None else _build.ptr(init), _build.ptr(elems),
        seg_len, nseg, F.mont_int(seg_len), _build.ptr(out), out_width, n,
        blocks(n), _build.stream_ptr(elems)), "p2_sponge")
    return out


def squeeze(states: torch.Tensor, nblocks: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new states (n, 16), lanes (n, 8 * nblocks))."""
    if states.ndim != 2 or states.shape[1] != P2.WIDTH or nblocks < 1:
        raise ValueError("squeeze wants (n, 16) states and nblocks >= 1")
    if states.device.type == "cpu":
        return squeeze_plain(states, nblocks)
    _build.require_cuda_int64(states)
    n = states.shape[0]
    st = torch.empty_like(states)
    lanes = torch.empty((n, nblocks * P2.RATE), dtype=F.I64,
                        device=states.device)
    lib = _lib(states.device)
    _count()
    _build.check(lib.p2_squeeze(_build.ptr(states), _build.ptr(st),
                                _build.ptr(lanes), nblocks, n, blocks(n),
                                _build.stream_ptr(states)), "p2_squeeze")
    return st, lanes


def compress_pairs(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """2-to-1 compression of (..., 8) node pairs."""
    if left.shape != right.shape or left.shape[-1] != P2.DIGEST:
        raise ValueError("compress_pairs wants two (..., 8) arrays")
    if left.device.type == "cpu":
        return compress_plain(left, right)
    _build.require_cuda_int64(left, right)
    out = torch.empty_like(left)
    n = left.numel() // P2.DIGEST
    lib = _lib(left.device)
    _count()
    _build.check(lib.p2_compress(_build.ptr(left), _build.ptr(right),
                                 _build.ptr(out), n, blocks(n),
                                 _build.stream_ptr(left)),
                 "p2_compress")
    return out


def hash_rows(elems: torch.Tensor) -> torch.Tensor:
    """Sponge-hash along the trailing axis -> (..., 8) digests, matching
    ``poseidon2.hash_elems`` of the JAX package element for element."""
    batch = elems.shape[:-1]
    L = elems.shape[-1]
    flat = elems.reshape(-1, L)
    if flat.device.type == "cuda":
        flat = flat.contiguous()
    out = sponge(None, flat, L, 1, P2.DIGEST)
    return out.reshape(*batch, P2.DIGEST)
