"""K3: fused multi-claim sum-check rounds (CUDA, ``csrc/sumcheck_round.cu``)
and their plain version.

Replaces ``repro.kernels.sumcheck_round.prove_rounds``.  For K claims of d
Fp4 factors of length n (K, n, 4) with one sponge row each (K, 16), every
round computes g(0..d), absorbs g into the claim's sponge, squeezes the Fp4
challenge and folds every factor by it.  All m = log2 n rounds are queued
on the stream with no host synchronisation; the caller reads the results
once.  After the last round the final evaluations are absorbed with one K1
sponge launch, the schedule of the JAX package's epilogue.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.core import field as F
from repro_torch.core import poseidon2 as P2

from . import _build
from . import poseidon2_kernel as K1

launches = 0
THREADS = 256
MAX_PARTIAL_BLOCKS = 64
_READY: set = set()


def _check_args(factors: Sequence[torch.Tensor], states: torch.Tensor):
    d = len(factors)
    if not 1 <= d <= 3:
        raise ValueError(f"K3 takes 1..3 factors, got {d}")
    shape = tuple(factors[0].shape)
    if len(shape) != 3 or shape[-1] != 4:
        raise ValueError(f"factors must be (K, n, 4), got {shape}")
    K, n, _ = shape
    if any(tuple(f.shape) != shape for f in factors):
        raise ValueError("factors must share one shape")
    if n < 2 or n & (n - 1):
        raise ValueError(f"factor length {n} must be a power of two >= 2")
    if tuple(states.shape) != (K, P2.WIDTH):
        raise ValueError(f"states must be ({K}, 16), got {tuple(states.shape)}")
    return d, K, n


def _finals(factors):
    """Final evaluations (K, d, 4) and their flat absorb rows (K, 4d)."""
    finals = torch.stack([f[:, 0] for f in factors], dim=1)
    return finals, finals.reshape(finals.shape[0], 4 * len(factors))


def prove_rounds_plain(factors: Sequence[torch.Tensor], states: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
    d, K, n = _check_args(factors, states)
    m = n.bit_length() - 1
    n_abs = 4 * (d + 1)
    fs = list(factors)
    gs, cs = [], []
    st = states
    for _ in range(m):
        half = fs[0].shape[1] // 2
        los = [f[:, :half] for f in fs]
        diffs = [F.f4sub(f[:, half:], lo) for f, lo in zip(fs, los)]
        cur = list(los)
        evals = []
        for t in range(d + 1):
            if t > 0:
                cur = [F.f4add(x, dd) for x, dd in zip(cur, diffs)]
            prod = cur[0]
            for f in cur[1:]:
                prod = F.f4mul(prod, f)
            evals.append(prod.sum(dim=1) % F.P)                  # (K, 4)
        g = torch.stack(evals, dim=1)                            # (K, d+1, 4)
        st = K1.sponge_plain(st, g.reshape(K, n_abs), n_abs)
        st, lanes = K1.squeeze_plain(st, 1)
        c = lanes[:, None, :4]
        fs = [F.f4add(lo, F.f4mul(c, dd)) for lo, dd in zip(los, diffs)]
        gs.append(g)
        cs.append(lanes[:, :4])
    finals, flat = _finals(fs)
    st = K1.sponge_plain(st, flat, 4 * d)
    return torch.stack(gs, dim=1), torch.stack(cs, dim=1), finals, st


def _lib(device) -> ctypes.CDLL:
    lib = _build.load("sumcheck_round")
    key = (str(device), id(lib))
    if key not in _READY:
        vp, lg, ci = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        lib.sc_set_constants.argtypes = [vp, vp, vp]
        lib.sc_set_constants.restype = ci
        lib.sc_round.argtypes = [vp, lg, lg, ci, vp, ci, vp, vp, vp, ci, ci,
                                 ctypes.c_uint32, vp, vp]
        lib.sc_round.restype = ci
        K1.upload_constants(lib.sc_set_constants, device)
        _READY.add(key)
    return lib


def partial_blocks(half: int) -> int:
    return max(1, min(-(-half // THREADS), MAX_PARTIAL_BLOCKS))


def prove_rounds(factors: Sequence[torch.Tensor], states: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """factors: d arrays (K, n, 4); states: (K, 16).  Returns
    ``(round_polys (K, m, d+1, 4), points (K, m, 4), final_evals (K, d, 4),
    new_states (K, 16))``."""
    d, K, n = _check_args(factors, states)
    if states.device.type == "cpu":
        return prove_rounds_plain(factors, states)
    _build.require_cuda_int64(states, *factors)
    dev = states.device
    m = n.bit_length() - 1
    lib = _lib(dev)
    cur = torch.stack(list(factors))                             # (d, K, n, 4)
    st = states.clone()
    rp = torch.empty((K, m, d + 1, 4), dtype=F.I64, device=dev)
    cs = torch.empty((K, m, 4), dtype=F.I64, device=dev)
    tag = F.mont_int(4 * (d + 1))
    stream = _build.stream_ptr(states)
    global launches
    for rnd in range(m):
        half = cur.shape[2] // 2
        nb = partial_blocks(half)
        partial = torch.empty((K, nb, d + 1, 4), dtype=F.I64, device=dev)
        nxt = torch.empty((d, K, half, 4), dtype=F.I64, device=dev)
        launches += 3
        _build.check(lib.sc_round(
            _build.ptr(cur), K, cur.shape[2], d, _build.ptr(partial), nb,
            _build.ptr(st), _build.ptr(rp), _build.ptr(cs), rnd, m, tag,
            _build.ptr(nxt), stream), "sc_round")
        cur = nxt
    finals, flat = _finals(list(cur))
    st = K1.sponge(st, flat.contiguous(), 4 * d)
    return rp, cs, finals, st
