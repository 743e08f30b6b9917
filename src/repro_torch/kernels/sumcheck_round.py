"""K3: fused multi-claim sum-check rounds (CUDA, ``csrc/sumcheck_round.cu``)
and their plain version.

Replaces ``repro.kernels.sumcheck_round.prove_rounds``.  For K claims of d
Fp4 factors of length n (K, n, 4) with one sponge row each (K, 16), every
round computes g(0..d), absorbs g into the claim's sponge, squeezes the Fp4
challenge and folds every factor by it; after the last round the final
evaluations are absorbed, the schedule of the JAX package's epilogue.

On the card one C call (``sc_prove``) queues every launch of the call on
the stream with no host synchronisation; the caller reads the results
once.  ``plan(d, n)`` says what it launches: a claim whose factors fit in
one block's shared memory (n <= ``tail_len(d)``) is one launch, the tail
kernel, which runs every round and the final absorb; a longer one first
runs ``head_rounds`` = log2(n / tail_len(d)) rounds of two launches each
(a one-warp absorb and squeeze, then a fold fused with the next round's
partial sums) after one launch of round-0 partial sums, and the tail
applies the last head fold as it loads: 2 h + 1 launches.  ``launches``
counts the launches the C call reports.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.core import field as F
from repro_torch.core import poseidon2 as P2

from . import _build
from . import poseidon2_kernel as K1

launches = 0
HEAD_THREADS = 256
TAIL_THREADS = 512
MAX_HEAD_BLOCKS = 4 * 132
# Shared memory the tail block gives the factors (u32 Fp4 words, 16 B
# each), inside the 227 KB (232,448 B) a block may have on the H100.
TAIL_SMEM_BYTES = 196_608
_READY: set = set()


def tail_len(d: int) -> int:
    """The longest factor length whose d factors fit in the tail block's
    shared memory: 8192 for d = 1, 4096 for d = 2 and 3."""
    words = TAIL_SMEM_BYTES // (16 * d)
    return 1 << (words.bit_length() - 1)


@dataclasses.dataclass(frozen=True)
class Plan:
    """What ``prove_rounds`` launches for K claims of d factors of length n."""
    rounds: int            # m = log2 n
    head_rounds: int       # rounds run by the head kernels
    n_tail: int            # factor length the tail block starts from
    head_blocks: int       # blocks per claim of the head's partial and fold
    tail_threads: int
    launches: int
    scratch_words: int     # u32 words: partials, then two ping-pong buffers


def plan(d: int, n: int, K: int = 1) -> Plan:
    m = n.bit_length() - 1
    h = max(0, m - (tail_len(d).bit_length() - 1))
    nt = n >> h
    nb = max(1, min(MAX_HEAD_BLOCKS, -(-(n // 4) // HEAD_THREADS)))
    threads = min(TAIL_THREADS, max(32, -(-(nt // 2) // 32) * 32))
    w = 4 * (d + 1)
    scratch = 0
    if h >= 1:
        scratch = K * nb * w
    if h >= 2:
        scratch += d * K * (n // 2 + n // 4) * 4
    return Plan(rounds=m, head_rounds=h, n_tail=nt,
                head_blocks=nb, tail_threads=threads,
                launches=1 if h == 0 else 2 * h + 1, scratch_words=scratch)


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
        vp, lg, ci, u32 = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_uint32
        lib.sc_set_constants.argtypes = [vp, vp, vp]
        lib.sc_set_constants.restype = ci
        lib.sc_prove.argtypes = [vp, vp, vp, ci, lg, lg, ci, ci, lg, ci, ci,
                                 vp, vp, vp, vp, vp, vp, u32, u32,
                                 ctypes.POINTER(ci), vp]
        lib.sc_prove.restype = ci
        lib.sc_set_tail_smem.argtypes = [ci]
        lib.sc_set_tail_smem.restype = ci
        K1.upload_constants(lib.sc_set_constants, device)
        with torch.cuda.device(device):
            _build.check(lib.sc_set_tail_smem(TAIL_SMEM_BYTES), "sc_set_tail_smem")
        _READY.add(key)
    return lib


def prove_rounds(factors: Sequence[torch.Tensor], states: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """factors: d arrays (K, n, 4); states: (K, 16).  Returns
    ``(round_polys (K, m, d+1, 4), points (K, m, 4), final_evals (K, d, 4),
    new_states (K, 16))``."""
    d, K, n = _check_args(factors, states)
    if states.device.type == "cpu":
        return prove_rounds_plain(factors, states)
    factors = [f.contiguous() for f in factors]
    _build.require_cuda_int64(states, *factors)
    dev = states.device
    pl = plan(d, n, K)
    lib = _lib(dev)
    m = pl.rounds
    rp = torch.empty((K, m, d + 1, 4), dtype=F.I64, device=dev)
    cs = torch.empty((K, m, 4), dtype=F.I64, device=dev)
    finals = torch.empty((K, d, 4), dtype=F.I64, device=dev)
    st = torch.empty((K, P2.WIDTH), dtype=F.I64, device=dev)
    scratch = torch.empty((pl.scratch_words,), dtype=torch.int32, device=dev)
    fp = [_build.ptr(f) for f in factors] + [None] * (3 - d)
    launched = ctypes.c_int(0)
    status = lib.sc_prove(
        fp[0], fp[1], fp[2], d, K, n, m, pl.head_rounds, pl.n_tail,
        pl.head_blocks, pl.tail_threads, _build.ptr(scratch),
        _build.ptr(states), _build.ptr(st), _build.ptr(rp), _build.ptr(cs),
        _build.ptr(finals), F.mont_int(4 * (d + 1)), F.mont_int(4 * d),
        ctypes.byref(launched), _build.stream_ptr(states))
    _count(launched.value)
    _build.check(status, "sc_prove")
    return rp, cs, finals, st


def _count(n: int) -> None:
    _build.bump(globals(), "launches", n)
