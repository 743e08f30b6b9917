"""Radix-2 NTT over BabyBear for Reed-Solomon encoding (mirrors
``repro.core.ntt``).  Twiddles and the bit-reversal permutation are the
JAX package's; the transform runs through the K2 kernel
(``repro_torch.kernels.ntt_kernel``) on the card and through its plain
version on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F


@functools.lru_cache(maxsize=None)
def _root_of_unity(n: int) -> int:
    assert n & (n - 1) == 0 and n <= 2**F.TWO_ADICITY
    return pow(F.GENERATOR, (F.P - 1) // n, F.P)


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, inverse: bool) -> np.ndarray:
    """Full twiddle array w^0..w^(n/2-1) in Montgomery form."""
    w = _root_of_unity(n)
    if inverse:
        w = pow(w, F.P - 2, F.P)
    tw = np.empty(max(n // 2, 1), dtype=np.uint32)
    acc = 1
    for i in range(max(n // 2, 1)):
        tw[i] = (acc * F._R) % F.P
        acc = (acc * w) % F.P
    return tw


@functools.lru_cache(maxsize=None)
def _bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Cooley-Tukey NTT along the trailing axis (any leading dims)."""
    from repro_torch.kernels import ntt_kernel as K2
    n = x.shape[-1]
    if n == 1:
        return x
    assert n & (n - 1) == 0, "NTT size must be a power of two"
    flat = x.reshape(-1, n)
    if flat.device.type == "cuda":
        flat = flat.contiguous()
    return K2.ntt_rows(flat, inverse).reshape(x.shape)


def intt(x: torch.Tensor) -> torch.Tensor:
    return ntt(x, inverse=True)


def rs_encode(rows: torch.Tensor, blowup: int) -> torch.Tensor:
    """Reed-Solomon encode each row (trailing axis) at rate 1/blowup: the
    row is taken as polynomial coefficients (degree < c) and evaluated on
    the size c*blowup subgroup.  The K2 encode entry reads the unpadded
    rows (the JAX package pads, then transforms: the same words)."""
    from repro_torch.kernels import ntt_kernel as K2
    c = rows.shape[-1]
    n = c * blowup
    assert n & (n - 1) == 0
    if n == 1:
        return rows
    flat = rows.reshape(-1, c)
    if flat.device.type == "cuda":
        flat = flat.contiguous()
    return K2.rs_encode_rows(flat, blowup).reshape(*rows.shape[:-1], n)
