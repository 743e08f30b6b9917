"""16-bit fixed-point quantization, f = 8 fractional bits (mirrors
``repro.core.quantize``; paper §4).

A real value x is stored as q = round(x * 2^8) clamped to [-2^15, 2^15 - 1];
inside the field q is embedded as q mod P.  ``torch.round`` rounds half to
even, as ``jnp.round`` does.  Floating inputs are taken as float32, the
JAX package's default float width, so ties fall the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from . import field as F

FRAC_BITS = 8
SCALE = 1 << FRAC_BITS            # 256
QMIN = -(1 << 15)
QMAX = (1 << 15) - 1


def _float32(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x.float() if x.is_floating_point() else x


def quantize(x) -> torch.Tensor:
    """float tensor -> int32 fixed point with f=8, saturating."""
    q = torch.round(_float32(x) * SCALE)
    return torch.clamp(q, QMIN, QMAX).to(torch.int32)


def dequantize(q) -> torch.Tensor:
    return torch.as_tensor(q).to(torch.float32) / SCALE


def to_field(q, device=None) -> torch.Tensor:
    """Signed fixed point -> Montgomery Fp (negatives wrap mod P), on
    ``device`` (a tensor's own device when ``device`` is None)."""
    if device is None and isinstance(q, torch.Tensor):
        device = q.device
    else:
        device = resolve_device(device)
    if isinstance(q, torch.Tensor):
        q = q.cpu().numpy()
    return F.f_from_int(np.asarray(q), device)


def from_field(a: torch.Tensor) -> np.ndarray:
    """Montgomery Fp -> signed int64 in (-P/2, P/2] (centered lift)."""
    v = F.f_to_int(a)
    return np.where(v > F.P // 2, v - F.P, v)


def requant_shift(acc, extra_frac_bits: int = FRAC_BITS) -> torch.Tensor:
    """Round-to-nearest arithmetic shift (acc + 2^(s-1)) >> s, saturated:
    the rescale after a fixed-point matmul (2f -> f fractional bits)."""
    s = extra_frac_bits
    acc = torch.as_tensor(acc).to(torch.int64)
    rounded = (acc + (1 << (s - 1))) >> s
    return torch.clamp(rounded, QMIN, QMAX).to(torch.int32)
