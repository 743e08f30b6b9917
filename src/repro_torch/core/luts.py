"""2^16-entry lookup tables for the non-arithmetic ops (mirrors
``repro.core.luts``).

Two views of one table: the integer path (the circuit: ``table_q``,
``index_of_q``, ``apply_q``) and the float path (the deployed model:
``table_f32``, ``index_of``, ``apply``), a nearest-entry lookup that the
LUT-approximated models of ``repro_torch.models`` use.

Tables are built on the CPU in float64 with numpy, exactly as the JAX
package builds them (scipy's erf where present), and only then moved to a
device, once per device: GPU transcendentals carry no bit-for-bit
guarantee, and the ``ModelCard`` publishes the sha256 of every table.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device

LUT_BITS = 16
LUT_SIZE = 1 << LUT_BITS


@dataclasses.dataclass(frozen=True)
class LUTSpec:
    name: str
    lo: float                 # left end of table domain
    f_in: int                 # input fractional bits (step = 2^-f_in)
    f_out: int                # output fractional bits for the integer table
    fn: Callable              # exact numpy function
    clamp_lo: float = None    # optional in-domain clamp (rsqrt)

    @property
    def hi(self) -> float:
        return self.lo + LUT_SIZE * 2.0 ** (-self.f_in)


def _rsqrt(x):
    return 1.0 / np.sqrt(x)


def _erf(x):
    try:
        from scipy.special import erf as _e
        return _e(x)
    except ImportError:
        import math
        return np.vectorize(math.erf)(np.asarray(x, dtype=np.float64))


EXP = LUTSpec("exp", lo=-4.0, f_in=13, f_out=6, fn=np.exp)
GELU = LUTSpec("gelu", lo=-8.0, f_in=12, f_out=8,
               fn=lambda x: 0.5 * x * (1.0 + _erf(x / np.sqrt(2.0))))
SILU = LUTSpec("silu", lo=-8.0, f_in=12, f_out=8,
               fn=lambda x: x / (1.0 + np.exp(-x)))
RSQRT = LUTSpec("rsqrt", lo=0.0, f_in=12, f_out=11, fn=_rsqrt, clamp_lo=0.01)
SIGMOID = LUTSpec("sigmoid", lo=-8.0, f_in=12, f_out=14,
                  fn=lambda x: 1.0 / (1.0 + np.exp(-x)))
SOFTPLUS = LUTSpec("softplus", lo=-8.0, f_in=12, f_out=10,
                   fn=lambda x: np.log1p(np.exp(x)))

ALL_SPECS = {s.name: s for s in (EXP, GELU, SILU, RSQRT, SIGMOID, SOFTPLUS)}


@functools.lru_cache(maxsize=None)
def grid(name: str) -> np.ndarray:
    """Input grid x_i = lo + i * 2^-f_in, float64, length 2^16."""
    spec = ALL_SPECS[name]
    return spec.lo + np.arange(LUT_SIZE, dtype=np.float64) * 2.0 ** (-spec.f_in)


@functools.lru_cache(maxsize=None)
def table_q(name: str) -> np.ndarray:
    """Integer output table round(f(grid) * 2^f_out), int32, built on the
    CPU in float64."""
    spec = ALL_SPECS[name]
    x = grid(name)
    if spec.clamp_lo is not None:
        x = np.maximum(x, spec.clamp_lo)
    return np.round(spec.fn(x) * (1 << spec.f_out)).astype(np.int64).astype(np.int32)


@functools.lru_cache(maxsize=None)
def table_f32(name: str) -> np.ndarray:
    """Float32 output table (deployed-model path), built in float64."""
    spec = ALL_SPECS[name]
    x = grid(name)
    if spec.clamp_lo is not None:
        x = np.maximum(x, spec.clamp_lo)
    return spec.fn(x).astype(np.float32)


_DEVICE_TABLES: dict = {}


def _on_device(kind: str, name: str, device, make) -> torch.Tensor:
    key = (kind, name, str(torch.device(device)))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = torch.as_tensor(make(), device=device)
        _DEVICE_TABLES[key] = t
    return t


def table_tensor(name: str, device) -> torch.Tensor:
    """``table_q(name)`` as an int64 tensor on ``device`` (copied once)."""
    return _on_device("q", name, device,
                      lambda: table_q(name).astype(np.int64))


def table_f32_tensor(name: str, device) -> torch.Tensor:
    """``table_f32(name)`` as a float32 tensor on ``device`` (copied once)."""
    return _on_device("f32", name, device, lambda: table_f32(name))


def lo_code(name: str) -> int:
    spec = ALL_SPECS[name]
    return int(round(spec.lo * (1 << spec.f_in)))


def index_of(name: str, x: torch.Tensor) -> torch.Tensor:
    """Float input -> clamped table index in [0, 2^16).  The arithmetic is
    float32, as the JAX package's for a float32 ``x``, so both pick the
    same entry (round half to even in both)."""
    spec = ALL_SPECS[name]
    i = torch.round((x.float() - spec.lo) * (1 << spec.f_in))
    return torch.clamp(i, 0, LUT_SIZE - 1).to(torch.int32)


def index_of_q(name: str, q: torch.Tensor, f_q: int) -> torch.Tensor:
    """Fixed-point input code (f_q fractional bits) -> table index:
    clamp(round(q 2^(f_in - f_q)) - lo 2^f_in); an exact shift for
    f_q <= f_in, round-half-up for f_q > f_in."""
    spec = ALL_SPECS[name]
    q = q.to(torch.int64)
    if f_q <= spec.f_in:
        scaled = q << (spec.f_in - f_q)
    else:
        s = f_q - spec.f_in
        scaled = (q + (1 << (s - 1))) >> s
    return torch.clamp(scaled - lo_code(name), 0, LUT_SIZE - 1).to(torch.int32)


def apply(name: str, x: torch.Tensor) -> torch.Tensor:
    """LUT-approximated op, float path (nearest entry, no interpolation)."""
    return table_f32_tensor(name, x.device)[index_of(name, x).long()]


def apply_q(name: str, q: torch.Tensor, f_q: int) -> torch.Tensor:
    """Integer-code path: input code -> int32 output code at f_out bits."""
    t = table_tensor(name, q.device)
    return t[index_of_q(name, q, f_q).long()].to(torch.int32)


def measured_errors(name: str, n_samples: int = 200_001, device=None):
    """Max-abs and mean-relative error of the float LUT over its range
    (the paper's Table 1 method: dense sampling, nearest entry against the
    exact function); the lookups run on ``device``."""
    spec = ALL_SPECS[name]
    lo = spec.clamp_lo if spec.clamp_lo is not None else spec.lo
    hi = spec.hi if spec.name != "rsqrt" else 10.0
    xs = np.linspace(lo, hi, n_samples)
    exact = spec.fn(xs)
    x = torch.as_tensor(xs.astype(np.float32), device=resolve_device(device))
    approx = apply(name, x).cpu().numpy().astype(np.float64)
    abs_err = np.abs(approx - exact)
    rel = abs_err / np.maximum(np.abs(exact), 1e-12)
    return float(abs_err.max()), float(rel.mean())
