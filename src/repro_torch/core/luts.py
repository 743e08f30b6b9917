"""2^16-entry lookup tables for the circuit's non-arithmetic ops (mirrors
``repro.core.luts``, integer path).

Tables are built on the CPU in float64 with numpy, exactly as the JAX
package builds them (scipy's erf where present), and only then moved to a
device: GPU transcendentals carry no bit-for-bit guarantee, and the
``ModelCard`` publishes the sha256 of every table.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

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


_DEVICE_TABLES: dict = {}


def table_tensor(name: str, device) -> torch.Tensor:
    """``table_q(name)`` as an int64 tensor on ``device`` (copied once)."""
    key = (name, str(device))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = torch.as_tensor(table_q(name).astype(np.int64), device=device)
        _DEVICE_TABLES[key] = t
    return t


def lo_code(name: str) -> int:
    spec = ALL_SPECS[name]
    return int(round(spec.lo * (1 << spec.f_in)))
