"""Quantized reference ops: the exact integer semantics of the circuit
(mirrors ``repro.core.qops``) on int64 tensors.

Activations are signed 16-bit fixed point with f=8 fractional bits,
feature-major (d, seq).  Rounding is round-half-up, floor((x + 2^(s-1)) / 2^s)
— an arithmetic right shift.  Every range assertion of the JAX package is
kept.  Integer products of two 16-bit operands summed over k terms stay far
below 2^53, so the matrix products run exactly in float64 (CUDA has no
int64 matmul); ``imatmul`` checks that bound.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import luts as LUTS

F8 = 8           # activation fractional bits
SOFTMAX_T = 8    # P carries f=8


def rshift_round(x: torch.Tensor, s: int) -> torch.Tensor:
    """Round-half-up arithmetic shift (the rescale relation's semantics)."""
    return (x + (1 << (s - 1))) >> s


def shl(x: torch.Tensor, s: int) -> torch.Tensor:
    """x * 2^s for signed x."""
    return x * (1 << s)


def _minmax(x: torch.Tensor):
    return int(x.min().item()), int(x.max().item())


def assert16(x: torch.Tensor, what: str) -> torch.Tensor:
    lo, hi = _minmax(x)
    assert lo >= -(1 << 15) and hi < (1 << 15), \
        f"{what} exceeds provable 16-bit range: [{lo}, {hi}]"
    return x


def imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul of int64 tensors through float64: every
    partial sum is an integer below 2^53, so no rounding occurs."""
    k = a.shape[-1]
    amax = int(a.abs().max().item()) if a.numel() else 0
    bmax = int(b.abs().max().item()) if b.numel() else 0
    assert k * amax * bmax < 2**53, "integer matmul exceeds float64 exactness"
    return torch.matmul(a.double(), b.double()).round().long()


def lut_apply(name: str, idx: torch.Tensor):
    """Table lookup on idx codes (callers produce in-range idx)."""
    spec = LUTS.ALL_SPECS[name]
    i = idx - LUTS.lo_code(name)
    lo, hi = _minmax(i)
    assert lo >= 0 and hi < LUTS.LUT_SIZE, \
        f"{name} LUT input out of range [{spec.lo}, {spec.hi})"
    return LUTS.table_tensor(name, idx.device)[i], i


def q_layernorm(x: torch.Tensor, g: torch.Tensor, b: Optional[torch.Tensor],
                subtract_mean: bool = True) -> Dict[str, torch.Tensor]:
    """x: (d, seq) f8 -> y: (d, seq) f8, with the full trace:
      mu   = round(colsum(x)/d)                        [if subtract_mean]
      xc   = x - mu
      ms   = round(colsum(xc^2) / (d 2^4))             rsqrt LUT input, f=12
      rst  = rsqrtLUT(ms)                              f=11
      xn   = round(xc rst / 2^11)                      f=8
      y    = round((xn g + 2^8 b) / 2^8)               f=8
    The divisions are floor divisions of int64 tensors, as numpy's."""
    d, seq = x.shape
    x = x.to(torch.int64)
    tr: Dict[str, torch.Tensor] = {}
    if subtract_mean:
        s1 = x.sum(dim=0)                          # (seq,)
        mu = torch.div(s1 + d // 2, d, rounding_mode="floor")
        tr["mu"] = assert16(mu, "ln mu")
        tr["e1"] = s1 + d // 2 - d * mu
        lo, hi = _minmax(tr["e1"])
        assert lo >= 0 and hi < d
        xc = x - mu[None, :]
    else:
        xc = x
    assert int(xc.abs().max().item()) < (1 << 15), "ln xc exceeds range"
    sq = (xc * xc).sum(dim=0)                      # (seq,) f16, < d*2^30
    D = d << 4                                     # -> ms at f=12
    ms = torch.div(sq + D // 2, D, rounding_mode="floor")
    tr["e2"] = sq + D // 2 - D * ms
    lo, hi = _minmax(ms)
    assert lo >= 0 and hi < (1 << 16), \
        f"ln mean-square out of rsqrt domain: max {hi / 4096.0}"
    tr["ms"] = ms
    rst, _ = lut_apply("rsqrt", ms)                # f=11, <= 20480
    tr["rst"] = rst
    xn_acc = xc * rst[None, :]
    xn = assert16(rshift_round(xn_acc, 11), "ln xn")
    tr["xn"] = xn
    tr["err_xn"] = xn_acc + (1 << 10) - shl(xn, 11)
    y_acc = xn * g.to(torch.int64)[:, None]
    if b is not None:
        y_acc = y_acc + shl(b.to(torch.int64)[:, None], F8)
    y = assert16(rshift_round(y_acc, F8), "ln y")
    tr["y"] = y
    tr["err_y"] = y_acc + (1 << 7) - shl(y, F8)
    return tr


def q_matmul_rescale(wT: torch.Tensor, x: torch.Tensor,
                     b: Optional[torch.Tensor], shift: int
                     ) -> Dict[str, torch.Tensor]:
    """y = round((wT @ x + 2^8 b) / 2^shift): (n,k)@(k,seq) -> (n,seq)."""
    acc = imatmul(wT, x)
    if b is not None:
        acc = acc + shl(b[:, None], F8)
    y = assert16(rshift_round(acc, shift), "matmul out")
    err = acc + (1 << (shift - 1)) - shl(y, shift)
    lo, hi = _minmax(err)
    assert lo >= 0 and hi < (1 << shift)
    return {"y": y, "err": err}


def score_mult(dh: int) -> int:
    """Public multiplier m ~= 2^9/sqrt(dh): score codes = acc*m >> 12."""
    return int(round((1 << 9) / math.sqrt(dh)))


def q_attention_head(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One head. q,k,v: (dh, seq) f8; mask: (seq, seq) 0/1 (row=query).
    scores -> exp LUT -> division-free softmax -> P @ V."""
    dh, seq = q.shape
    tr: Dict[str, torch.Tensor] = {}
    acc = imatmul(q.T, k)                                   # (seq, seq) f16
    sacc = acc * score_mult(dh)
    sidx = torch.clamp(rshift_round(sacc, 12), -(1 << 15), (1 << 15) - 1)
    tr["err_s"] = torch.clamp(sacc + (1 << 11) - shl(sidx, 12), 0,
                              (1 << 12) - 1)
    tr["sidx"] = sidx
    e, _ = lut_apply("exp", sidx)                           # f=6
    tr["e"] = e
    me = mask * e
    S = me.sum(dim=1)                                       # (seq,)
    assert int(S.min().item()) >= 1, "empty softmax row"
    tr["S"] = S
    # P = round(2^8 me / S): 2^8 me = P S + vres, vres in (-S/2, S/2]
    num = shl(me, SOFTMAX_T)
    Sc = S[:, None]
    P = (num + Sc // 2) // Sc
    vres = num - P * Sc
    P = P - (vres * 2 <= -Sc).long()
    vres = num - P * Sc
    assert bool(((2 * vres > -Sc) & (2 * vres <= Sc)).all().item())
    lo, hi = _minmax(P)
    assert lo >= 0 and hi <= (1 << SOFTMAX_T), "P out of [0, 256]"
    tr["P"] = P
    tr["w1"] = 2 * vres + Sc - 1                            # in [0, 2S)
    tr["w2"] = 2 * Sc - 1 - tr["w1"]
    assert _minmax(tr["w1"])[0] >= 0 and _minmax(tr["w2"])[0] >= 0
    o_acc = imatmul(v, P.T)                                 # (dh, seq) f16
    o = assert16(rshift_round(o_acc, F8), "attention out")
    tr["o"] = o
    tr["err_o"] = o_acc + (1 << 7) - shl(o, F8)
    return tr


ROPE_F = 13   # cos/sin fixed-point bits (products stay < p/2)


def rope_tables(dh: int, seq: int, base: float = 10000.0):
    """Integer cos/sin tables (dh/2, seq) at f=ROPE_F, rotate-half
    convention: numpy int64, computed in float64 exactly as the JAX
    package computes them (they are public circuit constants)."""
    half = dh // 2
    inv_freq = base ** (-np.arange(half) / half)          # (half,)
    ang = inv_freq[:, None] * np.arange(seq)[None, :]     # (half, seq)
    C = np.round(np.cos(ang) * (1 << ROPE_F)).astype(np.int64)
    Sn = np.round(np.sin(ang) * (1 << ROPE_F)).astype(np.int64)
    return C, Sn


def q_rope(x: torch.Tensor, C: torch.Tensor, Sn: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """Rotate-half RoPE on one head, x: (dh, seq) f8; C, Sn on x's device."""
    half = x.shape[0] // 2
    xt, xb = x[:half], x[half:]
    acc = torch.cat([xt * C - xb * Sn, xb * C + xt * Sn], dim=0)
    y = assert16(rshift_round(acc, ROPE_F), "rope out")
    err = acc + (1 << (ROPE_F - 1)) - shl(y, ROPE_F)
    lo, hi = _minmax(err)
    assert lo >= 0 and hi < (1 << ROPE_F)
    return {"y": y, "err": err}


def q_silu_gate(gate_out: torch.Tensor, up: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """LLaMA MLP gate: y = round(silu(gate) * up / 2^8); inputs f8."""
    acc = gate_out * up
    y = assert16(rshift_round(acc, F8), "silu gate out")
    err = acc + (1 << 7) - shl(y, F8)
    return {"y": y, "err": err}


def q_act(name: str, x_acc: torch.Tensor, in_shift: int
          ) -> Dict[str, torch.Tensor]:
    """Activation LUT on a pre-activation accumulator (f=16 -> f_in=12)."""
    idx = rshift_round(x_acc, in_shift)
    err = x_acc + (1 << (in_shift - 1)) - shl(idx, in_shift)
    spec = LUTS.ALL_SPECS[name]
    assert16(idx, f"{name} input (must lie in [{spec.lo}, {spec.hi}))")
    out, _ = lut_apply(name, idx)
    return {"idx": idx, "out": out, "err": err}
