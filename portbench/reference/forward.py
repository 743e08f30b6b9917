"""The quantized transformer block, in plain PyTorch on int64 tensors.

Activations are signed 16-bit fixed point with 8 fractional bits,
feature-major (d_pad, seq), padded rows zero.  Rounding is round-half-up,
an arithmetic shift: round(x / 2^s) = (x + 2^(s-1)) >> s.  Two families:

* ``gpt2``: LayerNorm, learned biases, GELU MLP;
* ``llama``: RMSNorm, rotate-half RoPE, grouped-query attention,
  SiLU-gated MLP, no biases.

Norms take the mean square through an rsqrt table, attention scores go
through an exp table and a division-free softmax with 8-bit
probabilities; the tables have 2^16 entries built in float64 on the host.

Integer matrix products are exact: every partial sum is an integer below
2^53, so they run in float64.  ``matmul`` names a lower precision for the
benchmark's control: ``float32`` (exact while every partial sum stays
below 2^24), ``tf32`` (operands rounded to TF32's 10-bit mantissa,
float32 sums: what a float32 product on the card computes once TF32 is
allowed) or ``bfloat16``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch

F8 = 8
ROPE_F = 13
LUT_SIZE = 1 << 16
# name: (domain start, input fractional bits, output fractional bits)
LUTS = {"exp": (-4.0, 13, 6), "gelu": (-8.0, 12, 8), "silu": (-8.0, 12, 8),
        "rsqrt": (0.0, 12, 11)}


def _erf(x):
    try:
        from scipy.special import erf
        return erf(x)
    except ImportError:
        return np.vectorize(math.erf)(np.asarray(x, dtype=np.float64))


def _lut_fn(name: str, x: np.ndarray) -> np.ndarray:
    if name == "exp":
        return np.exp(x)
    if name == "gelu":
        return 0.5 * x * (1.0 + _erf(x / np.sqrt(2.0)))
    if name == "silu":
        return x / (1.0 + np.exp(-x))
    return 1.0 / np.sqrt(np.maximum(x, 0.01))          # rsqrt, clamped


@functools.lru_cache(maxsize=None)
def lut_np(name: str) -> np.ndarray:
    lo, f_in, f_out = LUTS[name]
    x = lo + np.arange(LUT_SIZE, dtype=np.float64) * 2.0 ** (-f_in)
    return np.round(_lut_fn(name, x) * (1 << f_out)).astype(np.int64
                                                           ).astype(np.int32)


def lookup(name: str, code: torch.Tensor) -> torch.Tensor:
    lo, f_in, _ = LUTS[name]
    table = torch.as_tensor(lut_np(name).astype(np.int64), device=code.device)
    return table[code - int(round(lo * (1 << f_in)))]


def rshift_round(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x + (1 << (s - 1))) >> s


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def imatmul(a: torch.Tensor, b: torch.Tensor, matmul: str) -> torch.Tensor:
    if matmul == "float64":
        return torch.matmul(a.double(), b.double()).round().long()
    if matmul == "bfloat16":
        return torch.matmul(a.bfloat16(), b.bfloat16()).double().round().long()
    a, b = a.float(), b.float()
    if matmul == "tf32":
        a, b = _tf32(a), _tf32(b)
    elif matmul != "float32":
        raise ValueError(f"unknown matmul precision {matmul!r}")
    return torch.matmul(a, b).double().round().long()


def _norm(cfg: Dict, x, g, b):
    d = cfg["d"]
    if cfg["family"] == "gpt2":
        s1 = x.sum(dim=0)
        mu = (s1 + d // 2) // d
        x = x - mu[None, :]
        x[d:, :] = 0
    sq = (x * x).sum(dim=0)
    D = d << 4
    rst = lookup("rsqrt", (sq + D // 2) // D)
    xn = rshift_round(x * rst[None, :], 11)
    y = xn * g[:, None]
    if b is not None:
        y = y + (b[:, None] << F8)
    return rshift_round(y, F8)


def _proj(w, x, b, matmul):
    acc = imatmul(w, x, matmul)
    if b is not None:
        acc = acc + (b[:, None] << F8)
    return rshift_round(acc, F8)


def rope_tables(dh: int, seq: int, base: float = 10000.0):
    half = dh // 2
    ang = (base ** (-np.arange(half) / half))[:, None] * np.arange(seq)[None, :]
    return (np.round(np.cos(ang) * (1 << ROPE_F)).astype(np.int64),
            np.round(np.sin(ang) * (1 << ROPE_F)).astype(np.int64))


def _rope(x, heads: int, dh: int, C, S):
    """Rotate-half RoPE on the first heads * dh rows of x (per head)."""
    seq = x.shape[1]
    xh = x[:heads * dh].reshape(heads, dh, seq)
    half = dh // 2
    t, b = xh[:, :half], xh[:, half:]
    acc = torch.cat([t * C - b * S, b * C + t * S], dim=1)
    out = torch.zeros_like(x)
    out[:heads * dh] = rshift_round(acc, ROPE_F).reshape(heads * dh, seq)
    return out


def score_mult(dh: int) -> int:
    return int(round((1 << 9) / math.sqrt(dh)))


def _attention(cfg: Dict, q, k, v, matmul):
    H, KV, dh = cfg["heads"], cfg["kv_heads"], cfg["dh"]
    seq = q.shape[1]
    group = H // KV
    qh = q[:H * dh].reshape(H, dh, seq)
    kh = k[:KV * dh].reshape(KV, dh, seq).repeat_interleave(group, dim=0)
    vh = v[:KV * dh].reshape(KV, dh, seq).repeat_interleave(group, dim=0)
    acc = imatmul(qh.transpose(1, 2), kh, matmul)              # (H, seq, seq)
    sidx = torch.clamp(rshift_round(acc * score_mult(dh), 12),
                       -(1 << 15), (1 << 15) - 1)
    mask = torch.tril(torch.ones((seq, seq), dtype=torch.int64,
                                 device=q.device))
    me = mask * lookup("exp", sidx)
    S = me.sum(dim=2, keepdim=True)
    num = me << 8
    Pm = (num + S // 2) // S
    Pm = Pm - (((num - Pm * S) * 2) <= -S).long()
    o = rshift_round(imatmul(vh, Pm.transpose(1, 2), matmul), F8)  # (H, dh, seq)
    out = torch.zeros((cfg["qd_pad"], seq), dtype=torch.int64, device=q.device)
    out[:H * dh] = o.reshape(H * dh, seq)
    return out


def block_forward(cfg: Dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
                  matmul: str = "float64") -> torch.Tensor:
    """One block: x (d_pad, seq) int64 -> y (d_pad, seq) int64.  ``cfg``
    holds family, d, dff, heads, kv_heads, dh and the padded widths
    d_pad, qd_pad."""
    gpt2 = cfg["family"] == "gpt2"
    y1 = _norm(cfg, x, w["g1"], w.get("be1"))
    q = _proj(w["wqT"], y1, w.get("bq"), matmul)
    k = _proj(w["wkT"], y1, w.get("bk"), matmul)
    v = _proj(w["wvT"], y1, w.get("bv"), matmul)
    if not gpt2:
        C, S = (torch.as_tensor(t, device=x.device)
                for t in rope_tables(cfg["dh"], x.shape[1]))
        q = _rope(q, cfg["heads"], cfg["dh"], C, S)
        k = _rope(k, cfg["kv_heads"], cfg["dh"], C, S)
    O = _attention(cfg, q, k, v, matmul)
    hmid = x + _proj(w["woT"], O, w.get("bo"), matmul)
    y2 = _norm(cfg, hmid, w["g2"], w.get("be2"))
    acc1 = imatmul(w["w1T"], y2, matmul)
    if gpt2:
        acc1 = acc1 + (w["b1f"][:, None] << F8)
    mid = lookup("gelu" if gpt2 else "silu", rshift_round(acc1, 4))
    if not gpt2:
        up = rshift_round(imatmul(w["w3T"], y2, matmul), F8)
        mid = rshift_round(mid * up, F8)
    return hmid + _proj(w["w2T"], mid, w.get("b2f"), matmul)


def chain_forward(cfg: Dict, weights, x: np.ndarray, device,
                  matmul: str = "float64"):
    """h_0 .. h_L of one query as numpy int64 arrays."""
    h = torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)
    acts = [h.cpu().numpy()]
    for w in weights:
        wt = {k: torch.as_tensor(v, device=device) for k, v in w.items()}
        h = block_forward(cfg, wt, h, matmul)
        acts.append(h.cpu().numpy())
    return acts
