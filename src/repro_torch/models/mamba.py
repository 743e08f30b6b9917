"""Mamba (S6) selective-state-space block for the jamba hybrid (mirrors
``repro.models.mamba``).

The selective scan runs chunked: a loop over chunks of CHUNK tokens
carrying the (d_inner, d_state) state, and inside a chunk a log-step
doubling scan (Hillis-Steele: 8 steps at CHUNK = 256) over the chunk's
(a, b x) pairs, where the JAX package calls ``jax.lax.associative_scan``
(PyTorch has none).  Both compose the same linear recurrences; the order
of their products differs, so the two agree to the dtype's rounding, not
bit for bit.  Decode is one fused state update (the cache holds the SSM
state and the causal conv's tail).

Dtypes follow the JAX package: the state and a = exp(dt A) are in the
activations' dtype, and the cache's state in the config's dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

from .layers import P, ParamDef, ShardCfg

CHUNK = 256


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d: int
    d_inner: int                 # typically 2*d
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0             # 0 -> ceil(d/16)

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d // 16)


def mamba_defs(cfg: MambaCfg, sh: ShardCfg) -> Dict[str, ParamDef]:
    tp = sh.tp if cfg.d_inner % sh.tp_size == 0 else None
    s = 1.0 / math.sqrt(cfg.d)
    si = 1.0 / math.sqrt(cfg.d_inner)
    return {
        "in_proj": ParamDef((cfg.d, 2 * cfg.d_inner),
                            P(sh.fs(cfg.d), tp), s),
        "conv_w": ParamDef((cfg.d_conv, cfg.d_inner), P(None, tp), 0.2),
        "conv_b": ParamDef((cfg.d_inner,), P(tp), zero=True),
        "x_proj": ParamDef((cfg.d_inner, cfg.rank + 2 * cfg.d_state),
                           P(tp, None), si),
        "dt_proj": ParamDef((cfg.rank, cfg.d_inner), P(None, tp), 0.1),
        "dt_bias": ParamDef((cfg.d_inner,), P(tp), zero=True),
        "A_log": ParamDef((cfg.d_inner, cfg.d_state), P(tp, None), 0.5),
        "D": ParamDef((cfg.d_inner,), P(tp), zero=True),
        "out_proj": ParamDef((cfg.d_inner, cfg.d),
                             P(tp, sh.fs(cfg.d)), si),
    }


def _doubling_scan(a: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the pairs (a_t, b_t) under
    (l, r) -> (l.a r.a, l.b r.a + r.b), in ceil(log2 L) steps: after the
    step of stride s, entry t holds the composition of entries
    t-2s+1 .. t."""
    L = a.shape[1]
    s = 1
    while s < L:
        a_prev, b_prev = a[:, :-s], b[:, :-s]
        b = torch.cat([b[:, :s], b_prev * a[:, s:] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a_prev * a[:, s:]], dim=1)
        s *= 2
    return a, b


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (B, S, dI); A: (dI, dS); Bc, Cc: (B, S, dS); S a multiple of
    min(CHUNK, S).  The scan starts from a zero state.  Returns (y (B, S,
    dI), h_final (B, dI, dS))."""
    Bn, S, dI = x.shape
    dS = A.shape[-1]
    h = torch.zeros((Bn, dI, dS), dtype=x.dtype, device=x.device)
    L = min(CHUNK, S)
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {L}")
    a = torch.exp(dt[..., None] * A[None, None])             # (B, S, dI, dS)
    bx = (dt * x)[..., None] * Bc[:, :, None, :]
    ys = []
    for c0 in range(0, S, L):
        a_cum, h_in = _doubling_scan(a[:, c0:c0 + L], bx[:, c0:c0 + L])
        h_all = h_in + a_cum * h[:, None]
        ys.append(torch.einsum("blds,bls->bld", h_all, Cc[:, c0:c0 + L]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def mamba(cfg: MambaCfg, sh: ShardCfg, p, x: torch.Tensor,
          cache: Optional[Dict] = None
          ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d).  cache (decode): {'h': (B, dI, dS), 'conv': (B,
    d_conv-1, dI)}.  A prefill through a cache starts its scan from a zero
    state and takes the conv tail from the cache, as the JAX package's
    does."""
    Bn, S, D = x.shape
    dI, dS, dC = cfg.d_inner, cfg.d_state, cfg.d_conv
    xz = torch.matmul(x, p["in_proj"].to(x.dtype))
    xi, z = torch.chunk(xz, 2, dim=-1)

    # causal depthwise conv along the sequence
    if cache is not None:
        xin = torch.cat([cache["conv"], xi], dim=1)
    else:
        xin = F.pad(xi, (0, 0, dC - 1, 0))
    new_tail = xin[:, -(dC - 1):, :]
    xc = xin[:, 0:S, :] * p["conv_w"][0].to(x.dtype)
    for i in range(1, dC):
        xc = xc + xin[:, i:i + S, :] * p["conv_w"][i].to(x.dtype)
    xc = F.silu(xc + p["conv_b"].to(x.dtype))

    proj = torch.matmul(xc, p["x_proj"].to(x.dtype))
    dt_in, Bc, Cc = torch.split(proj, [cfg.rank, dS, dS], dim=-1)
    dt = F.softplus(torch.matmul(dt_in, p["dt_proj"].to(x.dtype))
                    + p["dt_bias"].to(x.dtype))
    A = (-torch.exp(p["A_log"].float())).to(x.dtype)

    if cache is not None and S == 1:
        # fused single-step update
        a = torch.exp(dt[:, 0, :, None] * A[None])
        h = a * cache["h"] + (dt[:, 0] * xc[:, 0])[..., None] * \
            Bc[:, 0, None, :]
        y = torch.einsum("bds,bs->bd", h, Cc[:, 0])[:, None, :]
        new_cache = {"h": h, "conv": new_tail}
    else:
        pad = (-S) % min(CHUNK, max(S, 1))
        if pad:
            xc2, dt2, Bc2, Cc2 = (F.pad(t, (0, 0, 0, pad))
                                  for t in (xc, dt, Bc, Cc))
        else:
            xc2, dt2, Bc2, Cc2 = xc, dt, Bc, Cc
        y, hf = selective_scan(xc2, dt2, A, Bc2, Cc2)
        y = y[:, :S]
        new_cache = {"h": hf, "conv": new_tail} if cache is not None else None
    y = y + xc * p["D"].to(x.dtype)
    y = y * F.silu(z)
    return torch.matmul(y, p["out_proj"].to(x.dtype)), new_cache


def make_mamba_cache(cfg: MambaCfg, batch: int, dtype=torch.bfloat16,
                     device=None) -> Dict:
    dev = resolve_device(device)
    return {"h": torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=dtype,
                             device=dev),
            "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                dtype=dtype, device=dev)}
