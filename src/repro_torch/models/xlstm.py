"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(mirrors ``repro.models.xlstm``).

mLSTM runs in chunked-parallel form: a loop over chunks of CHUNK tokens
carrying the (dh x dh) matrix memory, the outer products of a chunk
batched into matmuls, the gates in float32.  Its one-token decode step
floors the normaliser at 1.0 where the chunked path floors it at
exp(-m), as the JAX package does (ROADMAP Queue 3, reference faults), so
a cached decode differs from a full forward.  sLSTM is recurrent (a
block-diagonal hidden-to-hidden matrix per head) and runs as a loop over
tokens.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

from .layers import P, ParamDef, ShardCfg

CHUNK = 128
M_INIT = -1e30          # the mLSTM stabiliser before any token


@dataclasses.dataclass(frozen=True)
class XlstmCfg:
    d: int
    heads: int
    kind: str = "mlstm"          # mlstm | slstm

    @property
    def dh(self) -> int:
        return self.d // self.heads


def xlstm_defs(cfg: XlstmCfg, sh: ShardCfg) -> Dict[str, ParamDef]:
    tp = sh.tp if cfg.heads % sh.tp_size == 0 else None
    s = 1.0 / math.sqrt(cfg.d)
    if cfg.kind == "mlstm":
        return {
            "wq": ParamDef((cfg.d, cfg.d), P(sh.fs(cfg.d), tp), s),
            "wk": ParamDef((cfg.d, cfg.d), P(sh.fs(cfg.d), tp), s),
            "wv": ParamDef((cfg.d, cfg.d), P(sh.fs(cfg.d), tp), s),
            "wi": ParamDef((cfg.d, cfg.heads), P(sh.fs(cfg.d), tp), s),
            "wf": ParamDef((cfg.d, cfg.heads), P(sh.fs(cfg.d), tp), s),
            "bf": ParamDef((cfg.heads,), P(tp), zero=True),
            "wo": ParamDef((cfg.d, cfg.d), P(tp, sh.fs(cfg.d)), s),
            "ogate": ParamDef((cfg.d, cfg.d), P(sh.fs(cfg.d), tp), s),
        }
    return {
        "wz": ParamDef((cfg.d, cfg.d), P(sh.fs(cfg.d), tp), s),
        "wi": ParamDef((cfg.d, cfg.d), P(sh.fs(cfg.d), tp), s),
        "wf": ParamDef((cfg.d, cfg.d), P(sh.fs(cfg.d), tp), s),
        "wog": ParamDef((cfg.d, cfg.d), P(sh.fs(cfg.d), tp), s),
        # block-diagonal recurrent weights: per head (dh x dh)
        "rz": ParamDef((cfg.heads, cfg.dh, cfg.dh), P(tp, None, None), 0.1),
        "ri": ParamDef((cfg.heads, cfg.dh, cfg.dh), P(tp, None, None), 0.1),
        "rf": ParamDef((cfg.heads, cfg.dh, cfg.dh), P(tp, None, None), 0.1),
        "rog": ParamDef((cfg.heads, cfg.dh, cfg.dh), P(tp, None, None), 0.1),
        "bf": ParamDef((cfg.d,), P(tp), zero=True),
        "wo": ParamDef((cfg.d, cfg.d), P(tp, sh.fs(cfg.d)), s),
    }


def _mlstm_chunk(Cm, n, m, q, k, v, li, lf):
    """One chunk.  State: Cm (B,H,dh,dh), n (B,H,dh), m (B,H); q, k, v
    (B,L,H,dh); li, lf (B,L,H), the gates in log space.  Returns the new
    state and y (B,L,H,dh)."""
    L = q.shape[1]
    F_ = torch.cumsum(lf, dim=1)                             # (B,L,H)
    # stabiliser: m' = max(m + F_total, max_t(li + F_total - F_t))
    Ftot = F_[:, -1]
    a = li + (Ftot[:, None] - F_)
    m_new = torch.maximum(m + Ftot, torch.max(a, dim=1).values)
    carry_scale = torch.exp(m + Ftot - m_new)                # (B,H)
    w = torch.exp(a - m_new[:, None])                        # (B,L,H)
    kw = k * w[..., None]
    C_new = Cm * carry_scale[..., None, None] + \
        torch.einsum("blhd,blhe->bhde", kw, v)
    n_new = n * carry_scale[..., None] + torch.sum(kw, dim=1)
    # outputs per position: the prefix state plus the causal part in-chunk
    mq = torch.maximum(m[:, None] + F_,
                       torch.cummax(li + F_, dim=1).values)  # (B,L,H)
    pre_scale = torch.exp(m[:, None] + F_ - mq)
    y_pre = torch.einsum("blhd,bhde->blhe", q, Cm) * pre_scale[..., None]
    n_pre = torch.einsum("blhd,bhd->blh", q, n) * pre_scale
    # position t attends s <= t with weight exp(li_s + F_t - F_s - mq_t)
    wmat = li[:, None, :, :] + (F_[:, :, None, :] - F_[:, None, :, :]) \
        - mq[:, :, None, :]                                  # (B,t,s,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    wmat = torch.where(causal[None, :, :, None], torch.exp(wmat),
                       torch.zeros((), dtype=wmat.dtype, device=q.device))
    scores = torch.einsum("bthd,bshd->btsh", q, k) * wmat
    y_intra = torch.einsum("btsh,bshe->bthe", scores, v)
    n_intra = torch.sum(scores, dim=2)
    y = y_pre + y_intra
    nq = n_pre + n_intra
    denom = torch.maximum(torch.abs(nq), torch.exp(-mq))
    return C_new, n_new, m_new, y / denom[..., None]


def mlstm(cfg: XlstmCfg, sh: ShardCfg, p, x: torch.Tensor,
          cache: Optional[Dict] = None
          ) -> Tuple[torch.Tensor, Optional[Dict]]:
    B, S, D = x.shape
    H, dh = cfg.heads, cfg.dh
    q = torch.matmul(x, p["wq"].to(x.dtype))
    k = torch.matmul(x, p["wk"].to(x.dtype)) / math.sqrt(dh)
    v = torch.matmul(x, p["wv"].to(x.dtype))
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, H, dh)
    v = v.reshape(B, S, H, dh)
    li = torch.matmul(x, p["wi"].to(x.dtype)).float()
    lf = F.logsigmoid(torch.matmul(x, p["wf"].to(x.dtype)).float()
                      + p["bf"].float())
    qf, kf, vf = q.float(), k.float(), v.float()

    if cache is not None and S == 1:
        Cm, n, m = cache["C"], cache["n"], cache["m"]
        li0, lf0 = li[:, 0], lf[:, 0]
        m_new = torch.maximum(m + lf0, li0)
        Cs = torch.exp(m + lf0 - m_new)
        iw = torch.exp(li0 - m_new)
        C_new = Cm * Cs[..., None, None] + \
            torch.einsum("bhd,bhe->bhde", kf[:, 0] * iw[..., None], vf[:, 0])
        n_new = n * Cs[..., None] + kf[:, 0] * iw[..., None]
        y = torch.einsum("bhd,bhde->bhe", qf[:, 0], C_new)
        nq = torch.einsum("bhd,bhd->bh", qf[:, 0], n_new)
        # the reference's decode floor (1.0, not the chunked path's exp(-m))
        y = y / torch.clamp(torch.abs(nq), min=1.0)[..., None]
        y = y[:, None]
        new_cache = {"C": C_new, "n": n_new, "m": m_new}
    else:
        L = min(CHUNK, S)
        if S % L:
            raise ValueError(f"sequence {S} is not a multiple of the chunk "
                             f"{L}")
        if cache is not None:
            Cm, n, m = cache["C"], cache["n"], cache["m"]
        else:
            Cm = torch.zeros((B, H, dh, dh), dtype=torch.float32,
                             device=x.device)
            n = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
            m = torch.full((B, H), M_INIT, dtype=torch.float32,
                           device=x.device)
        ys = []
        for c0 in range(0, S, L):
            sl = slice(c0, c0 + L)
            Cm, n, m, yc = _mlstm_chunk(Cm, n, m, qf[:, sl], kf[:, sl],
                                        vf[:, sl], li[:, sl], lf[:, sl])
            ys.append(yc)
        y = torch.cat(ys, dim=1)
        new_cache = {"C": Cm, "n": n, "m": m} if cache is not None else None
    og = torch.sigmoid(torch.matmul(x, p["ogate"].to(x.dtype)))
    y = y.reshape(B, S, D).to(x.dtype) * og
    return torch.matmul(y, p["wo"].to(x.dtype)), new_cache


def slstm(cfg: XlstmCfg, sh: ShardCfg, p, x: torch.Tensor,
          cache: Optional[Dict] = None
          ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Scalar-memory LSTM with exponential gating; a loop over tokens."""
    B, S, D = x.shape
    H, dh = cfg.heads, cfg.dh
    pre = {g: torch.matmul(x, p[w].to(x.dtype)).float()
           for g, w in (("z", "wz"), ("i", "wi"), ("f", "wf"), ("o", "wog"))}
    pre["f"] = pre["f"] + p["bf"].float()
    pre = {g: t.reshape(B, S, H, dh) for g, t in pre.items()}
    R = {g: p[r].float()
         for g, r in (("z", "rz"), ("i", "ri"), ("f", "rf"), ("o", "rog"))}

    if cache is not None:
        c, n, h, m = cache["c"], cache["n"], cache["h"], cache["m"]
    else:
        c = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        n, h, m = torch.ones_like(c), c, torch.zeros_like(c)
    hs = []
    for t in range(S):
        def rec(g):
            return torch.einsum("bhd,hde->bhe", h, R[g])
        zt = torch.tanh(pre["z"][:, t] + rec("z"))
        it = pre["i"][:, t] + rec("i")
        ft = pre["f"][:, t] + rec("f")
        ot = torch.sigmoid(pre["o"][:, t] + rec("o"))
        lf = F.logsigmoid(ft)
        m_new = torch.maximum(lf + m, it)
        ig = torch.exp(it - m_new)
        fg = torch.exp(lf + m - m_new)
        c = fg * c + ig * zt
        n = torch.maximum(fg * n + ig, torch.exp(-m_new))
        h = ot * (c / n)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    out = torch.matmul(y, p["wo"].to(x.dtype))
    new_cache = {"c": c, "n": n, "h": h, "m": m} if cache is not None \
        else None
    return out, new_cache


def make_xlstm_cache(cfg: XlstmCfg, batch: int, device=None) -> Dict:
    dev = resolve_device(device)
    H, dh = cfg.heads, cfg.dh
    if cfg.kind == "mlstm":
        return {"C": torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                                 device=dev),
                "n": torch.zeros((batch, H, dh), dtype=torch.float32,
                                 device=dev),
                "m": torch.full((batch, H), M_INIT, dtype=torch.float32,
                                device=dev)}
    z = torch.zeros((batch, H, dh), dtype=torch.float32, device=dev)
    return {"c": z, "n": torch.ones_like(z), "h": z.clone(),
            "m": torch.zeros_like(z)}
