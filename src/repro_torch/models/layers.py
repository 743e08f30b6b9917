"""Layer library of the float serving path (mirrors ``repro.models.layers``).

Every layer takes an explicit parameter dict of tensors.  The JAX package
describes how each tensor maps onto a TPU mesh (``ShardCfg``, partition
specs, ``cstr``); the port runs on one card, so ``cstr`` is the identity.
The specs (``param_specs``) are what the dry run divides each tensor's
dimensions by to get its bytes on one device of a mesh
(``launch/dryrun.py``); ``param_shapes`` gives the same tree as ``meta``
tensors.

The LUT-approximated deployed model (paper §4) is reached with
``use_lut=True``: softmax-exp, GELU/SiLU and rsqrt go through
``core.luts``'s float path.  Attention follows the JAX package's
einsum/softmax form (no fused attention kernel: the LUT softmax is not
SDPA's, and the plain and LUT paths share one formulation).

The MoE keeps the JAX package's capacity rule and both dispatches; its
sort dispatch sorts with ``argsort(stable=True)`` and combines each
token's K expert outputs without atomics (``_combine``), so that a run on
the card gives the same bits every time.

The sequence-sharded decode cache (``ShardCfg.cache_seq``) changes only
which op writes a decode step's key and value, as in the JAX package: see
``attention``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import luts as LUTS
from repro_torch.device import resolve_device

DTYPE = torch.bfloat16
MASKED = -1e30          # score of a masked key (float32), as in the JAX package
MASKED_BELOW = -1e29    # the LUT softmax's test for a masked key


# ---------------------------------------------------------------------------
# Sharding configuration: the specs the dry run divides by.
# ---------------------------------------------------------------------------
def P(*axes) -> Tuple:
    """A partition spec, as a tuple of mesh-axis names (or None) per dim."""
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class ShardCfg:
    dp: Tuple[str, ...] = ("pod", "data")   # batch / FSDP axes
    tp: str = "model"
    tp_size: int = 16
    dp_size: int = 32
    attn_tp: bool = True
    kv_tp: bool = False
    moe_ep: bool = True          # experts sharded over tp axis
    fsdp: bool = True            # shard weight d_in over dp axes
    cache_seq: Tuple[str, ...] = ()
    cache_seq_size: int = 1      # product of cache_seq axis sizes
    batch_dp: bool = True        # batch shardable over dp (False if B=1)

    def fs(self, dim: int):
        """FSDP axes for a weight's d_in dimension (None if indivisible)."""
        if not self.fsdp:
            return None
        return self.dp if dim % self.dp_size == 0 else None

    @property
    def bdp(self):
        """The batch dimension's axes (None where the batch is replicated)."""
        return self.dp if self.batch_dp else None


def cstr(x: torch.Tensor, spec) -> torch.Tensor:
    """The JAX package's sharding constraint: the identity on one device."""
    return x


@dataclasses.dataclass
class ParamDef:
    shape: Tuple[int, ...]
    spec: Tuple
    init_scale: float = 0.02
    dtype: Any = DTYPE
    zero: bool = False


def tree_map_defs(fn, defs):
    """Apply ``fn`` to every ParamDef of a nested dict/list tree."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, dict):
        return {k: tree_map_defs(fn, v) for k, v in defs.items()}
    if isinstance(defs, (list, tuple)):
        return type(defs)(tree_map_defs(fn, v) for v in defs)
    return defs


def param_specs(defs):
    """The tree of partition specs, one tuple per parameter."""
    return tree_map_defs(lambda d: d.spec, defs)


def param_shapes(defs):
    """The tree of parameters as ``meta`` tensors (shape and dtype, no
    data): the counterpart of the JAX package's ``jax.ShapeDtypeStruct``
    tree."""
    return tree_map_defs(
        lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def init_params(defs, gen: torch.Generator, device=None):
    """Random parameters: N(0, init_scale^2) drawn in float32 from ``gen``
    (on the generator's device) and cast to each def's dtype; zeros where
    a def says so.  The draws are the port's own, not JAX's: weights cross
    from the JAX package by ``model.params_from_numpy``."""
    dev = resolve_device(device)

    def one(d: ParamDef) -> torch.Tensor:
        if d.zero:
            return torch.zeros(d.shape, dtype=d.dtype, device=dev)
        w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * d.init_scale
        return w.to(device=dev, dtype=d.dtype)
    return tree_map_defs(one, defs)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6,
            use_lut: bool = False) -> torch.Tensor:
    ms = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    r = LUTS.apply("rsqrt", ms + eps) if use_lut else torch.rsqrt(ms + eps)
    return (x.float() * r).to(x.dtype) * (1.0 + g)


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5, use_lut: bool = False) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    r = LUTS.apply("rsqrt", var + eps) if use_lut else torch.rsqrt(var + eps)
    return ((xf - mu) * r).to(x.dtype) * g + b


def norm_defs(kind: str, d: int) -> Dict[str, ParamDef]:
    if kind == "rmsnorm":
        return {"g": ParamDef((d,), P(None), zero=True)}
    return {"g": ParamDef((d,), P(None), zero=True),
            "b": ParamDef((d,), P(None), zero=True)}


def apply_norm(kind: str, p, x, use_lut=False):
    if kind == "rmsnorm":
        return rmsnorm(x, p["g"], use_lut=use_lut)
    return layernorm(x, 1.0 + p["g"], p["b"], use_lut=use_lut)


# ---------------------------------------------------------------------------
# Rotary embeddings.
# ---------------------------------------------------------------------------
def rope_freqs(dh: int, base: float = 1e6, device=None) -> torch.Tensor:
    half = dh // 2
    return base ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 1e6) -> torch.Tensor:
    """x: (..., seq, heads, dh); positions: (..., seq) int."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, base, x.device)
    return _rotate(x, positions[..., None].float() * inv)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate x's two halves by the angles ang (..., seq, dh/2), in
    float32, broadcast over the heads."""
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Optional[Tuple[int, int, int]] = None,
                base: float = 1e6) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the dh/2 frequencies split into (t, h, w)
    sections, each rotated by its own position stream.

    x: (..., seq, heads, dh); positions3: (3, ..., seq).  The default
    sections are qwen2-vl's 2:3:3 split (16, 24, 24 at dh=128) scaled to
    dh: dh//8, then two equal halves of the rest."""
    dh = x.shape[-1]
    if sections is None:
        t = dh // 8
        hw = (dh // 2 - t) // 2
        sections = (dh // 2 - 2 * hw, hw, hw)
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {sections} must cover dh/2 = "
                         f"{dh // 2}")
    inv = rope_freqs(dh, base, x.device)                     # (dh/2,)
    edges = [0, sections[0], sections[0] + sections[1], dh // 2]
    ang = torch.cat([positions3[i][..., None].float() *
                     inv[edges[i]:edges[i + 1]] for i in range(3)], dim=-1)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# Attention (GQA, optional local window, logit softcap, cross-attention).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d: int
    heads: int
    kv_heads: int
    dh: int
    qkv_bias: bool = False
    rope: str = "none"           # none | rope | mrope
    rope_base: float = 1e6
    window: int = 0              # 0 = global causal; >0 = sliding window
    causal: bool = True          # False for encoder self-attention
    softcap: float = 0.0


def attn_defs(cfg: AttnCfg, sh: ShardCfg) -> Dict[str, ParamDef]:
    tp = sh.tp if cfg.heads % sh.tp_size == 0 and sh.attn_tp else None
    kv_tp = sh.tp if cfg.kv_heads % sh.tp_size == 0 and sh.attn_tp else None
    qd, kvd = cfg.heads * cfg.dh, cfg.kv_heads * cfg.dh
    scale = 1.0 / math.sqrt(cfg.d)
    defs = {
        "wq": ParamDef((cfg.d, qd), P(sh.fs(cfg.d), tp), scale),
        "wk": ParamDef((cfg.d, kvd), P(sh.fs(cfg.d), kv_tp), scale),
        "wv": ParamDef((cfg.d, kvd), P(sh.fs(cfg.d), kv_tp), scale),
        "wo": ParamDef((qd, cfg.d), P(tp, sh.fs(cfg.d)), scale),
    }
    if cfg.qkv_bias:
        defs.update({"bq": ParamDef((qd,), P(tp), zero=True),
                     "bk": ParamDef((kvd,), P(kv_tp), zero=True),
                     "bv": ParamDef((kvd,), P(kv_tp), zero=True)})
    return defs


def _softmax(scores: torch.Tensor, use_lut: bool) -> torch.Tensor:
    if not use_lut:
        return torch.softmax(scores, dim=-1)
    # deployed LUT path (paper §4): in-range scores clamp to the exp
    # table's domain; masked positions are exactly zero (the circuit's
    # public-mask semantics, M * e)
    masked = scores < MASKED_BELOW
    s = torch.clamp(scores, LUTS.EXP.lo, LUTS.EXP.hi - 2.0 ** -LUTS.EXP.f_in)
    e = torch.where(masked, torch.zeros((), dtype=scores.dtype,
                                        device=scores.device),
                    LUTS.apply("exp", s))
    return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)


def _softcap(cfg: AttnCfg, scores: torch.Tensor) -> torch.Tensor:
    if cfg.softcap > 0:
        return cfg.softcap * torch.tanh(scores / cfg.softcap)
    return scores


def _banded_attention(cfg: AttnCfg, sh: ShardCfg, q, kq, vq, positions,
                      use_lut: bool):
    """Sliding-window attention in banded O(S * 2W) form: queries in chunks
    of W, chunk i attending the keys of chunks i-1 and i (exact for a
    window <= W)."""
    B, S, H, dh = q.shape
    W = cfg.window
    nc = S // W
    dev = q.device
    qc = q.reshape(B, nc, W, H, dh)
    kpad = torch.nn.functional.pad(kq, (0, 0, 0, 0, W, 0))
    vpad = torch.nn.functional.pad(vq, (0, 0, 0, 0, W, 0))
    win_idx = (torch.arange(nc, device=dev)[:, None] * W +
               torch.arange(2 * W, device=dev)[None, :])  # (nc, 2W)
    kc = kpad[:, win_idx]                                  # (B, nc, 2W, H, dh)
    vc = vpad[:, win_idx]
    scores = torch.einsum("bcqhd,bckhd->bchqk", qc, kc) / math.sqrt(dh)
    scores = _softcap(cfg, scores)
    q_pos = (torch.arange(nc, device=dev)[:, None] * W +
             torch.arange(W, device=dev)[None])            # (nc, W)
    k_pos = win_idx - W                                    # (nc, 2W)
    valid = (k_pos[:, None, :] >= 0) & \
            (k_pos[:, None, :] <= q_pos[:, :, None]) & \
            (k_pos[:, None, :] > q_pos[:, :, None] - W)
    scores = torch.where(valid[None, :, None, :, :], scores.float(),
                         MASKED)
    probs = _softmax(scores, use_lut).to(q.dtype)
    out = torch.einsum("bchqk,bckhd->bcqhd", probs, vc)
    return out.reshape(B, S, H, dh)


def attention(cfg: AttnCfg, sh: ShardCfg, p, x: torch.Tensor,
              positions: torch.Tensor, use_lut: bool = False,
              kv_cache: Optional[Dict] = None,
              x_kv: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (batch, seq, d).  kv_cache: {'k', 'v', 'len'} for decode, 'len' a
    Python int (a decode step never waits on a device read); the cache's
    k/v tensors are updated in place and returned in the new cache.
    Writing a step's keys and values follows the JAX package: a
    ``lax.dynamic_update_slice`` at the slot, its start clamped to
    cap - S, except for one token into a sequence-sharded cache
    (``sh.cache_seq``, cap divisible by ``sh.cache_seq_size``), which the
    JAX package inserts by a masked ``where`` that matches no slot once a
    plain cache is full (len >= cap): then nothing is written.
    x_kv: the encoder's states for cross-attention (whisper's decoder):
    keys and values come from them, every key is visible, and there is no
    cache."""
    B, S, D = x.shape
    H, KV, dh = cfg.heads, cfg.kv_heads, cfg.dh
    dev = x.device

    src = x if x_kv is None else x_kv
    q = torch.matmul(x, p["wq"].to(x.dtype))
    k = torch.matmul(src, p["wk"].to(x.dtype))
    v = torch.matmul(src, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, src.shape[1], KV, dh)
    v = v.reshape(B, src.shape[1], KV, dh)

    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_base)
        k = apply_rope(k, positions, cfg.rope_base)
    elif cfg.rope == "mrope":
        # text-only positions: the three streams are equal
        pos3 = positions[None].expand((3,) + tuple(positions.shape))
        q = apply_mrope(q, pos3, base=cfg.rope_base)
        k = apply_mrope(k, pos3, base=cfg.rope_base)

    new_cache = None
    cache_is_ring = False
    if kv_cache is not None:
        # decode: append this step's k/v (a ring buffer if windowed)
        ck, cv, clen = kv_cache["k"], kv_cache["v"], int(kv_cache["len"])
        cap = ck.shape[1]
        slot = clen % cap if cfg.window > 0 and cap < 10 ** 9 else clen
        cache_is_ring = cfg.window > 0
        if S > cap:
            raise ValueError(f"{S} new keys do not fit a cache of {cap}")
        seq_sharded = bool(sh.cache_seq) and cap % sh.cache_seq_size == 0
        if S == 1 and seq_sharded:
            if slot < cap:               # the masked insert's one hit
                ck[:, slot:slot + 1] = k
                cv[:, slot:slot + 1] = v
        else:
            start = min(slot, cap - S)   # lax.dynamic_update_slice's clamp
            ck[:, start:start + S] = k
            cv[:, start:start + S] = v
        new_cache = {"k": ck, "v": cv, "len": clen + S}
        k, v = ck, cv

    group = H // KV
    kq = k.repeat_interleave(group, dim=2)
    vq = v.repeat_interleave(group, dim=2)

    if (cfg.window > 0 and kv_cache is None and x_kv is None and cfg.causal
            and S > 2 * cfg.window and S % cfg.window == 0
            and positions.ndim == 1):
        out = _banded_attention(cfg, sh, q, kq, vq, positions, use_lut)
        out = out.reshape(B, S, H * dh)
        return torch.matmul(out, p["wo"].to(x.dtype)), None

    scores = torch.einsum("bqhd,bkhd->bhqk", q, kq) / math.sqrt(dh)
    scores = _softcap(cfg, scores)

    Sk = kq.shape[1]
    ar = torch.arange(Sk, device=dev)
    q_pos = positions[..., :, None]                       # (B?, S, 1)
    k_pos = ar[None, None, :]
    if kv_cache is not None:
        k_pos = ar[None, :].expand(B, Sk)[:, None, :]
    if positions.ndim == 1:
        q_pos = positions[None, :, None]
    if x_kv is not None:
        mask = torch.ones((B, S, Sk), dtype=torch.bool, device=dev)
    elif cache_is_ring:
        # the ring holds only the window; every filled slot is valid
        valid = k_pos < min(new_cache["len"], Sk)
        mask = valid.expand(B, S, Sk) if valid.shape[0] == 1 else valid
    else:
        mask = k_pos <= q_pos if cfg.causal else torch.ones(
            (1, S, Sk), dtype=torch.bool, device=dev)
        if cfg.window > 0:
            mask = mask & (k_pos > q_pos - cfg.window)
        if kv_cache is not None:
            mask = mask & (ar[None, None, :] < new_cache["len"])
    scores = torch.where(mask[:, None, :, :], scores.float(),
                         MASKED)
    probs = _softmax(scores, use_lut).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vq)
    out = out.reshape(B, S, H * dh)
    return torch.matmul(out, p["wo"].to(x.dtype)), new_cache


def make_kv_cache(cfg: AttnCfg, batch: int, max_len: int, dtype=DTYPE,
                  device=None) -> Dict:
    cap = min(max_len, cfg.window) if cfg.window > 0 else max_len
    dev = resolve_device(device)
    shape = (batch, cap, cfg.kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "len": 0}


# ---------------------------------------------------------------------------
# MLP (dense and gated).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MlpCfg:
    d: int
    d_ff: int
    act: str = "gelu"           # gelu | silu
    gated: bool = False         # llama-style gate+up


def mlp_defs(cfg: MlpCfg, sh: ShardCfg) -> Dict[str, ParamDef]:
    tp = sh.tp if cfg.d_ff % sh.tp_size == 0 else None
    s_in = 1.0 / math.sqrt(cfg.d)
    s_out = 1.0 / math.sqrt(cfg.d_ff)
    defs = {"w1": ParamDef((cfg.d, cfg.d_ff), P(sh.fs(cfg.d), tp), s_in),
            "w2": ParamDef((cfg.d_ff, cfg.d), P(tp, sh.fs(cfg.d)), s_out)}
    if cfg.gated:
        defs["w3"] = ParamDef((cfg.d, cfg.d_ff), P(sh.fs(cfg.d), tp), s_in)
    return defs


def _act(name: str, x: torch.Tensor, use_lut: bool) -> torch.Tensor:
    if use_lut:
        spec = LUTS.ALL_SPECS[name]
        xc = torch.clamp(x.float(), spec.lo, spec.hi - 1e-3)
        return LUTS.apply(name, xc).to(x.dtype)
    if name == "gelu":
        return torch.nn.functional.gelu(x)          # exact (erf) form
    return torch.nn.functional.silu(x)


def mlp(cfg: MlpCfg, sh: ShardCfg, p, x: torch.Tensor,
        use_lut: bool = False) -> torch.Tensor:
    h = _act(cfg.act, torch.matmul(x, p["w1"].to(x.dtype)), use_lut)
    if cfg.gated:
        h = h * torch.matmul(x, p["w3"].to(x.dtype))
    return torch.matmul(h, p["w2"].to(x.dtype))


# ---------------------------------------------------------------------------
# MoE (capacity-based, sort or einsum dispatch).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoeCfg:
    d: int
    d_ff: int                  # per-expert hidden
    n_experts: int
    top_k: int
    act: str = "silu"
    gated: bool = True
    capacity_factor: float = 1.25


def moe_defs(cfg: MoeCfg, sh: ShardCfg) -> Dict[str, ParamDef]:
    ep = sh.tp if (cfg.n_experts % sh.tp_size == 0 and sh.moe_ep) else None
    # if experts don't divide tp, TP-shard each expert's d_ff instead
    ff_tp = None if ep else (sh.tp if cfg.d_ff % sh.tp_size == 0 else None)
    s_in = 1.0 / math.sqrt(cfg.d)
    s_out = 1.0 / math.sqrt(cfg.d_ff)
    defs = {
        "router": ParamDef((cfg.d, cfg.n_experts), P(None, None), s_in),
        "w1": ParamDef((cfg.n_experts, cfg.d, cfg.d_ff),
                       P(ep, None, ff_tp), s_in),
        "w2": ParamDef((cfg.n_experts, cfg.d_ff, cfg.d),
                       P(ep, ff_tp, None), s_out),
    }
    if cfg.gated:
        defs["w3"] = ParamDef((cfg.n_experts, cfg.d, cfg.d_ff),
                              P(ep, None, ff_tp), s_in)
    return defs


def moe_capacity(cfg: MoeCfg, T: int) -> int:
    """Slots per expert for T tokens: it grows with T, so a prefill can drop
    assignments that a decode step of the same tokens keeps (ROADMAP
    Queue 3, reference faults)."""
    cap = max(int(math.ceil(cfg.capacity_factor * cfg.top_k * T
                            / cfg.n_experts)), 4)
    return min(cap, T * cfg.top_k)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``one_hot(idx, n)`` in ``dtype`` as a scatter into zeros: the same
    ops on every device (``F.one_hot`` reads its input's range back on the
    CPU and takes another path on ``meta``, which the dry run traces)."""
    out = torch.zeros(tuple(idx.shape) + (n,), dtype=dtype, device=idx.device)
    return out.scatter_(-1, idx[..., None], 1)


def moe(cfg: MoeCfg, sh: ShardCfg, p, x: torch.Tensor,
        use_lut: bool = False, dispatch: str = "sort"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based MoE; returns (out, aux_loss).  The router runs in
    float32 and keeps the top K experts with renormalised gates; the aux
    loss is Switch's E * sum_e f_e p_e.

    dispatch='sort' (the default): the (token, k) assignments are sorted
    by expert (stably), ranked within their expert against the capacity
    and copied into (E, C, d) slots; each token's K outputs are then
    summed in the reference's order (``_combine``).  dispatch='einsum':
    GShard's one-hot (T, E, C) dispatch and combine tensors."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    xt = x.reshape(T, D)
    logits = torch.matmul(xt.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, K, dim=-1)            # (T, K)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)
    cap = moe_capacity(cfg, T)
    onehot_f = _one_hot(idx, E, torch.float32)               # (T, K, E)
    aux = E * torch.sum(torch.mean(onehot_f.sum(1), 0) * torch.mean(probs, 0))

    if dispatch == "einsum":
        pos = torch.cumsum(onehot_f.reshape(T * K, E), dim=0).reshape(T, K, E)
        pos = (pos - 1.0) * onehot_f
        keep = (pos < cap) & (onehot_f > 0)
        slot = torch.where(keep, pos, 0.0).long()
        slot_oh = _one_hot(slot, cap, x.dtype) * \
            keep.to(x.dtype)[..., None]                      # (T, K, E, C)
        disp = slot_oh.sum(1)
        comb = torch.einsum("tkec,tk->tec", slot_oh, gate_vals.to(x.dtype))
        xe = torch.einsum("td,tec->ecd", xt, disp)
        ye = _expert_ffn(cfg, p, xe, use_lut)
        out = torch.einsum("ecd,tec->td", ye, comb)
        return out.reshape(B, S, D), aux

    flat_e = idx.reshape(-1)                                 # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    tok_of = order // K
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank = torch.arange(T * K, device=dev) - starts[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, rank, 0)
    dest = sorted_e * cap + slot                             # unique where keep
    # dispatch: an index copy into unique slots; a dropped assignment goes
    # to a spare row past the E * cap slots
    xe = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=dev)
    xe[torch.where(keep, dest, E * cap)] = xt[tok_of]
    ye = _expert_ffn(cfg, p, xe[:E * cap].reshape(E, cap, D), use_lut)
    contrib = ye.reshape(E * cap, D)[dest] * \
        (gate_vals.reshape(-1)[order] * keep).to(x.dtype)[:, None]
    out = _combine(contrib, idx, order, tok_of)
    return out.reshape(B, S, D), aux


def _combine(contrib: torch.Tensor, idx: torch.Tensor, order: torch.Tensor,
             tok_of: torch.Tensor) -> torch.Tensor:
    """out[t] = the sum of token t's K contributions (``contrib`` in the
    sorted order), without atomics.  The JAX package scatter-adds
    (``.at[tok_of].add``) over the sorted assignments, which reach each
    token in ascending expert order; here the sort is inverted onto a
    (T, K, d) layout in that same order (an index copy into unique slots)
    and the K terms are added one at a time in the activations' dtype,
    from the first: the same order and roundings as a sequential
    scatter-add, and the same bits on every run (``index_add_`` on a CUDA
    bfloat16 tensor rounds differently from run to run)."""
    T, K = idx.shape
    # the place of each (t, k) among token t's experts in ascending order
    place = torch.argsort(torch.argsort(idx, dim=1, stable=True), dim=1,
                          stable=True).reshape(-1)
    laid = torch.empty_like(contrib)
    laid[tok_of * K + place[order]] = contrib
    laid = laid.reshape(T, K, -1)
    out = laid[:, 0]
    for k in range(1, K):
        out = out + laid[:, k]
    return out


def _expert_ffn(cfg: MoeCfg, p, xe: torch.Tensor, use_lut: bool
                ) -> torch.Tensor:
    h = _act(cfg.act, torch.bmm(xe, p["w1"].to(xe.dtype)), use_lut)
    if cfg.gated:
        h = h * torch.bmm(xe, p["w3"].to(xe.dtype))
    return torch.bmm(h, p["w2"].to(xe.dtype))
