"""Model assembly for the float serving path (mirrors ``repro.models.model``).

A ModelCfg is a per-layer program: attention, Mamba, mLSTM or sLSTM
mixers, dense-MLP or MoE FFNs, and an optional encoder stack whose output
the decoder layers cross-attend (whisper).  One ``forward`` covers
training, prefill and decode.

Two parameter layouts, as in the JAX package:

* per layer (the default): ``"layers"``, a list of one dict per layer
  (``"enc_layers"`` for the encoder), and caches as a list with one dict
  per layer;
* stacked (``scan_layers=True``): the layers split into ``reps``
  repetitions of a period of ``period`` layers (``scan_split``), each of
  the period's positions one dict ``"blocks"/"pos{j}"`` whose leaves
  carry a leading ``reps`` axis (spec ``P(None, *spec)``), the layers past
  ``period * reps`` a list ``"tail"``; the encoder's layers stacked whole
  as ``"enc_blocks"`` beside an empty ``"enc_tail"``; caches stacked the
  same way (``{"blocks": {...}, "tail": [...]}``).  ``forward`` runs the
  stacked tree as the JAX package's ``lax.scan`` does, one layer at a
  time on views of the stacked leaves, and gives the same numbers as the
  per-layer tree holding the same weights.

``forward`` picks the layout from the tree (``"blocks" in params``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch._tree import tree_map
from repro_torch.device import resolve_device

from . import layers as L
from . import mamba as MB
from . import xlstm as X
from .layers import P


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"            # attn | mamba | mlstm | slstm
    window: int = 0               # sliding window size (attn only)
    rope_base: float = 1e6
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class EncoderCfg:
    n_layers: int
    frames: int = 1500            # whisper stub frontend length


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    d: int
    n_layers: int
    heads: int
    kv_heads: int
    dh: int
    d_ff: int
    vocab: int
    layers: Tuple[LayerSpec, ...]
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    rope: str = "rope"            # none | rope | mrope
    softcap: float = 0.0
    n_experts: int = 0
    top_k: int = 0
    moe_ff: int = 0               # per-expert hidden (defaults d_ff)
    moe_dispatch: str = "sort"    # 'sort' | 'einsum'
    tie_embeddings: bool = False
    pos_embed: int = 0            # learned absolute positions (gpt2/whisper)
    encoder: Optional[EncoderCfg] = None
    max_seq: int = 131072
    attn_tp: bool = True
    dtype: Any = torch.bfloat16

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab + 255) // 256) * 256

    def attn_cfg(self, spec: LayerSpec, causal=True) -> L.AttnCfg:
        return L.AttnCfg(d=self.d, heads=self.heads, kv_heads=self.kv_heads,
                         dh=self.dh, qkv_bias=self.qkv_bias,
                         rope=self.rope, rope_base=spec.rope_base,
                         window=spec.window, causal=causal,
                         softcap=self.softcap)

    def mlp_cfg(self) -> L.MlpCfg:
        return L.MlpCfg(d=self.d, d_ff=self.d_ff, act=self.act,
                        gated=self.gated_mlp)

    def moe_cfg(self) -> L.MoeCfg:
        return L.MoeCfg(d=self.d, d_ff=self.moe_ff or self.d_ff,
                        n_experts=self.n_experts, top_k=self.top_k,
                        act=self.act, gated=self.gated_mlp)

    def mamba_cfg(self) -> MB.MambaCfg:
        return MB.MambaCfg(d=self.d, d_inner=2 * self.d)

    def xlstm_cfg(self, kind: str) -> X.XlstmCfg:
        return X.XlstmCfg(d=self.d, heads=self.heads, kind=kind)

    def shard_cfg(self, dp: Tuple[str, ...] = ("data",), tp_size: int = 16,
                  dp_size: int = 16, cache_seq: Tuple[str, ...] = (),
                  cache_seq_size: int = 1, batch_dp: bool = True
                  ) -> L.ShardCfg:
        return L.ShardCfg(dp=dp, tp_size=tp_size, dp_size=dp_size,
                          cache_seq=cache_seq,
                          cache_seq_size=cache_seq_size, batch_dp=batch_dp,
                          attn_tp=self.attn_tp and
                          (self.heads % tp_size == 0))


LAYER_KINDS = ("attn", "mamba", "mlstm", "slstm")


def check_supported(cfg: ModelCfg) -> None:
    """Raise ValueError for a layer kind the model does not know."""
    for spec in cfg.layers:
        if spec.kind not in LAYER_KINDS:
            raise ValueError(f"unknown layer kind {spec.kind!r}")


# ---------------------------------------------------------------------------
# Parameter definitions.
# ---------------------------------------------------------------------------
def _layer_defs(cfg: ModelCfg, spec: LayerSpec, sh: L.ShardCfg,
                cross: bool = False, causal: bool = True) -> Dict:
    d = {"n1": L.norm_defs(cfg.norm, cfg.d)}
    if spec.kind == "attn":
        d["mix"] = L.attn_defs(cfg.attn_cfg(spec, causal), sh)
    elif spec.kind == "mamba":
        d["mix"] = MB.mamba_defs(cfg.mamba_cfg(), sh)
    else:
        d["mix"] = X.xlstm_defs(cfg.xlstm_cfg(spec.kind), sh)
    if cross:
        d["nc"] = L.norm_defs(cfg.norm, cfg.d)
        ccfg = dataclasses.replace(cfg.attn_cfg(spec, causal=False),
                                   rope="none")
        d["cross"] = L.attn_defs(ccfg, sh)
    if cfg.d_ff > 0 or spec.moe:
        d["n2"] = L.norm_defs(cfg.norm, cfg.d)
        if spec.moe:
            d["ffn"] = L.moe_defs(cfg.moe_cfg(), sh)
        else:
            d["ffn"] = L.mlp_defs(cfg.mlp_cfg(), sh)
    return d


def _encoder_cfg(cfg: ModelCfg) -> ModelCfg:
    """The encoder's layers: no rotary positions, biased projections."""
    return dataclasses.replace(cfg, rope="none", qkv_bias=True)


def model_defs(cfg: ModelCfg, sh: L.ShardCfg, scan_layers: bool = False
               ) -> Dict:
    """The parameter tree, as the JAX package's ``_fix_defs`` gives it:
    with an encoder, the decoder layers carry a cross-attention block;
    with ``scan_layers`` the stacked layout (``scan_split``), where a
    split of (n, 1) still stacks every position with a leading axis of 1,
    as the JAX package does."""
    check_supported(cfg)
    V = cfg.vocab_padded
    tp = sh.tp if V % sh.tp_size == 0 else None
    if cfg.encoder is None:
        layers = [_layer_defs(cfg, spec, sh) for spec in cfg.layers]
    else:
        layers = [_layer_defs(dataclasses.replace(cfg, rope="none"), spec,
                              sh, cross=True) for spec in cfg.layers]
    defs: Dict[str, Any] = {
        "embed": L.ParamDef((V, cfg.d), P(tp, sh.fs(cfg.d)), 0.02),
        "layers": layers,
        "final_norm": L.norm_defs(cfg.norm, cfg.d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = L.ParamDef((cfg.d, V), P(sh.fs(cfg.d), tp),
                                     1.0 / math.sqrt(cfg.d))
    if cfg.pos_embed:
        defs["pos"] = L.ParamDef((cfg.pos_embed, cfg.d), P(None, None), 0.01)
    if cfg.encoder is not None:
        enc_spec = LayerSpec(kind="attn", rope_base=0.0)
        defs["enc_layers"] = [
            _layer_defs(_encoder_cfg(cfg), enc_spec, sh, causal=False)
            for _ in range(cfg.encoder.n_layers)]
        defs["enc_norm"] = L.norm_defs(cfg.norm, cfg.d)
        defs["enc_pos"] = L.ParamDef((cfg.encoder.frames, cfg.d),
                                     P(None, None), 0.01)
    if scan_layers:
        p, k = scan_split(cfg)
        per_layer = defs.pop("layers")
        defs["blocks"] = {
            f"pos{j}": _stack_defs([per_layer[r * p + j] for r in range(k)])
            for j in range(p)}
        defs["tail"] = per_layer[p * k:]
        if cfg.encoder is not None:
            defs["enc_blocks"] = _stack_defs(defs.pop("enc_layers"))
            defs["enc_tail"] = []
    return defs


def scan_split(cfg: ModelCfg) -> Tuple[int, int]:
    """(period, reps): layers [0, period * reps) are stacked by their
    position in the period, the rest run as an explicit tail.  The JAX
    package's rule: the period whose pattern repeats at least twice and
    leaves the fewest positions plus tail layers, the smallest on a tie;
    (n, 1) where none repeats."""
    layers = cfg.layers
    n = len(layers)
    best = (n, 1)
    for p in range(1, n // 2 + 1):
        k = n // p
        if k < 2:
            break
        if all(layers[i] == layers[i % p] for i in range(k * p)):
            if p + (n - k * p) < best[0] + (n - best[0] * best[1]):
                best = (p, k)
    return best


def _stack_defs(defs_list):
    """Identical per-layer def trees as one tree whose defs carry a new
    leading axis of len(defs_list), unsharded (``P(None, *spec)``)."""
    def stack(*ds):
        d0 = ds[0]
        return L.ParamDef(shape=(len(ds),) + tuple(d0.shape),
                          spec=P(None, *d0.spec), init_scale=d0.init_scale,
                          dtype=d0.dtype, zero=d0.zero)
    return tree_map(stack, *defs_list)


def specs(cfg: ModelCfg, sh: L.ShardCfg, scan_layers: bool = False):
    """The partition spec of every parameter (tuples of mesh-axis names)."""
    return L.param_specs(model_defs(cfg, sh, scan_layers))


def shapes(cfg: ModelCfg, sh: L.ShardCfg, scan_layers: bool = False):
    """Every parameter as a ``meta`` tensor of its shape and dtype."""
    return L.param_shapes(model_defs(cfg, sh, scan_layers))


def init(cfg: ModelCfg, sh: L.ShardCfg, gen: torch.Generator, device=None,
         scan_layers: bool = False):
    """Random parameters from ``gen`` on ``device`` (see layers.init_params);
    a stacked leaf is drawn whole."""
    return L.init_params(model_defs(cfg, sh, scan_layers), gen, device)


def params_from_numpy(cfg: ModelCfg, tree, sh: Optional[L.ShardCfg] = None,
                      device=None, scan_layers: bool = False):
    """The JAX package's parameter tree, leaves as numpy, as the port's:
    the same nesting and shapes (stacked with ``scan_layers``), each leaf
    at its def's dtype on ``device``.  A bfloat16 leaf (an ``ml_dtypes``
    array, which ``torch.from_numpy`` refuses) goes through float32, which
    holds every bfloat16 value exactly."""
    dev = resolve_device(device)
    defs = model_defs(cfg, sh if sh is not None else L.ShardCfg(),
                      scan_layers)

    def walk(d, t, path):
        if isinstance(d, L.ParamDef):
            arr = np.asarray(t)
            if tuple(arr.shape) != tuple(d.shape):
                raise ValueError(f"{path}: shape {arr.shape} != {d.shape}")
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=dev, dtype=d.dtype)
        if isinstance(d, dict):
            if sorted(d) != sorted(t):
                raise ValueError(f"{path}: keys {sorted(t)} != {sorted(d)}")
            return {k: walk(d[k], t[k], f"{path}.{k}") for k in d}
        if len(d) != len(t):
            raise ValueError(f"{path}: {len(t)} entries != {len(d)}")
        return [walk(a, b, f"{path}[{i}]") for i, (a, b) in enumerate(zip(d, t))]
    return walk(defs, tree, "params")


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------
def _mixer(cfg: ModelCfg, spec: LayerSpec, sh: L.ShardCfg, lp, h,
           positions, use_lut, cache):
    if spec.kind == "attn":
        return L.attention(cfg.attn_cfg(spec), sh, lp["mix"], h, positions,
                           use_lut, cache)
    if spec.kind == "mamba":
        return MB.mamba(cfg.mamba_cfg(), sh, lp["mix"], h, cache)
    if spec.kind == "mlstm":
        return X.mlstm(cfg.xlstm_cfg("mlstm"), sh, lp["mix"], h, cache)
    return X.slstm(cfg.xlstm_cfg("slstm"), sh, lp["mix"], h, cache)


def _per_rep(tree, k: int) -> List:
    """A stacked tree as ``k`` trees of views, the r-th holding ``x[r]`` of
    every leaf: one ``unbind`` per leaf, whose backward stacks the k
    gradients in one op (``x[r]`` alone would give each rep's gradient
    as a zero-filled stack of its own)."""
    views = tree_map(torch.unbind, tree)
    return [tree_map(lambda v, r=r: v[r], views,
                     is_leaf=lambda v: isinstance(v, tuple))
            for r in range(k)]


def unstack(cfg: ModelCfg, params):
    """The per-layer tree of a stacked one, every leaf a view ``x[r]`` of
    its stacked leaf (the same weights, no copy): layer ``r * period + j``
    is ``blocks/pos{j}`` at ``r``, then the tail; the encoder's layers
    likewise."""
    p, k = scan_split(cfg)
    out = {key: v for key, v in params.items()
           if key not in ("blocks", "tail", "enc_blocks", "enc_tail")}
    reps = {j: _per_rep(params["blocks"][f"pos{j}"], k) for j in range(p)}
    out["layers"] = [reps[j][r] for r in range(k) for j in range(p)] + \
        list(params["tail"])
    if "enc_blocks" in params:
        out["enc_layers"] = _per_rep(params["enc_blocks"],
                                     cfg.encoder.n_layers) + \
            list(params["enc_tail"])
    return out


def _encode(cfg: ModelCfg, sh: L.ShardCfg, params, enc_input: torch.Tensor,
            use_lut: bool) -> torch.Tensor:
    """The encoder stack over enc_input (B, frames, d), the precomputed
    frame embeddings of whisper's stubbed frontend: bidirectional
    attention, learned positions, no cache.  A stacked encoder
    (``enc_blocks``) runs its layers in order, as the JAX package's scan
    does."""
    e = enc_input.to(cfg.dtype) + params["enc_pos"].to(cfg.dtype)
    enc_positions = torch.arange(e.shape[1], device=e.device)
    acfg = _encoder_cfg(cfg).attn_cfg(LayerSpec(kind="attn"), causal=False)
    if "enc_blocks" in params:
        layers = _per_rep(params["enc_blocks"], cfg.encoder.n_layers)
    else:
        layers = params["enc_layers"]
    for lp in layers:
        a, _ = L.attention(acfg, sh, lp["mix"],
                           L.apply_norm(cfg.norm, lp["n1"], e, use_lut),
                           enc_positions, use_lut)
        e = e + a
        e = e + L.mlp(cfg.mlp_cfg(), sh, lp["ffn"],
                      L.apply_norm(cfg.norm, lp["n2"], e, use_lut), use_lut)
    return L.apply_norm(cfg.norm, params["enc_norm"], e, use_lut)


def _forward_stacked(cfg: ModelCfg, params, caches, h, body, aux_total):
    """The layer loop over a stacked tree: for r in reps, for j in the
    period, layer r * period + j on views of ``blocks/pos{j}`` at r (and of
    its cache), then the tail.  ``aux`` sums as the JAX package's scan
    does: per period, then over the reps, then the tail's.  A cache's
    stacked tensors take each layer's new state in place; a KV cache's
    ``len``, one host int per position, advances once for its reps.
    Returns (h, new_caches, aux_total)."""
    p, k = scan_split(cfg)
    reps = {j: _per_rep(params["blocks"][f"pos{j}"], k) for j in range(p)}
    dev = h.device
    period_aux = []
    new_len = {}
    for r in range(k):
        aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for j in range(p):
            cache = None
            if caches is not None:
                stack = caches["blocks"][f"pos{j}"]
                cache = {key: v if key == "len" else v[r]
                         for key, v in stack.items()}
            h, nc, aux = body(h, reps[j][r], cfg.layers[j], cache)
            if aux is not None:
                aux_sum = aux_sum + aux
            if caches is not None:
                for key, v in nc.items():
                    if key == "len":
                        new_len[j] = v
                    elif v is not cache[key]:     # a recurrent state
                        stack[key][r].copy_(v)
        period_aux.append(aux_sum)
    aux_total = aux_total + torch.sum(torch.stack(period_aux))
    new_caches = None
    if caches is not None:
        blocks = {}
        for j in range(p):
            stack = dict(caches["blocks"][f"pos{j}"])
            if j in new_len:
                stack["len"] = new_len[j]
            blocks[f"pos{j}"] = stack
        new_caches = {"blocks": blocks, "tail": []}
    for j, lp in enumerate(params["tail"]):
        cache = caches["tail"][j] if caches is not None else None
        h, nc, aux = body(h, lp, cfg.layers[p * k + j], cache)
        if aux is not None:
            aux_total = aux_total + aux
        if caches is not None:
            new_caches["tail"].append(nc)
    return h, new_caches, aux_total


def forward(cfg: ModelCfg, sh: L.ShardCfg, params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            caches=None, use_lut: bool = False,
            enc_input: Optional[torch.Tensor] = None,
            remat: bool = False
            ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """tokens: (B, S) int -> logits (B, S, vocab_padded).  Returns (logits,
    new_caches, aux_loss).  ``params`` is either layout and ``caches``
    ``make_caches``' tree for it.  With ``remat`` and grad enabled, each
    layer body runs under ``torch.utils.checkpoint`` (non-reentrant), the
    counterpart of the JAX package's ``jax.checkpoint(...,
    nothing_saveable)``: backward recomputes the layer instead of keeping
    its activations, and no number changes.  A cached call (decode, which
    updates its caches in place) never rematerialises."""
    check_supported(cfg)
    B, S = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(S, device=dev)
    h = params["embed"].to(cfg.dtype)[tokens]
    if cfg.pos_embed:
        pos_table = params["pos"].to(cfg.dtype)
        h = h + pos_table[torch.clamp(positions, 0, cfg.pos_embed - 1)]

    enc_out = None
    if cfg.encoder is not None and enc_input is not None:
        enc_out = _encode(cfg, sh, params, enc_input, use_lut)

    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    new_caches = [] if caches is not None else None

    def layer_body(h, lp, spec, cache):
        aux = None
        hn = L.apply_norm(cfg.norm, lp["n1"], h, use_lut)
        out, new_cache = _mixer(cfg, spec, sh, lp, hn, positions, use_lut,
                                cache)
        h = h + out
        if "cross" in lp and enc_out is not None:
            hc = L.apply_norm(cfg.norm, lp["nc"], h, use_lut)
            c_cfg = dataclasses.replace(cfg.attn_cfg(spec, causal=False),
                                        rope="none")
            ca, _ = L.attention(c_cfg, sh, lp["cross"], hc, positions,
                                use_lut, None, x_kv=enc_out)
            h = h + ca
        if "ffn" in lp:
            hf = L.apply_norm(cfg.norm, lp["n2"], h, use_lut)
            if spec.moe:
                f, aux = L.moe(cfg.moe_cfg(), sh, lp["ffn"], hf, use_lut,
                               dispatch=cfg.moe_dispatch)
            else:
                f = L.mlp(cfg.mlp_cfg(), sh, lp["ffn"], hf, use_lut)
            h = h + f
        return h, new_cache, aux

    body = layer_body
    if remat and caches is None and torch.is_grad_enabled():
        body = functools.partial(torch.utils.checkpoint.checkpoint,
                                 layer_body, use_reentrant=False)
    if "blocks" in params:
        h, new_caches, aux_total = _forward_stacked(cfg, params, caches, h,
                                                    body, aux_total)
    else:
        for i, (lp, spec) in enumerate(zip(params["layers"], cfg.layers)):
            cache = caches[i] if caches is not None else None
            h, new_cache, aux = body(h, lp, spec, cache)
            if aux is not None:
                aux_total = aux_total + aux
            if new_caches is not None:
                new_caches.append(new_cache)

    h = L.apply_norm(cfg.norm, params["final_norm"], h, use_lut)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.dtype)
    logits = torch.matmul(h, head)
    return logits, new_caches, aux_total


# ---------------------------------------------------------------------------
# Loss and decode.
# ---------------------------------------------------------------------------
def loss_fn(cfg: ModelCfg, sh: L.ShardCfg, params, tokens, labels,
            enc_input=None, use_lut: bool = False, remat: bool = True
            ) -> torch.Tensor:
    """Mean next-token NLL over labels >= 0 (+ 0.01 x the MoE aux loss)."""
    logits, _, aux = forward(cfg, sh, params, tokens, enc_input=enc_input,
                             use_lut=use_lut, remat=remat)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = labels >= 0
    nll = torch.sum((logz - ll) * mask) / torch.clamp(mask.sum(), min=1)
    return nll + 0.01 * aux


def _one_cache(cfg: ModelCfg, spec: LayerSpec, batch: int, max_len: int,
               device):
    if spec.kind == "attn":
        return L.make_kv_cache(cfg.attn_cfg(spec), batch, max_len, cfg.dtype,
                               device)
    if spec.kind == "mamba":
        return MB.make_mamba_cache(cfg.mamba_cfg(), batch, cfg.dtype, device)
    return X.make_xlstm_cache(cfg.xlstm_cfg(spec.kind), batch, device)


def make_caches(cfg: ModelCfg, sh: L.ShardCfg, batch: int, max_len: int,
                device=None, scan_layers: bool = False):
    """Empty caches: one dict per layer, or with ``scan_layers`` the
    stacked tree ``{"blocks": {"pos{j}": ...}, "tail": [...]}``, each
    tensor of position j with a leading axis of ``reps``.  A KV cache's
    ``len`` is a host int (the JAX package keeps a device int32 per
    layer): a stacked position has one, shared by its ``reps`` layers,
    which always advance together.  ``forward`` writes a step into the
    stacked tensors in place and allocates no new stack."""
    check_supported(cfg)
    dev = resolve_device(device)
    if not scan_layers:
        return [_one_cache(cfg, spec, batch, max_len, dev)
                for spec in cfg.layers]
    p, k = scan_split(cfg)
    blocks = {}
    for j in range(p):
        one = _one_cache(cfg, cfg.layers[j], batch, max_len, dev)
        blocks[f"pos{j}"] = {
            key: v if key == "len" else v[None].repeat(k, *[1] * v.dim())
            for key, v in one.items()}
    tail = [_one_cache(cfg, spec, batch, max_len, dev)
            for spec in cfg.layers[p * k:]]
    return {"blocks": blocks, "tail": tail}


def _one_cache_spec(cfg: ModelCfg, spec: LayerSpec, sh: L.ShardCfg):
    tp = sh.tp
    if spec.kind == "attn":
        cap_axes = sh.cache_seq if sh.cache_seq else None
        kv_tp = tp if (cfg.kv_heads % sh.tp_size == 0 and sh.attn_tp and
                       not cap_axes) else None
        return {"k": P(sh.bdp, cap_axes, kv_tp, None),
                "v": P(sh.bdp, cap_axes, kv_tp, None), "len": P()}
    if spec.kind == "mamba":
        mc = cfg.mamba_cfg()
        itp = tp if mc.d_inner % sh.tp_size == 0 else None
        return {"h": P(sh.bdp, itp, None), "conv": P(sh.bdp, None, itp)}
    xc = cfg.xlstm_cfg(spec.kind)
    htp = tp if xc.heads % sh.tp_size == 0 else None
    if spec.kind == "mlstm":
        return {"C": P(sh.bdp, htp, None, None), "n": P(sh.bdp, htp, None),
                "m": P(sh.bdp, htp)}
    return {"c": P(sh.bdp, htp, None), "n": P(sh.bdp, htp, None),
            "h": P(sh.bdp, htp, None), "m": P(sh.bdp, htp, None)}


def cache_specs(cfg: ModelCfg, sh: L.ShardCfg, scan_layers: bool = False):
    """The partition specs of ``make_caches``' tree (a KV cache's ``len`` is
    a host int here; its spec is the JAX package's all the same), stacked
    specs ``P(None, *spec)`` with ``scan_layers``."""
    if not scan_layers:
        return [_one_cache_spec(cfg, spec, sh) for spec in cfg.layers]
    p, k = scan_split(cfg)
    blocks = {f"pos{j}": {key: P(None, *s) for key, s in
                          _one_cache_spec(cfg, cfg.layers[j], sh).items()}
              for j in range(p)}
    tail = [_one_cache_spec(cfg, spec, sh) for spec in cfg.layers[p * k:]]
    return {"blocks": blocks, "tail": tail}


def decode_step(cfg: ModelCfg, sh: L.ShardCfg, params, token, pos, caches,
                enc_input=None, use_lut: bool = False):
    """token: (B, 1); pos: (B,) current positions.  One serve step; with
    ``enc_input`` the encoder runs again, as in the JAX package."""
    logits, new_caches, _ = forward(cfg, sh, params, token,
                                    positions=pos[:, None], caches=caches,
                                    enc_input=enc_input, use_lut=use_lut)
    return logits[:, -1], new_caches
