"""Model assembly for the float serving path (mirrors ``repro.models.model``).

A ModelCfg is a per-layer program: attention, Mamba, mLSTM or sLSTM
mixers, dense-MLP or MoE FFNs, and an optional encoder stack whose output
the decoder layers cross-attend (whisper).  One ``forward`` covers
training, prefill and decode; caches are a list with one dict per layer.
``forward`` runs the plain layer loop: the JAX package's
scan-over-layers (``scan_layers``, ``scan_split``, ``_stack_defs``) is a
compile-time device with the same numbers and is not ported, so
``specs``, ``shapes``, ``cache_specs`` and ``make_caches`` give the
per-layer trees the JAX package gives without ``scan_layers``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

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


def model_defs(cfg: ModelCfg, sh: L.ShardCfg) -> Dict:
    """The parameter tree, as the JAX package's ``_fix_defs`` gives it
    without ``scan_layers``: with an encoder, the decoder layers carry a
    cross-attention block."""
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
    return defs


def specs(cfg: ModelCfg, sh: L.ShardCfg):
    """The partition spec of every parameter (tuples of mesh-axis names)."""
    return L.param_specs(model_defs(cfg, sh))


def shapes(cfg: ModelCfg, sh: L.ShardCfg):
    """Every parameter as a ``meta`` tensor of its shape and dtype."""
    return L.param_shapes(model_defs(cfg, sh))


def init(cfg: ModelCfg, sh: L.ShardCfg, gen: torch.Generator, device=None):
    """Random parameters from ``gen`` on ``device`` (see layers.init_params)."""
    return L.init_params(model_defs(cfg, sh), gen, device)


def params_from_numpy(cfg: ModelCfg, tree, sh: Optional[L.ShardCfg] = None,
                      device=None):
    """The JAX package's parameter tree, leaves as numpy, as the port's:
    the same nesting and shapes, each leaf at its def's dtype on
    ``device``.  A bfloat16 leaf (an ``ml_dtypes`` array, which
    ``torch.from_numpy`` refuses) goes through float32, which holds every
    bfloat16 value exactly."""
    dev = resolve_device(device)
    defs = model_defs(cfg, sh if sh is not None else L.ShardCfg())

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


def _encode(cfg: ModelCfg, sh: L.ShardCfg, params, enc_input: torch.Tensor,
            use_lut: bool) -> torch.Tensor:
    """The encoder stack over enc_input (B, frames, d), the precomputed
    frame embeddings of whisper's stubbed frontend: bidirectional
    attention, learned positions, no cache."""
    e = enc_input.to(cfg.dtype) + params["enc_pos"].to(cfg.dtype)
    enc_positions = torch.arange(e.shape[1], device=e.device)
    acfg = _encoder_cfg(cfg).attn_cfg(LayerSpec(kind="attn"), causal=False)
    for lp in params["enc_layers"]:
        a, _ = L.attention(acfg, sh, lp["mix"],
                           L.apply_norm(cfg.norm, lp["n1"], e, use_lut),
                           enc_positions, use_lut)
        e = e + a
        e = e + L.mlp(cfg.mlp_cfg(), sh, lp["ffn"],
                      L.apply_norm(cfg.norm, lp["n2"], e, use_lut), use_lut)
    return L.apply_norm(cfg.norm, params["enc_norm"], e, use_lut)


def forward(cfg: ModelCfg, sh: L.ShardCfg, params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[List] = None, use_lut: bool = False,
            enc_input: Optional[torch.Tensor] = None,
            remat: bool = False
            ) -> Tuple[torch.Tensor, Optional[List], torch.Tensor]:
    """tokens: (B, S) int -> logits (B, S, vocab_padded).  Returns (logits,
    new_caches, aux_loss).  With ``remat`` and grad enabled, each layer
    body runs under ``torch.utils.checkpoint`` (non-reentrant), the
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
    new_caches: Optional[List] = [] if caches is not None else None

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
                device=None):
    check_supported(cfg)
    dev = resolve_device(device)
    return [_one_cache(cfg, spec, batch, max_len, dev) for spec in cfg.layers]


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


def cache_specs(cfg: ModelCfg, sh: L.ShardCfg):
    """The partition specs of ``make_caches``' tree, one dict per layer (a
    KV cache's ``len`` is a host int here; its spec is kept)."""
    return [_one_cache_spec(cfg, spec, sh) for spec in cfg.layers]


def decode_step(cfg: ModelCfg, sh: L.ShardCfg, params, token, pos, caches,
                enc_input=None, use_lut: bool = False):
    """token: (B, 1); pos: (B,) current positions.  One serve step; with
    ``enc_input`` the encoder runs again, as in the JAX package."""
    logits, new_caches, _ = forward(cfg, sh, params, token,
                                    positions=pos[:, None], caches=caches,
                                    enc_input=enc_input, use_lut=use_lut)
    return logits[:, -1], new_caches
