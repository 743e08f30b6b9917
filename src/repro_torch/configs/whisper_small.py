"""whisper-small [arXiv:2212.04356]: enc-dec, 12L each, d=768 12H ff=3072
vocab=51865 — conv frontend STUBBED (input_specs supplies precomputed
frame embeddings, per the brief). LayerNorm + GELU + learned positions.
prefill_32k / long_500k skipped: decoder max context is 448 in the
published config; decode_32k runs at the native 448 context instead
(recorded in DESIGN.md §4)."""
from repro_torch.configs.base import ArchBundle
from repro_torch.models.model import EncoderCfg, LayerSpec, ModelCfg

_L = tuple(LayerSpec(kind="attn") for _ in range(12))
CFG = ModelCfg(
    name="whisper-small", d=768, n_layers=12, heads=12, kv_heads=12, dh=64,
    d_ff=3072, vocab=51865, layers=_L, norm="layernorm", act="gelu",
    gated_mlp=False, qkv_bias=True, rope="none", pos_embed=448,
    encoder=EncoderCfg(n_layers=12, frames=1500), attn_tp=False,
    max_seq=448)

_SL = tuple(LayerSpec(kind="attn") for _ in range(2))
SMOKE = ModelCfg(
    name="whisper-small-smoke", d=64, n_layers=2, heads=4, kv_heads=4,
    dh=16, d_ff=128, vocab=512, layers=_SL, norm="layernorm", act="gelu",
    gated_mlp=False, qkv_bias=True, rope="none", pos_embed=64,
    encoder=EncoderCfg(n_layers=2, frames=32), attn_tp=False, max_seq=64)

BUNDLE = ArchBundle(
    cfg=CFG, smoke=SMOKE,
    skip={"prefill_32k": "decoder max context 448 (run at native context)",
          "long_500k": "encoder context fixed at 1500 frames; decoder 448"},
    overrides={"train_4k": dict(seq=448),
               "decode_32k": dict(seq=448)})
