"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: 24L d=1024 16H (kv=16) ff=2816
vocab=151936 — QKV bias, tied embeddings, full attention (long_500k skip)."""
from repro_torch.configs.base import ArchBundle
from repro_torch.models.model import LayerSpec, ModelCfg

_L = tuple(LayerSpec(kind="attn", rope_base=1e6) for _ in range(24))
CFG = ModelCfg(
    name="qwen1.5-0.5b", d=1024, n_layers=24, heads=16, kv_heads=16, dh=64,
    d_ff=2816, vocab=151936, layers=_L, norm="rmsnorm", act="silu",
    gated_mlp=True, qkv_bias=True, rope="rope", tie_embeddings=True)

_SL = tuple(LayerSpec(kind="attn", rope_base=1e4) for _ in range(2))
SMOKE = ModelCfg(
    name="qwen1.5-0.5b-smoke", d=64, n_layers=2, heads=4, kv_heads=4, dh=16,
    d_ff=128, vocab=512, layers=_SL, norm="rmsnorm", act="silu",
    gated_mlp=True, qkv_bias=True, rope="rope", tie_embeddings=True)

BUNDLE = ArchBundle(cfg=CFG, smoke=SMOKE, skip={
    "long_500k": "pure full attention; quadratic prefill, no sub-quadratic "
                 "variant in the published config (DESIGN.md §4)"})
