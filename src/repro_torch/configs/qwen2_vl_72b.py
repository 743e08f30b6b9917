"""qwen2-vl-72b [arXiv:2409.12191]: 80L d=8192 64H (GQA kv=8) ff=29568
vocab=152064 — M-RoPE (t/h/w sections over dh/2), dynamic-resolution
vision frontend STUBBED: input_specs supplies token ids whose image spans
are precomputed patch embeddings (the backbone is what we lower)."""
from repro_torch.configs.base import ArchBundle
from repro_torch.models.model import LayerSpec, ModelCfg

_L = tuple(LayerSpec(kind="attn", rope_base=1e6) for _ in range(80))
CFG = ModelCfg(
    name="qwen2-vl-72b", d=8192, n_layers=80, heads=64, kv_heads=8, dh=128,
    d_ff=29568, vocab=152064, layers=_L, norm="rmsnorm", act="silu",
    gated_mlp=True, qkv_bias=True, rope="mrope")

_SL = tuple(LayerSpec(kind="attn", rope_base=1e4) for _ in range(2))
SMOKE = ModelCfg(
    name="qwen2-vl-smoke", d=64, n_layers=2, heads=4, kv_heads=2, dh=16,
    d_ff=128, vocab=512, layers=_SL, norm="rmsnorm", act="silu",
    gated_mlp=True, qkv_bias=True, rope="mrope")

BUNDLE = ArchBundle(cfg=CFG, smoke=SMOKE, skip={
    "long_500k": "pure full attention (DESIGN.md §4)"})
