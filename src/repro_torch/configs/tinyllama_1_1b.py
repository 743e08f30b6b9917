"""TinyLLaMA-1.1B (paper's accuracy/Fisher model, Zhang et al. 2024):
22L d=2048 32H (GQA kv=4) ff=5632 vocab=32000 — llama family (RMSNorm,
RoPE, SiLU gate)."""
from repro_torch.configs.base import ArchBundle
from repro_torch.models.model import LayerSpec, ModelCfg

_L = tuple(LayerSpec(kind="attn", rope_base=1e4) for _ in range(22))
CFG = ModelCfg(
    name="tinyllama-1.1b", d=2048, n_layers=22, heads=32, kv_heads=4,
    dh=64, d_ff=5632, vocab=32000, layers=_L, norm="rmsnorm", act="silu",
    gated_mlp=True, rope="rope")

_SL = tuple(LayerSpec(kind="attn", rope_base=1e4) for _ in range(2))
SMOKE = ModelCfg(
    name="tinyllama-smoke", d=64, n_layers=2, heads=4, kv_heads=2, dh=16,
    d_ff=128, vocab=512, layers=_SL, norm="rmsnorm", act="silu",
    gated_mlp=True, rope="rope")

BUNDLE = ArchBundle(cfg=CFG, smoke=SMOKE, skip={
    "long_500k": "pure full attention (DESIGN.md §4)"})
