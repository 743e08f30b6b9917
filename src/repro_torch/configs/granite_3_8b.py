"""granite-3-8b [hf:ibm-granite]: 40L d=4096 32H (GQA kv=8) ff=12800
vocab=49155 (padded to 49408 for TP) — GQA llama-family."""
from repro_torch.configs.base import ArchBundle
from repro_torch.models.model import LayerSpec, ModelCfg

_L = tuple(LayerSpec(kind="attn", rope_base=1e4) for _ in range(40))
CFG = ModelCfg(
    name="granite-3-8b", d=4096, n_layers=40, heads=32, kv_heads=8, dh=128,
    d_ff=12800, vocab=49155, layers=_L, norm="rmsnorm", act="silu",
    gated_mlp=True, rope="rope")

_SL = tuple(LayerSpec(kind="attn", rope_base=1e4) for _ in range(2))
SMOKE = ModelCfg(
    name="granite-3-8b-smoke", d=64, n_layers=2, heads=4, kv_heads=2,
    dh=16, d_ff=128, vocab=515, layers=_SL, norm="rmsnorm", act="silu",
    gated_mlp=True, rope="rope")

BUNDLE = ArchBundle(cfg=CFG, smoke=SMOKE, skip={
    "long_500k": "pure full attention (DESIGN.md §4)"})
