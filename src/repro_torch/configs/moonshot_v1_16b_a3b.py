"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d=2048 16H
(kv=16, MHA) per-expert ff=1408, MoE 64e top-6, vocab=163840 —
64 experts % 16 == 0 -> expert-parallel sharding (EP) over the model
axis (4 experts per shard), all-to-all dispatch."""
from repro_torch.configs.base import ArchBundle
from repro_torch.models.model import LayerSpec, ModelCfg

_L = tuple(LayerSpec(kind="attn", rope_base=5e4, moe=True)
           for _ in range(48))
CFG = ModelCfg(
    name="moonshot-v1-16b-a3b", d=2048, n_layers=48, heads=16, kv_heads=16,
    dh=128, d_ff=1408, vocab=163840, layers=_L, norm="rmsnorm", act="silu",
    gated_mlp=True, rope="rope", n_experts=64, top_k=6, moe_ff=1408)

_SL = tuple(LayerSpec(kind="attn", rope_base=1e4, moe=True)
            for _ in range(2))
SMOKE = ModelCfg(
    name="moonshot-smoke", d=64, n_layers=2, heads=4, kv_heads=4, dh=16,
    d_ff=32, vocab=512, layers=_SL, norm="rmsnorm", act="silu",
    gated_mlp=True, rope="rope", n_experts=8, top_k=3, moe_ff=32)

BUNDLE = ArchBundle(cfg=CFG, smoke=SMOKE, skip={
    "long_500k": "pure full attention (DESIGN.md §4)"})
