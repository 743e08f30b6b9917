"""grok-1-314b [hf:xai-org/grok-1]: 64L d=6144 48H (GQA kv=8) per-expert
ff=32768, MoE 8e top-2, vocab=131072 — 8 experts % 16 != 0 so each
expert's d_ff is TP-sharded instead of EP (resolver rule); attention
heads 48 % 16 == 0 -> head-sharded TP. Attention logit softcap 30."""
from repro_torch.configs.base import ArchBundle
from repro_torch.models.model import LayerSpec, ModelCfg

_L = tuple(LayerSpec(kind="attn", rope_base=1e4, moe=True)
           for _ in range(64))
CFG = ModelCfg(
    name="grok-1-314b", d=6144, n_layers=64, heads=48, kv_heads=8, dh=128,
    d_ff=32768, vocab=131072, layers=_L, norm="rmsnorm", act="gelu",
    gated_mlp=True, rope="rope", n_experts=8, top_k=2, moe_ff=32768,
    softcap=30.0)

_SL = tuple(LayerSpec(kind="attn", rope_base=1e4, moe=True)
            for _ in range(2))
SMOKE = ModelCfg(
    name="grok-1-smoke", d=64, n_layers=2, heads=4, kv_heads=2, dh=16,
    d_ff=128, vocab=512, layers=_SL, norm="rmsnorm", act="gelu",
    gated_mlp=True, rope="rope", n_experts=4, top_k=2, moe_ff=128,
    softcap=30.0)

BUNDLE = ArchBundle(cfg=CFG, smoke=SMOKE, skip={
    "long_500k": "pure full attention (DESIGN.md §4)"})
