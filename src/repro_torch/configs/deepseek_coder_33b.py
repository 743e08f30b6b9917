"""deepseek-coder-33b [arXiv:2401.14196]: 62L d=7168 56H (GQA kv=8)
ff=19200 vocab=32256 — llama arch. 56 heads % 16 != 0 -> attention
replicated over TP (resolver rule; see DESIGN.md §5 + §Perf iteration on
head padding)."""
from repro_torch.configs.base import ArchBundle
from repro_torch.models.model import LayerSpec, ModelCfg

_L = tuple(LayerSpec(kind="attn", rope_base=1e5) for _ in range(62))
CFG = ModelCfg(
    name="deepseek-coder-33b", d=7168, n_layers=62, heads=56, kv_heads=8,
    dh=128, d_ff=19200, vocab=32256, layers=_L, norm="rmsnorm", act="silu",
    gated_mlp=True, rope="rope", attn_tp=False)

_SL = tuple(LayerSpec(kind="attn", rope_base=1e4) for _ in range(2))
SMOKE = ModelCfg(
    name="deepseek-coder-33b-smoke", d=64, n_layers=2, heads=7, kv_heads=1,
    dh=16, d_ff=160, vocab=512, layers=_SL, norm="rmsnorm", act="silu",
    gated_mlp=True, rope="rope", attn_tp=False)

BUNDLE = ArchBundle(cfg=CFG, smoke=SMOKE, skip={
    "long_500k": "pure full attention (DESIGN.md §4)"})
