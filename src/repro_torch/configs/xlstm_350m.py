"""xlstm-350m [arXiv:2405.04517]: 24L d=1024 4H, d_ff=0 (no FFN sublayer)
vocab=50304 — mLSTM blocks with sLSTM every 4th layer (documented choice;
the paper's 350M uses a mostly-mLSTM mix). Attention-free: long_500k RUNS
(recurrent state, O(1) per decode step)."""
from repro_torch.configs.base import ArchBundle
from repro_torch.models.model import LayerSpec, ModelCfg


def _pattern(n):
    return tuple(LayerSpec(kind="slstm" if i % 4 == 3 else "mlstm")
                 for i in range(n))


CFG = ModelCfg(
    name="xlstm-350m", d=1024, n_layers=24, heads=4, kv_heads=4, dh=256,
    d_ff=0, vocab=50304, layers=_pattern(24), norm="layernorm",
    act="gelu", gated_mlp=False, rope="none", attn_tp=False)

SMOKE = ModelCfg(
    name="xlstm-350m-smoke", d=64, n_layers=4, heads=2, kv_heads=2, dh=32,
    d_ff=0, vocab=512, layers=_pattern(4), norm="layernorm", act="gelu",
    gated_mlp=False, rope="none", attn_tp=False)

BUNDLE = ArchBundle(cfg=CFG, smoke=SMOKE, skip={})
