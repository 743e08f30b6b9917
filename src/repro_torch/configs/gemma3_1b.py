"""gemma3-1b [hf:google/gemma-3-1b-pt]: 26L d=1152 4H (GQA kv=1, dh=256)
ff=6912 vocab=262144 — 5:1 local:global attention, window 512, local rope
1e4 / global rope 1e6. 4 heads -> attention replicated over TP; MLP and
the 256k vocab carry the TP sharding. long_500k RUNS: decode is dominated
by the window-sized local caches + seq-sharded global caches."""
from repro_torch.configs.base import ArchBundle
from repro_torch.models.model import LayerSpec, ModelCfg


def _pattern(n):
    out = []
    for i in range(n):
        if i % 6 == 5:
            out.append(LayerSpec(kind="attn", window=0, rope_base=1e6))
        else:
            out.append(LayerSpec(kind="attn", window=512, rope_base=1e4))
    return tuple(out)


CFG = ModelCfg(
    name="gemma3-1b", d=1152, n_layers=26, heads=4, kv_heads=1, dh=256,
    d_ff=6912, vocab=262144, layers=_pattern(26), norm="rmsnorm",
    act="gelu", gated_mlp=True, rope="rope", tie_embeddings=True,
    attn_tp=False)

SMOKE = ModelCfg(
    name="gemma3-1b-smoke", d=64, n_layers=3, heads=2, kv_heads=1, dh=32,
    d_ff=128, vocab=512, layers=_pattern(3)[:3], norm="rmsnorm",
    act="gelu", gated_mlp=True, rope="rope", tie_embeddings=True,
    attn_tp=False)

BUNDLE = ArchBundle(cfg=CFG, smoke=SMOKE, skip={})
