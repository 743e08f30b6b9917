"""jamba-v0.1-52b [arXiv:2403.19887]: 32L d=4096 32H (GQA kv=8) ff=14336,
MoE 16e top-2 — Mamba+attention 1:7 interleave (attn at layer i%8==4),
MoE every other layer; no positional encoding on attention (jamba trait).
long_500k RUNS (hybrid SSM)."""
from repro_torch.configs.base import ArchBundle
from repro_torch.models.model import LayerSpec, ModelCfg


def _pattern(n, attn_at=4, period=8, moe_every=2):
    out = []
    for i in range(n):
        kind = "attn" if i % period == attn_at else "mamba"
        out.append(LayerSpec(kind=kind, moe=(i % moe_every == 1),
                             rope_base=1e4))
    return tuple(out)


CFG = ModelCfg(
    name="jamba-v0.1-52b", d=4096, n_layers=32, heads=32, kv_heads=8,
    dh=128, d_ff=14336, vocab=65536, layers=_pattern(32), norm="rmsnorm",
    act="silu", gated_mlp=True, rope="none", n_experts=16, top_k=2,
    moe_ff=14336,
    # §Perf hillclimb A: sort-dispatch's scatter collectives exceed the
    # einsum dispatch's compute at jamba's (E=16, d_ff=14336) shape —
    # refuted there, so jamba keeps the einsum dispatch.
    moe_dispatch="einsum")

SMOKE = ModelCfg(
    name="jamba-smoke", d=64, n_layers=4, heads=4, kv_heads=2, dh=16,
    d_ff=128, vocab=512, layers=_pattern(4, attn_at=2, period=4),
    norm="rmsnorm", act="silu", gated_mlp=True, rope="none",
    n_experts=4, top_k=2, moe_ff=128)

BUNDLE = ArchBundle(cfg=CFG, smoke=SMOKE, skip={})
