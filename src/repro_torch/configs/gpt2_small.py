"""GPT-2 Small (paper's own evaluation model, Radford et al. 2019):
12L d=768 12H ff=3072 vocab=50257, LayerNorm + GELU + learned positions.
Also exposes the paper's width-sweep variants (Table 3: d in
{64,128,256,512,768}) through `width_variant`."""

from repro_torch.configs.base import ArchBundle
from repro_torch.models.model import LayerSpec, ModelCfg


def _mk(d, heads, n_layers=12, vocab=50257, max_pos=1024):
    return ModelCfg(
        name=f"gpt2-d{d}", d=d, n_layers=n_layers, heads=heads,
        kv_heads=heads, dh=d // heads, d_ff=4 * d, vocab=vocab,
        layers=tuple(LayerSpec(kind="attn") for _ in range(n_layers)),
        norm="layernorm", act="gelu", gated_mlp=False, qkv_bias=True,
        rope="none", pos_embed=max_pos, tie_embeddings=True,
        attn_tp=(heads % 16 == 0), max_seq=max_pos)


CFG = _mk(768, 12)
SMOKE = _mk(64, 4, n_layers=2, vocab=512, max_pos=128)


def width_variant(d: int) -> ModelCfg:
    heads = {64: 4, 128: 4, 256: 8, 512: 8, 768: 12}[d]
    return _mk(d, heads)


BUNDLE = ArchBundle(
    cfg=CFG, smoke=SMOKE,
    skip={"long_500k": "full attention + 1024 learned positions",
          "prefill_32k": "1024 learned positions",
          "decode_32k": "1024 learned positions (run at native 1024)"},
    overrides={"train_4k": dict(seq=1024)})
