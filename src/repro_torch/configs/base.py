"""Architecture registry (mirrors ``repro.configs.base``): each assigned
architecture contributes its full config, a reduced smoke config and a
shape skip-list with reasons.  The configs are data, the same field for
field as the JAX package's, with ``dtype`` a torch dtype.

Shapes follow the brief:
  train_4k     seq 4096  x global_batch 256   (train_step)
  prefill_32k  seq 32768 x global_batch 32    (prefill forward)
  decode_32k   one token, KV len 32768, batch 128 (serve_step)
  long_500k    one token, KV len 524288, batch 1  (sub-quadratic only)
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

import torch

from repro_torch.models.layers import P
from repro_torch.models.model import ModelCfg

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, mode="train"),
    "prefill_32k": dict(seq=32768, batch=32, mode="prefill"),
    "decode_32k": dict(seq=32768, batch=128, mode="decode"),
    "long_500k": dict(seq=524288, batch=1, mode="decode"),
}

ARCHS = [
    "qwen1_5_0_5b", "deepseek_coder_33b", "granite_3_8b", "gemma3_1b",
    "jamba_v0_1_52b", "whisper_small", "xlstm_350m", "grok_1_314b",
    "moonshot_v1_16b_a3b", "qwen2_vl_72b",
    # paper's own evaluation families
    "gpt2_small", "tinyllama_1_1b",
]


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    cfg: ModelCfg
    smoke: ModelCfg
    skip: Dict[str, str]                    # shape -> reason
    overrides: Dict[str, Dict] = dataclasses.field(default_factory=dict)

    def shape_params(self, shape: str) -> Optional[Dict]:
        if shape in self.skip:
            return None
        base = dict(SHAPES[shape])
        base.update(self.overrides.get(shape, {}))
        return base


def get_arch(name: str) -> ArchBundle:
    name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.BUNDLE


def input_specs(cfg: ModelCfg, shape_params: Dict, dp_axes=("data",),
                multi_pod: bool = False) -> Dict:
    """The inputs of one dry-run cell as ``meta`` tensors (int32, as the
    JAX package's), with their partition specs under ``"specs"``: the
    batch is sharded over ``dp_axes`` when it divides by 16."""
    seq, batch, mode = (shape_params["seq"], shape_params["batch"],
                        shape_params["mode"])
    dp = dp_axes if batch % 16 == 0 else None

    def ints(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")
    if mode == "train":
        return {"tokens": ints(batch, seq), "labels": ints(batch, seq),
                "specs": {"tokens": P(dp, None), "labels": P(dp, None)}}
    if mode == "prefill":
        return {"tokens": ints(batch, seq), "specs": {"tokens": P(dp, None)}}
    # decode: one new token against a cache of length `seq`
    return {"token": ints(batch, 1), "pos": ints(batch), "cache_len": seq,
            "specs": {"token": P(dp, None), "pos": P(dp)}}
