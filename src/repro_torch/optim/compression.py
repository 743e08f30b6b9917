"""Int8 gradient compression with error feedback (mirrors
``repro.optim.compression``).

Used by the training loop between microbatch accumulation and the
optimizer: gradients are quantized to int8 with a per-tensor float32
scale of max|g + residual| / 127 (round half to even, as ``jnp.round``),
and the quantization residual is carried to the next step (error
feedback keeps the scheme unbiased in the long run).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch._tree import tree_map


class EFState(NamedTuple):
    residual: Any


def init_ef(params) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def compress(g: torch.Tensor, res: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float grad + carried residual -> (int8 codes, scale, new residual)."""
    gf = g.to(torch.float32) + res
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_res = gf - q.to(torch.float32) * scale
    return q, scale, new_res


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, ef: EFState):
    qs = tree_map(compress, grads, ef.residual)

    def part(i):
        return tree_map(lambda t: t[i], qs,
                        is_leaf=lambda t: isinstance(t, tuple))
    return part(0), part(1), EFState(residual=part(2))


def decompress_tree(codes, scales):
    return tree_map(decompress, codes, scales)
