"""AdamW with decoupled weight decay and a cosine schedule (mirrors
``repro.optim.adamw``).

The moments are float32 and the parameters keep their dtype.  ``update``
writes the parameters and the moments **in place** (under
``torch.no_grad``): the counterpart of the JAX step's donated buffers
(``donate_argnums``), so that the step's peak memory does not hold two
copies of the parameters.  The arithmetic is the JAX package's, in
float32 and in its order; ``global_norm`` sums the leaves in JAX's leaf
order (``repro_torch._tree``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.models.layers import P


@dataclasses.dataclass(frozen=True)
class AdamWCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Any
    v: Any


def init(params) -> AdamWState:
    """Zero float32 moments beside each parameter, step 0 on the
    parameters' device."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v=tree_map(torch.clone, zeros))


def _copy_specs(specs):
    if isinstance(specs, dict):
        return {k: _copy_specs(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_copy_specs(v) for v in specs]
    return specs


def state_specs(p_specs) -> AdamWState:
    """Optimizer-state partition specs mirror the parameter specs (the
    port's ``P`` tuples are leaves of the dict/list spec tree)."""
    return AdamWState(step=P(), m=p_specs, v=_copy_specs(p_specs))


def schedule(cfg: AdamWCfg, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to 0.1 lr; float32, as JAX."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(torch.float32) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWCfg, state: AdamWState, params, grads):
    """Returns (params, new_state, metrics); ``params`` and the state's
    moments are the same tensors as given, updated in place."""
    step = state.step + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(cfg.b2, step.to(torch.float32))
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        gf = g.to(torch.float32)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gf * scale)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(gf * scale))
        pf = p.to(torch.float32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + \
            cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gn, "lr": lr}
