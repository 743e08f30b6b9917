"""Fisher information-guided verification prioritization (paper §5;
mirrors ``repro.core.fisher``).

Layer importance I_l = tr(F_l)/|theta_l| with F_l the Fisher information
of layer l's parameters, estimated empirically:

    tr(F_l) = E_{x, y~p(.|x)} || grad_{theta_l} log p(y|x) ||^2

The caller's log-probability function samples y from the model's own
distribution (true Fisher, not empirical Fisher with data labels); the
squared per-layer gradient norms are averaged over samples.  Selection
strategies reproduce Table 2 / Table 7: fisher (top-k by I_l), random
(uniform k-subset), uniform (every other).

``torch.func.grad`` stands in for ``jax.grad`` and an explicit
``torch.Generator`` for the JAX key: ``logprob_fn(layer_params, inputs,
generator)`` draws its labels from the generator it is given.

Security caveat (paper §5.2): this is budget allocation against
economically-motivated adversaries, not a cryptographic guarantee —
combine with random auditing (``fisher_plus_random``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree


@dataclasses.dataclass
class FisherScores:
    per_layer_trace: np.ndarray      # tr(F_l) estimates
    per_layer_params: np.ndarray     # |theta_l|
    importance: np.ndarray           # I_l = trace / params

    @property
    def total_mass(self) -> float:
        return float(self.importance.sum())


def estimate(loss_per_layer_grads: Callable, params_tree: Sequence,
             batch_inputs: torch.Tensor, generator: torch.Generator,
             n_samples: int = 4) -> FisherScores:
    """The JAX package's generic estimator, a stub there as here: the
    model-bound path is ``fisher_from_logprob_fn``."""
    raise NotImplementedError("use fisher_from_logprob_fn")


def fisher_from_logprob_fn(logprob_fn: Callable, layer_params: List,
                           inputs, generator: torch.Generator,
                           n_samples: int = 2) -> FisherScores:
    """tr(F_l) via sampled-label squared gradient norms.

    ``logprob_fn(layer_params, inputs, generator)`` must return the mean
    log-likelihood (a scalar tensor) of labels it samples with
    ``generator`` from the model's own predictive distribution, the
    sampling outside the gradient.  The generator advances across the
    ``n_samples`` calls.  Gradients are taken with ``torch.func.grad`` on
    the device the parameters lie on."""
    n_layers = len(layer_params)
    traces = np.zeros(n_layers)
    sizes = np.array([sum(x.numel() for x in pytree.tree_leaves(p))
                      for p in layer_params], dtype=np.float64)
    grad_fn = torch.func.grad(logprob_fn)
    for _s in range(n_samples):
        g = grad_fn(layer_params, inputs, generator)
        for l in range(n_layers):
            sq = sum(float((x.to(torch.float32) ** 2).sum())
                     for x in pytree.tree_leaves(g[l]))
            traces[l] += sq / n_samples
    return FisherScores(per_layer_trace=traces, per_layer_params=sizes,
                        importance=traces / np.maximum(sizes, 1.0))


# ---------------------------------------------------------------------------
# Selection strategies (Table 2 / Table 7).
# ---------------------------------------------------------------------------
def select_fisher(scores: FisherScores, k: int) -> List[int]:
    order = np.argsort(-scores.importance)
    return sorted(int(i) for i in order[:k])


def select_random(n_layers: int, k: int, seed: int) -> List[int]:
    rng = np.random.default_rng(seed)
    return sorted(int(i) for i in
                  rng.choice(n_layers, size=k, replace=False))


def select_uniform(n_layers: int, k: int) -> List[int]:
    idx = np.linspace(0, n_layers - 1, k)
    return sorted(set(int(round(i)) for i in idx))


def fisher_plus_random(scores: FisherScores, k_fisher: int, k_random: int,
                       seed: int) -> List[int]:
    """Paper's suggested defense: deterministic top-k + random audit."""
    top = set(select_fisher(scores, k_fisher))
    rest = [i for i in range(len(scores.importance)) if i not in top]
    rng = np.random.default_rng(seed)
    audit = rng.choice(len(rest), size=min(k_random, len(rest)),
                       replace=False)
    return sorted(top | {rest[int(i)] for i in audit})


def importance_coverage(scores: FisherScores, subset: Sequence[int]) -> float:
    """Fraction of total Fisher mass captured by the verified layers
    (the metric of Tables 2 and 7)."""
    tot = scores.importance.sum()
    if tot <= 0:
        return 0.0
    return float(scores.importance[list(subset)].sum() / tot)
