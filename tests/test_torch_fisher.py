"""Fisher-guided layer selection of repro_torch (``core/fisher.py``,
``api.select_layers``, ``ProofService(fisher_scores=...)``) against the JAX
package.  Selections are compared exactly on identical scores; the Fisher
estimate itself, a float computation, is compared at rtol 1e-5 in float32
with a log-probability function that ignores its rng (fixed labels),
written once in each framework."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as japi
from repro.core import fisher as JFI
from repro_torch import api
from repro_torch.core import blocks as B
from repro_torch.core import fisher as FI

RTOL = 1e-5      # float32 gradients of one function in two frameworks


def _scores(n, seed):
    rng = np.random.default_rng(seed)
    tr = rng.gamma(2.0, 1.0, n)
    params = rng.integers(100, 1000, n).astype(np.float64)
    pair = [cls(per_layer_trace=tr.copy(), per_layer_params=params.copy(),
                importance=tr / params) for cls in (JFI.FisherScores,
                                                     FI.FisherScores)]
    return pair


@pytest.mark.parametrize("n", [1, 2, 5, 8, 22])
def test_selection_functions_match(n):
    js, ts = _scores(n, n)
    assert js.total_mass == ts.total_mass
    for k in range(1, n + 1):
        assert FI.select_fisher(ts, k) == JFI.select_fisher(js, k)
        assert FI.select_uniform(n, k) == JFI.select_uniform(n, k)
        for seed in (0, 3, 17):
            assert FI.select_random(n, k, seed) == JFI.select_random(n, k, seed)
            for kr in range(0, n - k + 1):
                assert FI.fisher_plus_random(ts, k, kr, seed) == \
                    JFI.fisher_plus_random(js, k, kr, seed)
        sub = FI.select_fisher(ts, k)
        assert FI.importance_coverage(ts, sub) == \
            JFI.importance_coverage(js, sub)
    zero = FI.FisherScores(np.zeros(n), np.ones(n), np.zeros(n))
    assert FI.importance_coverage(zero, [0]) == 0.0


@pytest.mark.parametrize("budget", [1.0, 0.75, 0.5, 0.25, 0.1])
@pytest.mark.parametrize("audit", [0, 1, 3])
@pytest.mark.parametrize("selector", ["fisher", "uniform", "random"])
def test_select_layers_with_scores_matches(budget, audit, selector):
    n = 8
    js, ts = _scores(n, 42)
    for seed in (0, 5):
        pol = dict(budget=budget, selector=selector, audit_random=audit,
                   seed=seed)
        want = japi.select_layers(japi.VerifyPolicy(**pol), n, js)
        assert api.select_layers(api.VerifyPolicy(**pol), n, ts) == want
        # without scores the fisher selector falls back to random, as in JAX
        assert api.select_layers(api.VerifyPolicy(**pol), n) == \
            japi.select_layers(japi.VerifyPolicy(**pol), n)


# ---------------------------------------------------------------------------
# fisher_from_logprob_fn: one small classifier written in both frameworks.
# ---------------------------------------------------------------------------
def _problem():
    rng = np.random.default_rng(0)
    widths = [(6, 8), (8, 8), (8, 5)]
    layers = [dict(w=rng.normal(0, 0.5, s).astype(np.float32),
                   b=rng.normal(0, 0.1, s[1]).astype(np.float32))
              for s in widths]
    x = rng.normal(0, 1, (16, 6)).astype(np.float32)
    labels = rng.integers(0, 5, 16)
    return layers, x, labels


def _jax_logprob(labels):
    def fn(params, x, rng):
        del rng                       # fixed labels
        h = x
        for i, p in enumerate(params):
            h = h @ p["w"] + p["b"]
            if i < len(params) - 1:
                h = jnp.tanh(h)
        lp = jax.nn.log_softmax(h, axis=-1)
        return jnp.mean(lp[jnp.arange(h.shape[0]), labels])
    return fn


def _torch_logprob(labels):
    lab = torch.as_tensor(labels)

    def fn(params, x, generator):
        del generator                 # fixed labels
        h = x
        for i, p in enumerate(params):
            h = h @ p["w"] + p["b"]
            if i < len(params) - 1:
                h = torch.tanh(h)
        lp = torch.log_softmax(h, dim=-1)
        return lp[torch.arange(h.shape[0]), lab].mean()
    return fn


@pytest.mark.parametrize("n_samples", [1, 2, 3])
def test_fisher_from_logprob_fn_matches(n_samples):
    layers, x, labels = _problem()
    want = JFI.fisher_from_logprob_fn(
        _jax_logprob(labels), [{k: jnp.asarray(v) for k, v in p.items()}
                               for p in layers],
        jnp.asarray(x), jax.random.PRNGKey(0), n_samples=n_samples)
    got = FI.fisher_from_logprob_fn(
        _torch_logprob(labels), [{k: torch.as_tensor(v) for k, v in p.items()}
                                 for p in layers],
        torch.as_tensor(x), torch.Generator().manual_seed(0),
        n_samples=n_samples)
    assert np.array_equal(got.per_layer_params, want.per_layer_params)
    np.testing.assert_allclose(got.per_layer_trace, want.per_layer_trace,
                               rtol=RTOL)
    np.testing.assert_allclose(got.importance, want.importance, rtol=RTOL)
    assert FI.select_fisher(got, 2) == JFI.select_fisher(want, 2)


def test_fisher_sampling_uses_the_generator():
    """A label-sampling function draws from the generator it is handed:
    the same seed gives the same scores, and the samples differ."""
    layers, x, _ = _problem()
    params = [{k: torch.as_tensor(v) for k, v in p.items()} for p in layers]
    seen = []

    def fn(ps, xx, generator):
        h = xx
        for i, p in enumerate(ps):
            h = h @ p["w"] + p["b"]
            if i < len(ps) - 1:
                h = torch.tanh(h)
        lp = torch.log_softmax(h, dim=-1)
        y = torch.multinomial(lp.detach().exp(), 1, generator=generator)[:, 0]
        seen.append(y.clone())
        return lp[torch.arange(h.shape[0]), y].mean()

    a = FI.fisher_from_logprob_fn(fn, params, torch.as_tensor(x),
                                  torch.Generator().manual_seed(3), 2)
    b = FI.fisher_from_logprob_fn(fn, params, torch.as_tensor(x),
                                  torch.Generator().manual_seed(3), 2)
    assert np.array_equal(a.per_layer_trace, b.per_layer_trace)
    assert torch.equal(seen[0], seen[2]) and not torch.equal(seen[0], seen[1])


def test_service_proves_the_fisher_selection():
    """ProofService keeps its scores and proves exactly the layers
    select_fisher picks; the port's verifier accepts the attestation."""
    cfg = B.BlockCfg(family="gpt2", d=8, dff=16, heads=1, kv_heads=1, dh=8,
                     seq=4)
    rng = np.random.default_rng(1234)
    weights = [B.init_weights(cfg, rng) for _ in range(2)]
    scores = FI.FisherScores(per_layer_trace=np.array([1.0, 9.0]),
                             per_layer_params=np.ones(2),
                             importance=np.array([1.0, 9.0]))
    query = np.clip(np.round(np.random.default_rng(5678).normal(
        0, 0.5, (cfg.d_pad, cfg.seq)) * 256), -32768, 32767).astype(np.int64)
    policy = api.VerifyPolicy(budget=0.5, selector="fisher", pcs_queries=1)
    with api.ProofService([cfg] * 2, weights, default_queries=1,
                          fisher_scores=scores, device="cpu") as svc:
        assert svc.fisher_scores is scores
        att = svc.attest(query, policy)
        card = svc.model_card.to_bytes()
    assert att.proved_layers == FI.select_fisher(scores, 1) == [1]
    rep = api.verify(att.to_bytes(2), query, card, policy, device="cpu")
    assert rep.ok, rep.reason
    assert rep.checked_layers == 1
