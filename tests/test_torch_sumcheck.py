"""The K3 plain version and the port's sum-check prover/verifier against
the JAX package, exact equality.

Two JAX references: the fused kernel path ``repro.kernels.ops.
sumcheck_prove_rounds`` (all four outputs, g(0) included) on small shapes —
each new (K, n, d) costs a multi-second trace on the CPU — and the
reference prover ``repro.core.sumcheck.prove`` run claim by claim from the
same sponge state, which shares its per-round compiles across n, for the
sweep over d = 1..3, n = 2..256 and K = 1..3.  The reference proof drops
g(0), but both sides absorb the full g, so equal sponge states pin it.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import sumcheck as JSC
from repro.core import transcript as JT
from repro.kernels import ops as KOPS
from repro_torch.core import field as F
from repro_torch.core import sumcheck as SC
from repro_torch.core import transcript as T
from repro_torch.kernels import sumcheck_round as K3

P = F.P


def _words(rng, shape):
    a = rng.integers(0, P, size=shape, dtype=np.int64)
    flat = a.reshape(-1)
    k = min(4, flat.size)
    flat[:k] = [0, 1, P - 1, P - 2][:k]
    return a.astype(np.uint32)


def _t(a):
    return F.tensor(a, "cpu")


@pytest.mark.parametrize("K,n,d", [(1, 2, 3), (2, 2, 2), (3, 2, 1)])
def test_k3_plain_matches_fused_kernel_path(K, n, d):
    rng = np.random.default_rng(100 * K + 10 * n + d)
    fs = [_words(rng, (K, n, 4)) for _ in range(d)]
    st = _words(rng, (K, 16))
    want = KOPS.sumcheck_prove_rounds(tuple(jnp.asarray(f) for f in fs),
                                      jnp.asarray(st))
    got = K3.prove_rounds_plain([_t(f) for f in fs], _t(st))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), F.to_np(g))


def _reference_claim(factors, state):
    """JAX reference prover on one claim from a given sponge state."""
    tr = JT.Transcript("k3-parity")
    tr.set_state(jnp.asarray(state))
    proof, point = JSC.prove([jnp.asarray(f) for f in factors], tr)
    return proof, np.asarray(point), np.asarray(tr.state)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_k3_plain_matches_reference_prover(d):
    rng = np.random.default_rng(d)
    for m in range(1, 9):
        n = 1 << m
        K = 1 + m % 3
        fs = [_words(rng, (K, n, 4)) for _ in range(d)]
        st = _words(rng, (K, 16))
        rp, pts, finals, states = K3.prove_rounds_plain(
            [_t(f) for f in fs], _t(st))
        for k in range(K):
            proof, point, state = _reference_claim([f[k] for f in fs], st[k])
            assert np.array_equal(proof.round_polys, F.to_np(rp[k, :, 1:]))
            assert np.array_equal(proof.final_evals, F.to_np(finals[k]))
            assert np.array_equal(point, F.to_np(pts[k]))
            assert np.array_equal(state, F.to_np(states[k]))


@pytest.mark.parametrize("n,d", [(1, 2), (16, 2), (64, 3)])
def test_prove_matches_and_verifies(n, d):
    rng = np.random.default_rng(7 * n + d)
    fs = [_words(rng, (n, 4)) for _ in range(d)]
    jtr, ttr = JT.Transcript("sc"), T.Transcript("sc", device="cpu")
    jproof, jpt = JSC.prove([jnp.asarray(f) for f in fs], jtr)
    tproof, tpt = SC.prove([_t(f) for f in fs], ttr)
    assert np.array_equal(jproof.round_polys, tproof.round_polys)
    assert np.array_equal(jproof.final_evals, tproof.final_evals)
    assert np.array_equal(np.asarray(jpt), F.to_np(tpt))
    assert np.array_equal(np.asarray(jtr.state), F.to_np(ttr.state))
    # the claimed sum, then the port's verifier on a fresh transcript
    from repro_torch.core.mle import fsum
    prod = _t(fs[0])
    for f in fs[1:]:
        prod = F.f4mul(prod, _t(f))
    total = fsum(prod, axis=0)
    ok, pt, finals = SC.verify(total, tproof, d, T.Transcript("sc", device="cpu"))
    assert ok and np.array_equal(F.to_np(pt), F.to_np(tpt))
    if tproof.round_polys.shape[0]:
        bad = SC.SumcheckProof(round_polys=tproof.round_polys.copy(),
                               final_evals=tproof.final_evals)
        bad.round_polys[0, 0, 0] ^= 1
        assert not SC.verify(total, bad, d, T.Transcript("sc", device="cpu"))[0]
