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


# n = 2..256 for every d; for d = 2 also the tail length n_tail = 4096 and
# 2 n_tail, where the kernel switches from the tail block to head rounds
# (d = 1 and 3 would each add seconds of per-shape JAX compiles).
_REF_LENGTHS = {1: [1 << m for m in range(1, 9)],
                2: [1 << m for m in range(1, 9)] + [4096, 8192],
                3: [1 << m for m in range(1, 9)]}


@pytest.mark.parametrize("d", [1, 2, 3])
def test_k3_plain_matches_reference_prover(d):
    rng = np.random.default_rng(d)
    for n in _REF_LENGTHS[d]:
        m = n.bit_length() - 1
        K = 1 + m % 3 if n <= 256 else 1
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


def test_k3_tail_fits_shared_memory():
    """The tail block keeps d factors of n_tail u32 Fp4 words (16 B each) in
    shared memory, plus 32 x 16 words of reduction scratch and c: inside the
    227 KB a block may have on the H100, and n_tail is the largest power of
    two within the 196,608 B given to the factors."""
    assert {d: K3.tail_len(d) for d in (1, 2, 3)} == {1: 8192, 2: 4096, 3: 4096}
    for d in (1, 2, 3):
        nt = K3.tail_len(d)
        assert 16 * d * nt <= K3.TAIL_SMEM_BYTES < 16 * d * 2 * nt
        assert 16 * d * K3.plan(d, nt).n_tail + 32 * 16 * 4 + 16 <= 232_448


@pytest.mark.parametrize("d,n,head,n_tail,launches", [
    (1, 2, 0, 2, 1), (2, 2, 0, 2, 1), (3, 2, 0, 2, 1),
    (1, 8192, 0, 8192, 1), (1, 16384, 1, 8192, 3),
    (2, 2048, 0, 2048, 1), (2, 4096, 0, 4096, 1), (2, 8192, 1, 4096, 3),
    (3, 4096, 0, 4096, 1), (3, 8192, 1, 4096, 3), (3, 1 << 17, 5, 4096, 11),
    (2, 1 << 19, 7, 4096, 15), (2, 1 << 21, 9, 4096, 19),
])
def test_k3_plan(d, n, head, n_tail, launches):
    pl = K3.plan(d, n)
    assert (pl.rounds, pl.head_rounds, pl.n_tail, pl.launches) == \
        (n.bit_length() - 1, head, n_tail, launches)
    assert pl.head_rounds + (pl.n_tail.bit_length() - 1) == pl.rounds
    assert 32 <= pl.tail_threads <= K3.TAIL_THREADS and pl.tail_threads % 32 == 0
    w = 4 * (d + 1)
    # partials for h >= 1; two ping-pong buffers of n/2 and n/4 once a
    # head fold runs (h >= 2)
    want = (pl.head_blocks * w if head else 0) + \
        (d * (n // 2 + n // 4) * 4 if head >= 2 else 0)
    assert pl.scratch_words == want
    assert K3.plan(d, n, K=3).scratch_words == 3 * want


# (d, n) -> claims in one attest of the served chain (K = 1 each): 149
# sum-checks, 1,331 rounds.  A copy of the wrapper's calls recorded during
# one attest; the table is tied to the served path only by chip_smoke.py,
# whose serve phase counts the launches on the card.
_SERVED_CLAIMS = {
    (3, 1024): 24, (2, 128): 20, (2, 1024): 16, (2, 32): 16, (3, 256): 16,
    (2, 8): 16, (2, 2048): 8, (3, 2048): 5, (2, 512): 4, (3, 4096): 4,
    (3, 16): 4, (3, 1 << 17): 4, (2, 1 << 17): 4, (2, 1 << 19): 4,
    (2, 1 << 20): 4,
}
_SERVED_OLD_LAUNCHES = 3_993
# 133 claims fit the tail (1 launch each); per layer 11 + 11 + 15 + 17
# for 2^17 at d = 3 and d = 2, 2^19 and 2^20
_SERVED_LAUNCHES = 133 + 4 * (11 + 11 + 15 + 17)


def test_k3_launches_of_the_served_attest():
    """The launch plan over the sum-checks of one attest of the served
    d=128 chain (4 gpt2 layers, 16 PCS queries), as recorded in
    _SERVED_CLAIMS: 3,993 launches before this design (three per round),
    now one per claim that fits the tail and 2 h + 1 per longer one.  The
    table is a copy, not a count; chip_smoke.py measures the launches of
    the served path itself."""
    assert sum(_SERVED_CLAIMS.values()) == 149
    rounds = sum(c * (n.bit_length() - 1) for (_, n), c in _SERVED_CLAIMS.items())
    assert 3 * rounds == _SERVED_OLD_LAUNCHES
    total = sum(c * K3.plan(d, n).launches for (d, n), c in _SERVED_CLAIMS.items())
    assert total == _SERVED_LAUNCHES


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
