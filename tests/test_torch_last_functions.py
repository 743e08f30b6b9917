"""The last public functions of the JAX package that the port had left
out, against the reference: ``gateway.metrics.merge_batch_sizes`` on a
snapshot of each package's ``GatewayMetrics`` fed the same windows;
``core.circuit.scaled`` and ``vadd`` (the same ``Affine`` terms, mod P, and
a prove/verify round trip of a ``g_lin_relation`` over them whose
transcript ends in the JAX prover's state); and ``core.fisher.estimate``,
a stub in both packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import circuit as JC
from repro.core import fisher as JFISH
from repro.core import pcs as JPCS
from repro.core.transcript import Transcript as JTranscript
from repro.gateway import metrics as JMET
from repro_torch.core import circuit as C
from repro_torch.core import field as F
from repro_torch.core import fisher as FISH
from repro_torch.core import pcs as PCS
from repro_torch.core.transcript import Transcript
from repro_torch.gateway import metrics as MET

WINDOWS = [(1, [0.01], 3), (4, [0.2, 0.1, 0.05, 0.0], 0), (2, [0.3, 0.4], 1),
           (1, [0.02], 0), (7, [0.5] * 7, 2), (4, [0.0] * 4, 0)]


def test_merge_batch_sizes_matches_reference():
    jm, tm = JMET.GatewayMetrics(), MET.GatewayMetrics()
    for size, waits, depth in WINDOWS:
        jm.on_window(size, waits, depth)
        tm.on_window(size, waits, depth)
    want = JMET.merge_batch_sizes(jm.snapshot())
    got = MET.merge_batch_sizes(tm.snapshot())
    assert got == want
    assert sum(v for _, v in got) == len(WINDOWS) and all(v for _, v in got)
    assert MET.merge_batch_sizes(MET.GatewayMetrics().snapshot()) == \
        JMET.merge_batch_sizes(JMET.GatewayMetrics().snapshot()) == []


def _plain(v):
    """A view of either package as nested tuples of its fields."""
    if dataclasses.is_dataclass(v):
        return (type(v).__name__,) + tuple(
            _plain(getattr(v, f.name)) for f in dataclasses.fields(v))
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


@pytest.mark.parametrize("c", [0, 3, -1, F.P + 5, -(F.P + 2)])
def test_scaled_and_vadd_terms_match_reference(c):
    a, b = C.Slice("w", 0, 3), C.Slice("w", 8, 3)
    ja, jb = JC.Slice("w", 0, 3), JC.Slice("w", 8, 3)
    got, want = C.scaled(a, c), JC.scaled(ja, c)
    assert _plain(got) == _plain(want)
    assert got.terms[0][0] == c % F.P
    got = C.vadd(a, C.scaled(b, c), a)
    want = JC.vadd(ja, JC.scaled(jb, c), ja)
    assert _plain(got) == _plain(want)
    assert [t[0] for t in got.terms] == [1, 1, 1]


def _values(z_off=0):
    """x, y and z = 3 x - y + 5 (z_off added to z[2]) in one vector."""
    rng = np.random.default_rng(9)
    x = rng.integers(-1000, 1000, 8)
    y = rng.integers(-1000, 1000, 8)
    z = 3 * x - y + 5
    z[2] += z_off
    return np.concatenate([x, y, z, np.zeros(8, np.int64)])


def _relation(mod, ctx):
    """z - (3 x + (-1) y) - 5 == 0, written with scaled and vadd."""
    x, y, z = (mod.Slice("w", 8 * i, 3) for i in range(3))
    lhs = mod.vadd(mod.scaled(x, 3), mod.scaled(y, -1))
    return mod.g_lin_relation(ctx, [(1, z), (-1, lhs)], -5, "lin", log_n=3)


def test_lin_relation_over_scaled_and_vadd_round_trip():
    vals = _values()
    params = PCS.PCSParams(queries=2)
    pt = Transcript("circuit", "cpu")
    prover = C.ProverCtx(pt, params)
    prover.commit("w", vals)
    _relation(C, prover)
    tape = prover.finalize()
    vt = Transcript("circuit", "cpu")
    verifier = C.VerifierCtx(vt, params, tape)
    verifier.commit("w", len(vals))
    _relation(C, verifier)
    verifier.finalize()
    assert np.array_equal(F.to_np(vt.state), F.to_np(pt.state))
    # the JAX package's prover runs the same transcript
    jt = JTranscript("circuit")
    jprover = JC.ProverCtx(jt, JPCS.PCSParams(queries=2))
    jprover.commit("w", vals)
    _relation(JC, jprover)
    jprover.finalize()
    assert np.array_equal(np.asarray(jt.state), F.to_np(pt.state))
    # a relation that does not hold fails on the prover's own check
    bad = C.ProverCtx(Transcript("circuit", "cpu"), params)
    bad.commit("w", _values(z_off=1))
    with pytest.raises(C.ProofError, match="lin"):
        _relation(C, bad)


def test_fisher_estimate_is_the_reference_stub():
    with pytest.raises(NotImplementedError) as want:
        JFISH.estimate(None, [], jnp.zeros(1), None)
    with pytest.raises(NotImplementedError) as got:
        FISH.estimate(None, [], None, None)
    assert str(got.value) == str(want.value) == "use fisher_from_logprob_fn"
