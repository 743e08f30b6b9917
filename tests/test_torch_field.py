"""repro_torch.core.field against repro.core.field: Fp and Fp4 on 10k random
operands plus the edge words 0, 1, P-1, P-2, exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import field as JF
from repro_torch.core import field as F

P = JF.P
EDGES = np.array([0, 1, P - 1, P - 2], dtype=np.uint32)
N = 10_000


def _words(seed, shape):
    a = np.random.default_rng(seed).integers(0, P, size=shape,
                                             dtype=np.int64).astype(np.uint32)
    flat = a.reshape(-1)
    k = min(flat.size, 16)
    flat[:k] = np.repeat(EDGES, 4)[:k]           # every edge pair appears
    flat[k:2 * k] = np.tile(EDGES, 4)[:k]
    return a


def _t(a):
    return F.tensor(a, "cpu")


def _eq(jax_out, torch_out):
    assert np.array_equal(np.asarray(jax_out), F.to_np(torch_out))


@pytest.fixture(scope="module")
def ab():
    return _words(1, (N,)), _words(2, (N,))


@pytest.mark.parametrize("op", ["fmul", "fadd", "fsub"])
def test_binary_ops(ab, op):
    a, b = ab
    _eq(getattr(JF, op)(jnp.asarray(a), jnp.asarray(b)),
        getattr(F, op)(_t(a), _t(b)))


@pytest.mark.parametrize("op", ["fneg", "finv", "to_mont", "from_mont"])
def test_unary_ops(ab, op):
    a, _ = ab
    _eq(getattr(JF, op)(jnp.asarray(a)), getattr(F, op)(_t(a)))


def test_fpow_and_consts(ab):
    a, _ = ab
    for e in (0, 1, 2, 7, 12345, P - 2):
        _eq(JF.fpow(jnp.asarray(a[:256]), e), F.fpow(_t(a[:256]), e))
    for v in (0, 1, 2, -1, 256, P - 1, 2**40 + 3):
        assert np.array_equal(JF.fconst(v, (3,)), F.to_np(F.fconst(v, (3,), "cpu")))
    ints = np.random.default_rng(3).integers(-2**40, 2**40, size=500)
    _eq(JF.f_from_int(ints), F.f_from_int(ints, "cpu"))
    assert np.array_equal(JF.f_to_int(JF.f_from_int(ints)),
                          F.f_to_int(F.f_from_int(ints, "cpu")))


@pytest.fixture(scope="module")
def ab4():
    return _words(4, (N, 4)), _words(5, (N, 4))


def test_f4mul(ab4):
    a, b = ab4
    _eq(JF.f4mul(jnp.asarray(a), jnp.asarray(b)), F.f4mul(_t(a), _t(b)))


@pytest.mark.parametrize("lead", [(), (3,), "weight", "column"])
def test_f4mul_in_pieces(ab4, monkeypatch, lead):
    """A product longer than F4_CHUNK elements, taken piece by piece (here
    pieces of 999, the last one short; a broadcast operand among them: one
    Fp4 weight against a table as the eq vector's, a (1, 4) factor as
    eq_points', a row against a stack), equals the JAX package's."""
    a, b = ab4
    monkeypatch.setattr(F, "F4_CHUNK", 999)
    if lead == (3,):
        a3 = a[:3000].reshape(3, 1000, 4)
        want = JF.f4mul(jnp.asarray(a3), jnp.asarray(b[:1000]))
        _eq(want, F.f4mul(_t(a3), _t(b[:1000])))
    elif lead == "weight":
        _eq(JF.f4mul(jnp.asarray(b[7]), jnp.asarray(a)), F.f4mul(_t(b[7]), _t(a)))
    elif lead == "column":
        _eq(JF.f4mul(jnp.asarray(a), jnp.asarray(b[3:4])),
            F.f4mul(_t(a), _t(b[3:4])))
    else:
        _eq(JF.f4mul(jnp.asarray(a), jnp.asarray(b)), F.f4mul(_t(a), _t(b)))
        _eq(JF.f4inv(jnp.asarray(a[:2000])), F.f4inv(_t(a[:2000])))


def test_f4inv(ab4):
    a, _ = ab4
    _eq(JF.f4inv(jnp.asarray(a[:2000])), F.f4inv(_t(a[:2000])))


def test_f4_base_ops(ab4, ab):
    a4, _ = ab4
    b, _ = ab
    _eq(JF.f4mul_base(jnp.asarray(a4), jnp.asarray(b)),
        F.f4mul_base(_t(a4), _t(b)))
    _eq(JF.f4_from_base(jnp.asarray(b)), F.f4_from_base(_t(b)))
    _eq(JF.f4one((2, 3)), F.f4one((2, 3), "cpu"))


def test_tensor_boundary_roundtrip(ab):
    a, _ = ab
    t = F.tensor(a, "cpu")
    assert t.dtype == torch.int64
    out = F.to_np(t)
    assert out.dtype == np.uint32 and np.array_equal(out, a)
