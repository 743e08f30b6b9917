"""The model zoo's layers of repro_torch against the JAX package's at
float32, on the same numpy-seeded inputs and the same parameters (the JAX
draws, crossed as numpy): M-RoPE with three distinct position streams,
cross-attention, the MoE (both dispatches, the aux loss, the capacity
rule), Mamba, mLSTM and sLSTM (prefill, then decode steps through the
cache).

Tolerances, as tests/test_torch_models.py (``scale`` is the largest |x|
of the JAX side): rtol 1e-4, atol 1e-4 x scale; the LUT path rtol 1e-3,
atol 1e-3 x scale.  The packages sum their float32 products in different
orders (Mamba's chunk scan also composes its pairs in another tree: a
doubling scan against ``jax.lax.associative_scan``), nothing more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import mamba as JMB
from repro.models import xlstm as JX
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import xlstm as X

EXACT = dict(rtol=1e-4, scale_atol=1e-4)
LUT = dict(rtol=1e-3, scale_atol=1e-3)
JSH = JL.ShardCfg(dp=("data",), tp_size=1, dp_size=1)
SH = L.ShardCfg(dp=("data",), tp_size=1, dp_size=1)


def _close(jx, tx, rtol, scale_atol):
    jx = np.asarray(jx, np.float32)
    tx = tx.float().numpy()
    assert jx.shape == tx.shape
    scale = float(np.abs(jx).max())
    np.testing.assert_allclose(tx, jx, rtol=rtol, atol=scale_atol * scale)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, int):
        return tree
    return torch.from_numpy(np.asarray(tree, np.float32).copy())


def _params(defs, seed):
    """JAX parameters at float32 (the defs' dtype replaced) and the same
    values as torch tensors."""
    defs = jax.tree_util.tree_map(
        lambda d: JL.ParamDef(d.shape, d.spec, d.init_scale, jnp.float32,
                              d.zero),
        defs, is_leaf=lambda x: isinstance(x, JL.ParamDef))
    jp = JL.init_params(defs, jax.random.PRNGKey(seed))
    # the zero-initialised gains and biases get values too
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if not np.any(np.asarray(a)) else a, jp)
    return jp, _to_torch(jax.tree_util.tree_map(np.asarray, jp))


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# M-RoPE and cross-attention.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sections", [None, (4, 6, 6), (8, 4, 4)])
def test_apply_mrope_three_distinct_streams(sections):
    x = _x(0, (2, 7, 3, 32))
    rng = np.random.default_rng(1)
    pos3 = np.stack([rng.integers(0, 50, (2, 7)) for _ in range(3)])
    assert not np.array_equal(pos3[0], pos3[1])
    assert not np.array_equal(pos3[1], pos3[2])
    jo = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), sections, 1e4)
    to = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), sections,
                       1e4)
    _close(jo, to, **EXACT)
    # equal streams make it plain RoPE, in both packages
    same = np.broadcast_to(pos3[:1], pos3.shape)
    to_same = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(same.copy()),
                            sections, 1e4)
    _close(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos3[0]), 1e4), to_same,
           **EXACT)


def test_apply_mrope_rejects_sections_that_miss_dh():
    with pytest.raises(ValueError, match="cover"):
        L.apply_mrope(torch.zeros(1, 2, 1, 16), torch.zeros(3, 1, 2), (2, 2, 2))


@pytest.mark.parametrize("use_lut", [False, True])
def test_cross_attention_longer_source(use_lut):
    """x_kv of 12 frames, x of 5 tokens: K and V take the source's length,
    every key is visible, the causal flag and the positions play no part."""
    jcfg = JL.AttnCfg(d=32, heads=4, kv_heads=2, dh=8, qkv_bias=True,
                      rope="none", causal=False)
    cfg = L.AttnCfg(d=32, heads=4, kv_heads=2, dh=8, qkv_bias=True,
                    rope="none", causal=False)
    jp, tp = _params(JL.attn_defs(jcfg, JSH), 3)
    x, xkv = _x(4, (2, 5, 32)), _x(5, (2, 12, 32))
    jo, jc = JL.attention(jcfg, JSH, jp, jnp.asarray(x), jnp.arange(5),
                          use_lut, None, x_kv=jnp.asarray(xkv))
    to, tc = L.attention(cfg, SH, tp, torch.from_numpy(x), torch.arange(5),
                         use_lut, None, x_kv=torch.from_numpy(xkv))
    assert jc is None and tc is None
    _close(jo, to, **(LUT if use_lut else EXACT))


# ---------------------------------------------------------------------------
# MoE.
# ---------------------------------------------------------------------------
def _moe_pair(capacity_factor, E=4, K=2, d=16, d_ff=32, seed=0):
    jmc = JL.MoeCfg(d=d, d_ff=d_ff, n_experts=E, top_k=K,
                    capacity_factor=capacity_factor)
    mc = L.MoeCfg(d=d, d_ff=d_ff, n_experts=E, top_k=K,
                  capacity_factor=capacity_factor)
    jp, tp = _params(JL.moe_defs(jmc, JSH), seed)
    return jmc, mc, jp, tp


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_matches_jax(dispatch, capacity_factor):
    """Output and aux loss of both dispatches; at capacity factor 0.5 an
    expert's slots overflow, so the dropped assignments are exercised."""
    jmc, mc, jp, tp = _moe_pair(capacity_factor)
    x = _x(6, (2, 16, 16))
    jo, jaux = JL.moe(jmc, JSH, jp, jnp.asarray(x), dispatch=dispatch)
    to, taux = L.moe(mc, SH, tp, torch.from_numpy(x), dispatch=dispatch)
    _close(jo, to, **EXACT)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    # the capacity rule, and whether this input overflows it
    T, E, K = 32, mc.n_experts, mc.top_k
    cap = L.moe_capacity(mc, T)
    assert cap == min(max(int(np.ceil(capacity_factor * K * T / E)), 4), T * K)
    logits = x.reshape(T, -1) @ np.asarray(jp["router"])
    top = np.argsort(-logits, axis=1)[:, :K]
    overflow = np.bincount(top.reshape(-1), minlength=E).max() > cap
    assert overflow == (capacity_factor == 0.5)


def test_moe_lut_matches_jax():
    jmc, mc, jp, tp = _moe_pair(1.25, seed=1)
    x = _x(7, (2, 8, 16))
    jo, _ = JL.moe(jmc, JSH, jp, jnp.asarray(x), use_lut=True)
    to, _ = L.moe(mc, SH, tp, torch.from_numpy(x), use_lut=True)
    _close(jo, to, **LUT)


def test_moe_sort_matches_einsum_dispatch():
    """The port's twin of tests/test_train_loop.py's check: the sort
    dispatch equals the GShard einsum dispatch at a capacity that drops
    nothing, and both equal the JAX package's."""
    jmc, mc, jp, tp = _moe_pair(8.0)
    x = _x(8, (2, 8, 16))
    o1, _ = L.moe(mc, SH, tp, torch.from_numpy(x), dispatch="sort")
    o2, _ = L.moe(mc, SH, tp, torch.from_numpy(x), dispatch="einsum")
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-4, atol=1e-4)
    jo, _ = JL.moe(jmc, JSH, jp, jnp.asarray(x), dispatch="sort")
    _close(jo, o1, **EXACT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_is_a_sequential_scatter_add(dtype):
    """``_combine`` gives the bits of a scatter-add that adds the sorted
    assignments one at a time, in the activations' dtype, from zero."""
    g = torch.Generator().manual_seed(0)
    T, K, E, D = 9, 3, 5, 6
    idx = torch.stack([torch.randperm(E, generator=g)[:K] for _ in range(T)])
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    tok_of = order // K
    contrib = torch.randn(T * K, D, generator=g).to(dtype)
    want = torch.zeros(T, D, dtype=dtype)
    for j in range(T * K):
        want[tok_of[j]] = want[tok_of[j]] + contrib[j]
    assert torch.equal(L._combine(contrib, idx, order, tok_of), want)


# ---------------------------------------------------------------------------
# Mamba.
# ---------------------------------------------------------------------------
def _mamba_pair():
    jmc = JMB.MambaCfg(d=16, d_inner=32)
    mc = MB.MambaCfg(d=16, d_inner=32)
    jp, tp = _params(JMB.mamba_defs(jmc, JSH), 2)
    return jmc, mc, jp, tp


@pytest.mark.parametrize("S", [16, 300])
def test_mamba_prefill_matches_jax(S):
    """S = 300 is not a multiple of the 256-token chunk: it pads to two
    chunks, the state carried from the first to the second."""
    jmc, mc, jp, tp = _mamba_pair()
    x = _x(9, (2, S, 16))
    jo, _ = JMB.mamba(jmc, JSH, jp, jnp.asarray(x))
    to, _ = MB.mamba(mc, SH, tp, torch.from_numpy(x))
    _close(jo, to, **EXACT)


def test_mamba_prefill_then_decode_matches_jax():
    jmc, mc, jp, tp = _mamba_pair()
    x = _x(10, (2, 260, 16))
    jc = JMB.make_mamba_cache(jmc, 2, jnp.float32)
    tc = MB.make_mamba_cache(mc, 2, torch.float32, device="cpu")
    for s0, s1 in ((0, 257), (257, 258), (258, 259), (259, 260)):
        jo, jc = JMB.mamba(jmc, JSH, jp, jnp.asarray(x[:, s0:s1]), jc)
        to, tc = MB.mamba(mc, SH, tp, torch.from_numpy(x[:, s0:s1]), tc)
        _close(jo, to, **EXACT)
        for key in ("h", "conv"):
            _close(jc[key], tc[key], **EXACT)


def test_doubling_scan_equals_the_sequential_recurrence():
    g = torch.Generator().manual_seed(1)
    a = torch.rand(2, 13, 3, generator=g, dtype=torch.float64)
    b = torch.randn(2, 13, 3, generator=g, dtype=torch.float64)
    a_cum, h = MB._doubling_scan(a, b)
    ra, rh = a[:, 0], b[:, 0]
    for t in range(13):
        if t:
            ra, rh = ra * a[:, t], rh * a[:, t] + b[:, t]
        torch.testing.assert_close(a_cum[:, t], ra, rtol=1e-12, atol=0)
        torch.testing.assert_close(h[:, t], rh, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# xLSTM.
# ---------------------------------------------------------------------------
def _xlstm_pair(kind):
    jxc = JX.XlstmCfg(d=32, heads=2, kind=kind)
    xc = X.XlstmCfg(d=32, heads=2, kind=kind)
    jp, tp = _params(JX.xlstm_defs(jxc, JSH), 5)
    return jxc, xc, jp, tp


def _xlstm_fn(kind):
    return (JX.mlstm, X.mlstm) if kind == "mlstm" else (JX.slstm, X.slstm)


@pytest.mark.parametrize("kind,S", [("mlstm", 40), ("mlstm", 256),
                                    ("slstm", 37)])
def test_xlstm_prefill_matches_jax(kind, S):
    """mLSTM at one chunk of 40 and at two chunks of 128 (the matrix memory
    carried across); sLSTM over 37 tokens."""
    jxc, xc, jp, tp = _xlstm_pair(kind)
    jf, tf = _xlstm_fn(kind)
    x = _x(11, (2, S, 32))
    jo, _ = jf(jxc, JSH, jp, jnp.asarray(x))
    to, _ = tf(xc, SH, tp, torch.from_numpy(x))
    _close(jo, to, **EXACT)


def test_mlstm_rejects_a_partial_chunk():
    """Past one chunk the length must be a multiple of CHUNK (the JAX
    package asserts the same)."""
    _, xc, _, tp = _xlstm_pair("mlstm")
    with pytest.raises(ValueError, match="chunk"):
        X.mlstm(xc, SH, tp, torch.zeros(1, X.CHUNK + 2, 32))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_prefill_then_decode_matches_jax(kind):
    jxc, xc, jp, tp = _xlstm_pair(kind)
    jf, tf = _xlstm_fn(kind)
    x = _x(12, (2, 19, 32))
    jc = JX.make_xlstm_cache(jxc, 2)
    tc = X.make_xlstm_cache(xc, 2, device="cpu")
    for s0, s1 in ((0, 16), (16, 17), (17, 18), (18, 19)):
        jo, jc = jf(jxc, JSH, jp, jnp.asarray(x[:, s0:s1]), jc)
        to, tc = tf(xc, SH, tp, torch.from_numpy(x[:, s0:s1]), tc)
        _close(jo, to, **EXACT)
        assert sorted(jc) == sorted(tc)
        for key in jc:
            _close(jc[key], tc[key], **EXACT)
