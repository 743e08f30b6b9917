"""The stacked-layer parameter layout (``scan_layers``) of repro_torch
against the JAX package's, and against the port's own per-layer layout.

* ``scan_split`` of every config, full and smoke.
* ``specs``, ``shapes``, ``cache_specs`` and the meta ``make_caches`` with
  ``scan_layers=True`` tree for tree at production ``ShardCfg``s.
* The JAX package's stacked ``init`` crossed by ``params_from_numpy(...,
  scan_layers=True)``: forward logits (LUT off and on), the loss, and a
  cached prefill plus greedy decode steps against the JAX package's
  stacked caches, on the gpt2, whisper (``enc_blocks``, a seeded
  ``enc_input``), xlstm and jamba smoke configs (the gemma3 variant below
  in tests/test_torch_scan_train.py, for time).  Tolerances are
  tests/test_torch_models.py's; greedy tokens are equal.
* The port's stacked tree and its per-layer tree of the same weights
  (``model.unstack``, views) give bit-equal logits, loss, decode logits and
  caches.

Training, the dry run and the gemma3 variant against the JAX package:
tests/test_torch_scan_train.py.

No smoke config has a tail (layers past period x reps): the gemma3 variant
takes the smoke config's widths with 14 layers of the full config's
5-local-1-global pattern, 6 x 2 + a tail of 2, its windows cut to 4 so
that a 16-token forward takes the banded form and the local layers'
decode caches are rings that wrap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import model as JM
from repro_torch._tree import leaves, tree_map
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import model as M
from test_torch_dryrun import _jtree, _shard_variants, _ttree
from test_torch_models import B, EXACT, LUT, _close, _tokens

RUNS = ["gpt2_small", "whisper_small", "xlstm_350m", "jamba_v0_1_52b"]
GEMMA3_TAIL_LAYERS = 14
# a cached prefill's tokens: 3 for the gemma3 variant, whose rings hold 4
# (3 + 3 decode steps wrap them)
PREFILL = {"gemma3_tail": 3}


def _gemma3_tail(cfg, full):
    layers = tuple(dataclasses.replace(s, window=4) if s.window else s
                   for s in full.layers[:GEMMA3_TAIL_LAYERS])
    return dataclasses.replace(cfg, n_layers=len(layers), layers=layers)


def _cfgs(arch):
    """(JAX cfg, port cfg) at float32."""
    if arch == "gemma3_tail":
        jcfg = _gemma3_tail(jget_arch("gemma3_1b").smoke,
                            jget_arch("gemma3_1b").cfg)
        cfg = _gemma3_tail(get_arch("gemma3_1b").smoke,
                           get_arch("gemma3_1b").cfg)
    else:
        jcfg, cfg = jget_arch(arch).smoke, get_arch(arch).smoke
    return (dataclasses.replace(jcfg, dtype=jnp.float32),
            dataclasses.replace(cfg, dtype=torch.float32))


def _stacked_pair(arch):
    """The JAX package's stacked parameters (embedding x 50, as
    tests/test_torch_models.py's ``_pair``) and the port's from them."""
    jcfg, cfg = _cfgs(arch)
    jsh = jcfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    jp = dict(JM.init(jcfg, jsh, jax.random.PRNGKey(0), scan_layers=True))
    jp["embed"] = jp["embed"] * 50.0
    tp = M.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu", scan_layers=True)
    return jcfg, cfg, jp, tp, jsh, sh


def _enc(cfg, seed=3):
    if cfg.encoder is None:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder.frames, cfg.d)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_split_matches_reference(arch):
    for kind in ("cfg", "smoke"):
        jcfg = getattr(jget_arch(arch), kind)
        cfg = getattr(get_arch(arch), kind)
        assert M.scan_split(cfg) == JM.scan_split(jcfg), (arch, kind)
    want = {"gemma3_1b": (6, 4), "jamba_v0_1_52b": (8, 4),
            "xlstm_350m": (4, 6)}
    full = get_arch(arch).cfg
    assert M.scan_split(full) == want.get(arch, (1, full.n_layers))


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_trees_match_reference(arch):
    jcfg, cfg = jget_arch(arch).cfg, get_arch(arch).cfg
    for jsh, sh in zip(_shard_variants(jcfg), _shard_variants(cfg)):
        assert _ttree(M.specs(cfg, sh, scan_layers=True)) == _jtree(
            JM.specs(jcfg, jsh, scan_layers=True))
        assert _ttree(M.shapes(cfg, sh, scan_layers=True)) == _jtree(
            JM.shapes(jcfg, jsh, scan_layers=True))
        assert _ttree(M.cache_specs(cfg, sh, scan_layers=True)) == _jtree(
            JM.cache_specs(jcfg, jsh, scan_layers=True))
        caches = _ttree(M.make_caches(cfg, sh, 4, 1024, device="meta",
                                      scan_layers=True))
        # a KV cache's len: one host int per position (the JAX package
        # keeps an int32 per layer, stacked to (reps,))
        _, k = M.scan_split(cfg)
        for c in caches["blocks"].values():
            if "len" in c:
                assert c["len"] == 0
                c["len"] = ((k,), torch.int32)
        for c in caches["tail"]:
            if "len" in c:
                assert c["len"] == 0
                c["len"] = ((), torch.int32)
        assert caches == _jtree(jax.eval_shape(
            lambda: JM.make_caches(jcfg, jsh, 4, 1024, scan_layers=True)))


def _greedy(jcfg, cfg, jp, tp, jsh, sh, toks, enc, steps):
    """A cached prefill of ``toks`` and ``steps`` greedy decode steps, both
    packages on stacked caches; each step's logits within EXACT, the
    tokens equal.  Returns the port's tokens."""
    je = None if enc is None else jnp.asarray(enc)
    te = None if enc is None else torch.from_numpy(enc)
    n = toks.shape[1]
    jc = JM.make_caches(jcfg, jsh, B, n + steps, scan_layers=True)
    tc = M.make_caches(cfg, sh, B, n + steps, device="cpu", scan_layers=True)
    jl, jc, _ = JM.forward(jcfg, jsh, jp, jnp.asarray(toks), caches=jc,
                           enc_input=je)
    tl, tc, _ = M.forward(cfg, sh, tp, torch.as_tensor(toks), caches=tc,
                          enc_input=te)
    _close(jl, tl, **EXACT)
    jtok = jnp.argmax(jl[:, -1, :jcfg.vocab], axis=-1)[:, None]
    ttok = torch.argmax(tl[:, -1, :cfg.vocab], dim=-1)[:, None]
    out = [ttok]
    for i in range(steps):
        assert np.array_equal(np.asarray(jtok), ttok.numpy()), i
        jl, jc = JM.decode_step(jcfg, jsh, jp, jtok,
                                jnp.full(B, n + i, jnp.int32), jc,
                                enc_input=je)
        tl, tc = M.decode_step(cfg, sh, tp, ttok,
                               torch.full((B,), n + i, dtype=torch.int64), tc,
                               enc_input=te)
        _close(jl, tl, **EXACT)
        jtok = jnp.argmax(jl[:, :jcfg.vocab], axis=-1)[:, None]
        ttok = torch.argmax(tl[:, :cfg.vocab], dim=-1)[:, None]
        out.append(ttok)
    assert np.array_equal(np.asarray(jtok), ttok.numpy())
    for pos, jblk in jc["blocks"].items():
        tblk = tc["blocks"][pos]
        for key in jblk:
            if key == "len":
                assert tblk[key] == n + steps
                assert np.all(np.asarray(jblk[key]) == n + steps)
            else:
                _close(jblk[key], tblk[key], **EXACT)
    return torch.cat(out, dim=1)


def check_stacked_model(arch):
    """Forward logits (LUT off and on), aux and the loss, then a cached
    prefill and 3 greedy decode steps, against the JAX package's stacked
    tree and caches."""
    jcfg, cfg, jp, tp, jsh, sh = _stacked_pair(arch)
    assert "blocks" in tp and "layers" not in tp
    toks = _tokens(cfg)
    enc = _enc(cfg)
    je = None if enc is None else jnp.asarray(enc)
    te = None if enc is None else torch.from_numpy(enc)
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    for use_lut, tol in ((False, EXACT), (True, LUT)):
        jl, _, jaux = JM.forward(jcfg, jsh, jp, jt, use_lut=use_lut,
                                 enc_input=je)
        tl, _, taux = M.forward(cfg, sh, tp, tt, use_lut=use_lut,
                                enc_input=te)
        _close(jl, tl, **tol)
        if not use_lut:
            scale = float(np.abs(np.asarray(jl)).max())
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5, abs=1e-6)
    jloss = JM.loss_fn(jcfg, jsh, jp, jt, jt, enc_input=je, remat=False)
    tloss = M.loss_fn(cfg, sh, tp, tt, tt, enc_input=te)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5,
                                         abs=1e-6 * scale)
    n = PREFILL.get(arch, 8)
    _greedy(jcfg, cfg, jp, tp, jsh, sh, toks[:, :n], enc, 3)


@pytest.mark.parametrize("arch", RUNS)
def test_stacked_model_matches_reference(arch):
    check_stacked_model(arch)


def _unstack_caches(cfg, caches):
    """A stacked cache tree as the per-layer list (views)."""
    p, k = M.scan_split(cfg)
    out = [{key: v if key == "len" else v[r]
            for key, v in caches["blocks"][f"pos{j}"].items()}
           for r in range(k) for j in range(p)]
    return out + caches["tail"]


@pytest.mark.parametrize("arch", RUNS + ["gemma3_tail"])
def test_stacked_equals_per_layer(arch):
    """The port's two layouts on the same weights, bit for bit: forward
    logits and aux, the loss with remat and its gradients, and a cached
    prefill with greedy decode steps to 14 tokens (logits, tokens and every
    cache tensor, LUT ops on)."""
    _, cfg = _cfgs(arch)
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    st = M.init(cfg, sh, torch.Generator().manual_seed(0), device="cpu",
                scan_layers=True)
    st["embed"] = st["embed"] * 50.0
    pl = M.unstack(cfg, st)
    p, k = M.scan_split(cfg)
    assert len(pl["layers"]) == cfg.n_layers
    # views, no copies: layer r p + j is blocks/pos{j} at r
    assert pl["layers"][(k - 1) * p]["n1"]["g"].data_ptr() == \
        st["blocks"]["pos0"]["n1"]["g"][k - 1].data_ptr()
    toks = torch.as_tensor(_tokens(cfg, seed=7))
    enc = _enc(cfg)
    te = None if enc is None else torch.from_numpy(enc)
    a = M.forward(cfg, sh, st, toks, enc_input=te)
    b = M.forward(cfg, sh, pl, toks, enc_input=te)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    grads = []
    for tree in (st, pl):
        live = tree_map(lambda x: x.detach().requires_grad_(True), tree)
        loss = M.loss_fn(cfg, sh, live, toks, toks, enc_input=te, remat=True)
        loss.backward()
        grads.append((loss, tree_map(lambda x: x.grad, live)))
    assert torch.equal(grads[0][0], grads[1][0])
    g_st, g_pl = leaves(M.unstack(cfg, grads[0][1])), leaves(grads[1][1])
    assert len(g_st) == len(g_pl)
    assert all(torch.equal(x, y) for x, y in zip(g_st, g_pl))
    runs = []
    n = PREFILL.get(arch, 8)
    for tree, scan in ((st, True), (pl, False)):
        caches = M.make_caches(cfg, sh, B, 14, device="cpu", scan_layers=scan)
        stacked = [t for t in leaves(caches) if isinstance(t, torch.Tensor)]
        with torch.no_grad():
            lg, caches, _ = M.forward(cfg, sh, tree, toks[:, :n],
                                      caches=caches, use_lut=True,
                                      enc_input=te)
            out, tok = [lg], lg[:, -1].argmax(-1)[:, None]
            for i in range(14 - n):
                lg, caches = M.decode_step(cfg, sh, tree, tok,
                                           torch.full((B,), n + i), caches,
                                           enc_input=te, use_lut=True)
                tok = lg.argmax(-1)[:, None]
                out += [lg, tok]
        if scan:
            # every step wrote into the tensors make_caches allocated
            after = [t for t in leaves(caches) if isinstance(t, torch.Tensor)]
            assert len(after) == len(stacked)
            assert all(x is y for x, y in zip(stacked, after))
            caches = _unstack_caches(cfg, caches)
        runs.append((out, caches))
    (o1, c1), (o2, c2) = runs
    assert all(torch.equal(x, y) for x, y in zip(o1, o2))
    for x, y in zip(c1, c2):
        assert sorted(x) == sorted(y)
        for key in x:
            if key == "len":
                assert x[key] == y[key] == 14
            else:
                assert torch.equal(x[key], y[key])
