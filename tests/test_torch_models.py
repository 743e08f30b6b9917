"""The float model zoo of repro_torch against the JAX package: the configs
field for field, and the dense attention decoders (gpt2, tinyllama and
gemma3 smoke configs at float32) on the same parameters.

The JAX parameters cross over by ``params_from_numpy``.  As in
tests/test_models_smoke.py, the embedding is scaled by 50: random 0.02-σ
weights leave the rsqrt LUT's [0.01, 10] domain otherwise.

Tolerances (logits; ``scale`` is the largest |logit| of the JAX side):
  * exact path (use_lut off): rtol 1e-4, atol 1e-4 x scale.  The two
    packages sum their float32 matmuls in different orders, nothing more.
  * loss: rtol 1e-5, atol 1e-6 x scale (a difference of two ~scale terms).
  * LUT path: rtol 1e-3, atol 1e-3 x scale.  A table index is
    round((x - lo) 2^f_in) of a float32 x; where x itself differs in its
    last bits between the packages, an index can flip to its neighbour
    entry (one grid step of the table's output).
Greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_arch as jget_arch
from repro.launch import serve as JS
from repro.models import model as JM
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import serve as S
from repro_torch.models import model as M

EXACT = dict(rtol=1e-4, scale_atol=1e-4)
LUT = dict(rtol=1e-3, scale_atol=1e-3)
B, SEQ = 2, 16
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
RUNS = ["gpt2_small", "tinyllama_1_1b", "gemma3_1b"]


def _close(jx, tx, rtol, scale_atol):
    jx = np.asarray(jx, np.float32)
    tx = tx.float().numpy()
    assert jx.shape == tx.shape
    scale = float(np.abs(jx).max())
    np.testing.assert_allclose(tx, jx, rtol=rtol, atol=scale_atol * scale)


def _pair(arch, **replace):
    """(JAX cfg, port cfg, JAX params, port params, shard cfgs) at float32."""
    jcfg = dataclasses.replace(jget_arch(arch).smoke, dtype=jnp.float32,
                               **replace)
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32,
                              **replace)
    jsh = jcfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    jp = dict(JM.init(jcfg, jsh, jax.random.PRNGKey(0)))
    jp["embed"] = jp["embed"] * 50.0
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = M.params_from_numpy(cfg, tree, device="cpu")
    return jcfg, cfg, jp, tp, jsh, sh


def _tokens(cfg, seed=0, n=SEQ):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n))


def _field_tuple(cfg):
    out = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = DTYPES.get(v, v)
        elif f.name == "layers":
            v = tuple(dataclasses.astuple(s) for s in v)
        elif dataclasses.is_dataclass(v):
            v = dataclasses.astuple(v)
        out.append((f.name, v))
    return out


def test_configs_match_jax_field_for_field():
    assert ARCHS == JARCHS
    for arch in ARCHS:
        jb, tb = jget_arch(arch), get_arch(arch)
        assert _field_tuple(tb.cfg) == _field_tuple(jb.cfg), arch
        assert _field_tuple(tb.smoke) == _field_tuple(jb.smoke), arch
        assert tb.skip == jb.skip and tb.overrides == jb.overrides, arch
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            assert tb.shape_params(shape) == jb.shape_params(shape)
        assert tb.cfg.dtype == torch.bfloat16


def test_sequence_sharded_cache_equals_unsharded():
    """``ShardCfg.cache_seq`` changes only which op writes a decode step's
    key and value: a cached prefill and 4 greedy decode steps give the
    same logits and tokens, bit for bit, with and without it (its one
    difference, a full cache, is pinned against JAX in
    tests/test_torch_dryrun.py)."""
    cfg = get_arch("tinyllama_1_1b").smoke
    params = M.init(cfg, cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1),
                    torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.as_tensor(_tokens(cfg, n=8))
    runs = []
    for cache_seq in ((), ("model",)):
        sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1,
                           cache_seq=cache_seq, cache_seq_size=1)
        caches = M.make_caches(cfg, sh, B, 16, device="cpu")
        logits, caches, _ = M.forward(cfg, sh, params, prompt, caches=caches)
        out, tok = [logits], logits[:, -1].argmax(-1)
        for i in range(8, 12):
            lg, caches = M.decode_step(cfg, sh, params, tok[:, None],
                                       torch.full((B,), i), caches)
            tok = lg.argmax(-1)
            out += [lg, tok]
        runs.append(out)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_init_params_shapes_and_generator():
    cfg = get_arch("tinyllama_1_1b").smoke
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    jsh = jget_arch("tinyllama_1_1b").smoke.shard_cfg(
        dp=("data",), tp_size=1, dp_size=1)
    p1 = M.init(cfg, sh, torch.Generator().manual_seed(3), device="cpu")
    p2 = M.init(cfg, sh, torch.Generator().manual_seed(3), device="cpu")
    shapes = JM.shapes(jget_arch("tinyllama_1_1b").smoke, jsh)
    flat1, _ = jax.tree_util.tree_flatten(p1, is_leaf=torch.is_tensor)
    flat2, _ = jax.tree_util.tree_flatten(p2, is_leaf=torch.is_tensor)
    jflat, _ = jax.tree_util.tree_flatten(shapes)
    assert [tuple(t.shape) for t in flat1] == [tuple(s.shape) for s in jflat]
    assert all(t.dtype == torch.bfloat16 for t in flat1)
    assert all(torch.equal(a, b) for a, b in zip(flat1, flat2))
    assert float(p1["embed"].float().std()) == pytest.approx(0.02, rel=0.1)
    assert not p1["final_norm"]["g"].any()


def _check_model(jcfg, cfg, jp, tp, jsh, sh, generate=True):
    toks = _tokens(cfg)
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    for use_lut, tol in ((False, EXACT), (True, LUT)):
        jl, _, _ = JM.forward(jcfg, jsh, jp, jt, use_lut=use_lut)
        tl, _, _ = M.forward(cfg, sh, tp, tt, use_lut=use_lut)
        _close(jl, tl, **tol)
        if not use_lut:
            scale = float(np.abs(np.asarray(jl)).max())
    # the NLL is logsumexp minus a logit, each of size ~scale: its error is
    # float32 rounding of those, so atol 1e-6 x scale besides rtol 1e-5
    jloss = JM.loss_fn(jcfg, jsh, jp, jt, jt, remat=False)
    tloss = M.loss_fn(cfg, sh, tp, tt, tt)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5,
                                         abs=1e-6 * scale)
    # one decode step against a fresh cache, both paths
    for use_lut, tol in ((False, EXACT), (True, LUT)):
        jc = JM.make_caches(jcfg, jsh, B, 32)
        tc = M.make_caches(cfg, sh, B, 32, device="cpu")
        jlg, _ = JM.decode_step(jcfg, jsh, jp, jt[:, :1],
                                jnp.zeros(B, jnp.int32), jc, use_lut=use_lut)
        tlg, _ = M.decode_step(cfg, sh, tp, tt[:, :1],
                               torch.zeros(B, dtype=torch.int64), tc,
                               use_lut=use_lut)
        _close(jlg, tlg, **tol)
    if generate:
        sc = dict(max_new_tokens=6)
        jg = np.asarray(JS.generate(jcfg, jsh, jp, jt, JS.ServeCfg(**sc)))
        tg = S.generate(cfg, sh, tp, tt, S.ServeCfg(**sc))
        assert np.array_equal(jg, tg.numpy())


@pytest.mark.parametrize("arch", RUNS)
def test_model_matches_jax(arch):
    _check_model(*_pair(arch))


def test_softcap_matches_jax():
    """gpt2 with an attention logit softcap of 30 (of the configs only
    grok-1 sets one: tests/test_torch_zoo_models.py)."""
    _check_model(*_pair("gpt2_small", softcap=30.0), generate=False)


def test_gemma3_banded_window_and_ring_cache():
    """gemma3 with window 4 on both sides: a 16-token forward takes the
    banded form (S > 2W), and 32-slot decode caches of the windowed layers
    are rings of 4 slots that wrap three times over 12 steps."""
    layers = tuple(dataclasses.replace(s, window=4) if s.window else s
                   for s in get_arch("gemma3_1b").smoke.layers)
    jlayers = tuple(dataclasses.replace(s, window=4) if s.window else s
                    for s in jget_arch("gemma3_1b").smoke.layers)
    jcfg, cfg, jp, tp, jsh, sh = _pair("gemma3_1b")
    jcfg = dataclasses.replace(jcfg, layers=jlayers)
    cfg = dataclasses.replace(cfg, layers=layers)
    _check_model(jcfg, cfg, jp, tp, jsh, sh, generate=False)
    toks = _tokens(cfg, seed=1)
    jc = JM.make_caches(jcfg, jsh, B, 32)
    tc = M.make_caches(cfg, sh, B, 32, device="cpu")
    assert [c["k"].shape[1] for c in tc] == [4, 4, 4]
    for i in range(12):
        jlg, jc = JM.decode_step(jcfg, jsh, jp,
                                 jnp.asarray(toks[:, i:i + 1], jnp.int32),
                                 jnp.full(B, i, jnp.int32), jc, use_lut=True)
        tlg, tc = M.decode_step(cfg, sh, tp, torch.as_tensor(toks[:, i:i + 1]),
                                torch.full((B,), i, dtype=torch.int64), tc,
                                use_lut=True)
        _close(jlg, tlg, **LUT)
    assert [c["len"] for c in tc] == [12, 12, 12]


def test_cached_decode_matches_uncached_forward():
    """The port's own consistency check, as the card's model phase runs it:
    the greedy tokens' last-step argmax equals a no-cache forward's."""
    jcfg, cfg, jp, tp, jsh, sh = _pair("tinyllama_1_1b")
    prompt = torch.as_tensor(_tokens(cfg))
    out = S.generate(cfg, sh, tp, prompt, S.ServeCfg(max_new_tokens=5))
    full = torch.cat([prompt, out[:, :-1]], dim=1)
    logits, _, _ = M.forward(cfg, sh, tp, full, use_lut=True)
    assert torch.equal(torch.argmax(logits[:, -1, :cfg.vocab], dim=-1),
                       out[:, -1])
