"""The rest of the float model zoo of repro_torch against the JAX package:
the smoke configs of grok-1 and moonshot (MoE, sort dispatch), jamba
(Mamba, attention, MoE with the einsum dispatch), qwen2-vl (M-RoPE, qkv
bias), whisper (encoder and cross-attention) and xlstm (mLSTM, sLSTM) at
float32, on the JAX parameters crossed by ``params_from_numpy`` with the
embedding scaled by 50 (tests/test_torch_models.py's ``_pair``).

Tolerances are tests/test_torch_models.py's (``scale`` the largest
|logit| of the JAX side): rtol 1e-4 and atol 1e-4 x scale on the exact
path, rtol 1e-3 and atol 1e-3 x scale on the LUT path, the loss (MoE aux
included) within rtol 1e-5 and atol 1e-6 x scale; greedy tokens equal.

Two behaviours of the reference make a cached decode differ from a full
forward over the same tokens: the MoE's capacity grows with the token
count, and the mLSTM decode step floors its normaliser at 1.0 where the
chunked path floors it at exp(-m).  The port keeps both; the last tests
pin them as equalities with the JAX package.
"""
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import serve as S
from repro_torch.models import model as M
from test_torch_models import B, EXACT, LUT, _check_model, _close, _pair, \
    _tokens

ZOO = ["grok_1_314b", "moonshot_v1_16b_a3b", "jamba_v0_1_52b",
       "qwen2_vl_72b", "whisper_small", "xlstm_350m"]


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_model_matches_jax(arch):
    """forward (LUT off and on), the loss with the MoE aux, one decode step
    from an empty cache, and 6 greedy tokens of ``generate``."""
    _check_model(*_pair(arch))


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_cached_prefill_and_decode(arch):
    """A 16-token prefill through the caches, then 3 decode steps, LUT on
    (the serving path): each step's logits, and the recurrent caches,
    against the JAX package's."""
    jcfg, cfg, jp, tp, jsh, sh = _pair(arch)
    toks = _tokens(cfg, seed=2, n=19)
    jc = JM.make_caches(jcfg, jsh, B, 24)
    tc = M.make_caches(cfg, sh, B, 24, device="cpu")
    jl, jc, _ = JM.forward(jcfg, jsh, jp, jnp.asarray(toks[:, :16]),
                           caches=jc, use_lut=True)
    tl, tc, _ = M.forward(cfg, sh, tp, torch.as_tensor(toks[:, :16]),
                          caches=tc, use_lut=True)
    _close(jl, tl, **LUT)
    for i in range(16, 19):
        jl, jc = JM.decode_step(jcfg, jsh, jp, jnp.asarray(toks[:, i:i + 1]),
                                jnp.full(B, i, jnp.int32), jc, use_lut=True)
        tl, tc = M.decode_step(cfg, sh, tp, torch.as_tensor(toks[:, i:i + 1]),
                               torch.full((B,), i, dtype=torch.int64), tc,
                               use_lut=True)
        _close(jl, tl, **LUT)
    for jcache, tcache, spec in zip(jc, tc, cfg.layers):
        if spec.kind == "attn":
            assert tcache["len"] == int(jcache["len"]) == 19
            continue
        for key in jcache:
            _close(jcache[key], tcache[key], **LUT)


def _enc_input(cfg, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder.frames, cfg.d)).astype(np.float32)


def test_whisper_encoder_path_matches_jax():
    """whisper with a seeded enc_input: the encoder over its frames and the
    decoder's cross-attention, in forward (LUT off and on), the loss, and
    cached decode steps that rerun the encoder, as the JAX package's do."""
    jcfg, cfg, jp, tp, jsh, sh = _pair("whisper_small")
    toks = _tokens(cfg, seed=4)
    enc = _enc_input(cfg)
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks)
    je, te = jnp.asarray(enc), torch.from_numpy(enc)
    for use_lut, tol in ((False, EXACT), (True, LUT)):
        jl, _, _ = JM.forward(jcfg, jsh, jp, jt, enc_input=je,
                              use_lut=use_lut)
        tl, _, _ = M.forward(cfg, sh, tp, tt, enc_input=te, use_lut=use_lut)
        _close(jl, tl, **tol)
    # the encoder moves the logits: the cross blocks ran
    bare, _, _ = M.forward(cfg, sh, tp, tt)
    assert not torch.allclose(bare, M.forward(cfg, sh, tp, tt,
                                              enc_input=te)[0])
    scale = float(np.abs(np.asarray(JM.forward(jcfg, jsh, jp, jt,
                                               enc_input=je)[0])).max())
    jloss = JM.loss_fn(jcfg, jsh, jp, jt, jt, enc_input=je, remat=False)
    tloss = M.loss_fn(cfg, sh, tp, tt, tt, enc_input=te)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5,
                                         abs=1e-6 * scale)
    jc = JM.make_caches(jcfg, jsh, B, 24)
    tc = M.make_caches(cfg, sh, B, 24, device="cpu")
    _, jc, _ = JM.forward(jcfg, jsh, jp, jt[:, :8], caches=jc, enc_input=je)
    _, tc, _ = M.forward(cfg, sh, tp, tt[:, :8], caches=tc, enc_input=te)
    for i in range(8, 10):
        jl, jc = JM.decode_step(jcfg, jsh, jp, jt[:, i:i + 1],
                                jnp.full(B, i, jnp.int32), jc, enc_input=je)
        tl, tc = M.decode_step(cfg, sh, tp, tt[:, i:i + 1],
                               torch.full((B,), i, dtype=torch.int64), tc,
                               enc_input=te)
        _close(jl, tl, **EXACT)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_runs_on_the_cpu(arch):
    """init, forward, make_caches and decode_step at each of the twelve
    smoke configs (bf16, the port's own weights): finite logits of the
    padded vocabulary's width."""
    cfg = get_arch(arch).smoke
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    gen = torch.Generator().manual_seed(0)
    params = M.init(cfg, sh, gen, device="cpu")
    toks = torch.randint(0, cfg.vocab, (B, 8), generator=gen)
    enc = None
    if cfg.encoder is not None:
        enc = torch.randn((B, cfg.encoder.frames, cfg.d), generator=gen)
    logits, _, aux = M.forward(cfg, sh, params, toks, enc_input=enc)
    assert logits.shape == (B, 8, cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    assert (float(aux) > 0) == any(s.moe for s in cfg.layers)
    caches = M.make_caches(cfg, sh, B, 12, device="cpu")
    assert len(caches) == cfg.n_layers
    _, caches, _ = M.forward(cfg, sh, params, toks, caches=caches,
                             enc_input=enc)
    lg, caches = M.decode_step(cfg, sh, params, toks[:, :1],
                               torch.full((B,), 8, dtype=torch.int64), caches,
                               enc_input=enc)
    assert lg.shape == (B, cfg.vocab_padded)
    assert bool(torch.isfinite(lg).all())


@pytest.mark.parametrize("arch", ZOO)
def test_serve_cli_runs_every_new_arch(arch):
    """``python -m repro_torch.launch.serve --arch <arch>`` in process, at
    the arch's smoke config (as the JAX CLI runs it)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        S.main(["--arch", arch, "--device", "cpu", "--max-new-tokens", "3"])
    text = out.getvalue()
    assert text.startswith("generated:"), text
    assert len(re.findall(r"\d+", text)) == B * 3, text


def _last_logits_gap(fwd, decode, make_caches, toks):
    """Relative gap between a no-cache forward's last logits over toks and
    those of a cached prefill of toks[:, :-1] followed by one decode step."""
    full = fwd(toks, None)[0][:, -1]
    caches = make_caches()
    _, caches = fwd(toks[:, :-1], caches)[:2]
    step = decode(toks[:, -1:], toks.shape[1] - 1, caches)
    full, step = np.asarray(full, np.float64), np.asarray(step, np.float64)
    return float(np.abs(step - full).max() / np.abs(full).max()), step


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "jamba_v0_1_52b",
                                  "xlstm_350m"])
def test_reference_cached_decode_gap_is_kept(arch):
    """The cached decode of the reference differs from its full forward
    (MoE capacity against T for moonshot and jamba; the mLSTM decode floor
    for xlstm).  The port's gap equals the JAX package's, and so do its
    decode logits: the port mirrors the behaviour, it does not fix it."""
    jcfg, cfg, jp, tp, jsh, sh = _pair(arch)
    toks = _tokens(cfg, seed=5)

    def jfwd(t, c):
        return JM.forward(jcfg, jsh, jp, jnp.asarray(t), caches=c)

    def tfwd(t, c):
        lg, nc, aux = M.forward(cfg, sh, tp, torch.as_tensor(t), caches=c)
        return lg.numpy(), nc, aux

    def jdec(t, i, c):
        return JM.decode_step(jcfg, jsh, jp, jnp.asarray(t),
                              jnp.full(B, i, jnp.int32), c)[0]

    def tdec(t, i, c):
        return M.decode_step(cfg, sh, tp, torch.as_tensor(t),
                             torch.full((B,), i, dtype=torch.int64),
                             c)[0].numpy()

    jgap, jstep = _last_logits_gap(jfwd, jdec,
                                   lambda: JM.make_caches(jcfg, jsh, B, 16),
                                   toks)
    tgap, tstep = _last_logits_gap(
        tfwd, tdec, lambda: M.make_caches(cfg, sh, B, 16, device="cpu"), toks)
    _close(jstep, torch.from_numpy(tstep), **EXACT)
    assert jgap > 0.05
    assert tgap == pytest.approx(jgap, rel=1e-3)

