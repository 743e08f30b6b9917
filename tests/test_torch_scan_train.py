"""Training and the dry run on the stacked-layer parameter layout
(``scan_layers``) of repro_torch, and the gemma3 variant with a tail (the
rest of the model: tests/test_torch_scan.py).

* The gemma3 variant of tests/test_torch_scan.py (14 layers of the full
  config's pattern: 6 x 2 stacked and a tail of 2, windows 4) against the
  JAX package's stacked tree: ``check_stacked_model`` there.
* One ``make_train_step`` step on stacked parameters, int8 compression on,
  against the JAX package's step under ``jax.disable_jit()`` within
  tests/test_torch_train_step.py's tolerances, on a 5-layer gemma3 smoke
  variant (local, global, local, global, local: 2 x 2 stacked and a tail
  of 1; the 14-layer one costs the op-by-op JAX step ~20 s more).  The
  compression scale is one per stacked leaf, spanning its reps, in both
  packages, so stacked training is held against the reference's stacked
  training, not against per-layer training.
* ``train(..., TrainCfg(scan_layers=True))`` trains, checkpoints (the
  stacked leaves and the empty tail) and resumes on the CPU.
* The dry run's step traces the same FLOPs and argument bytes on both
  layouts; ``build_cell`` makes the stacked tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import train as JT
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
from repro_torch.launch import dryrun as D
from repro_torch.launch import serve as S
from repro_torch.launch import train as T
from repro_torch.models import model as M
from repro_torch.optim import adamw, compression
from test_torch_dryrun import _smoke_cell
from test_torch_scan import check_stacked_model
from test_torch_train_step import CHANGED_SHARE, OPT, _leaves_f32


@pytest.mark.parametrize("arch", ["gpt2_small", "jamba_v0_1_52b",
                                  "xlstm_350m", "whisper_small", "gemma3_1b"])
def test_dryrun_stacked_trace_equals_per_layer(arch):
    """The dry run's step on the stacked tree and on the per-layer tree of
    a smoke cell: the same FLOPs (the stacked leaves are only indexed) and
    the same argument bytes; ``build_cell`` makes the stacked tree."""
    for mode, seq in (("train", 16), ("prefill", 16), ("decode", 32)):
        per_layer = _smoke_cell(arch, mode, 2, seq)
        params = M.shapes(per_layer.cfg, per_layer.sh, scan_layers=True)
        stacked = dataclasses.replace(
            per_layer, params=params,
            opt_state=adamw.init(params) if mode == "train" else None)
        assert stacked.scan_layers and not per_layer.scan_layers
        a = D.trace(per_layer.step, per_layer.arguments("meta")[0])
        b = D.trace(stacked.step, stacked.arguments("meta")[0])
        assert a["flops"] == b["flops"] > 0, mode
        assert D.argument_bytes(per_layer)["argument_bytes_per_dev"] == \
            D.argument_bytes(stacked)["argument_bytes_per_dev"], mode
    cell, _ = D.build_cell(arch, "train_4k")
    assert cell.scan_layers and "blocks" in cell.params


def test_stacked_gemma3_tail_matches_reference():
    check_stacked_model("gemma3_tail")


def _gemma3_alternating(bundle, dtype):
    """gemma3's smoke widths, 5 layers alternating its local (window 4)
    and global specs: scan_split (2, 2) and a tail of 1."""
    local = dataclasses.replace(bundle.cfg.layers[0], window=4)
    layers = (local, bundle.cfg.layers[5]) * 2 + (local,)
    return dataclasses.replace(bundle.smoke, n_layers=5, layers=layers,
                               dtype=dtype)


def test_stacked_train_step_matches_reference():
    """One step with a tail beside the stacked positions, int8 compression
    on, remat on (one microbatch: the JAX package's step runs op by op;
    ``train`` below accumulates two)."""
    jcfg = _gemma3_alternating(jget_arch("gemma3_1b"), jnp.float32)
    cfg = _gemma3_alternating(get_arch("gemma3_1b"), torch.float32)
    assert M.scan_split(cfg) == JM.scan_split(jcfg) == (2, 2)
    jsh = jcfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    jp = JM.init(jcfg, jsh, jax.random.PRNGKey(0), scan_layers=True)
    tp = M.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp), sh,
                             device="cpu", scan_layers=True)
    kw = dict(microbatches=1, compress_grads=True, remat=True,
              scan_layers=True)
    jstep = JT.make_train_step(jcfg, jsh, jadamw.AdamWCfg(**OPT),
                               JT.TrainCfg(**kw))
    tstep = T.make_train_step(cfg, sh, adamw.AdamWCfg(**OPT), T.TrainCfg(**kw))
    js, ts = jadamw.init(jp), adamw.init(tp)
    je, te = jcomp.init_ef(jp), compression.init_ef(tp)
    toks, labels = DataPipeline(SyntheticCorpus(cfg.vocab, 0), 4,
                                16).next_batch()
    with jax.disable_jit():
        jp, js, je, jm = jstep(jp, js, je, jnp.asarray(toks),
                               jnp.asarray(labels))
    tp, ts, te, tm = tstep(tp, ts, te, torch.from_numpy(toks).long(),
                           torch.from_numpy(labels).long())
    for key in ("loss", "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-4), key
    changed = total = 0
    for a, b in zip(_leaves_f32(jp), _leaves_f32(tp)):
        assert a.shape == b.shape
        d = np.abs(a - b)
        assert np.all(d <= 2 * OPT["lr"] + 2.0 ** -7 * np.abs(a))
        changed += int(np.count_nonzero(d))
        total += a.size
    assert changed <= CHANGED_SHARE * total, (changed, total)
    # the error-feedback residuals, one per stacked leaf
    for a, b in zip(_leaves_f32(je.residual), _leaves_f32(te.residual)):
        assert a.shape == b.shape
    assert len(tp["tail"]) == 1


def test_train_scan_layers_trains_and_resumes(tmp_path, capsys):
    tc = dict(batch=4, seq=32, microbatches=2, compress_grads=True,
              scan_layers=True, ckpt_dir=str(tmp_path / "ck"), log_every=100)
    out = T.train("gpt2_small", T.TrainCfg(steps=12, ckpt_every=8, **tc),
                  smoke=True, resume=False, device="cpu")
    assert len(out["losses"]) == 12 and np.all(np.isfinite(out["losses"]))
    assert "blocks" in out["params"] and out["params"]["tail"] == []
    assert ckpt.latest_step(tc["ckpt_dir"]) == 8
    keys = ckpt.restore((out["params"], adamw.init(out["params"])),
                        tc["ckpt_dir"], device="cpu")[1]["keys"]
    assert "[0]/['blocks']/['pos0']/['mix']/['wq']" in keys
    cfg, sh = out["cfg"], out["sh"]
    init = M.init(cfg, sh, torch.Generator().manual_seed(0), device="cpu",
                  scan_layers=True)
    held = DataPipeline(SyntheticCorpus(cfg.vocab, 99), 16, 32)
    toks, labels = (torch.from_numpy(a).long() for a in held.next_batch())
    capsys.readouterr()
    out2 = T.train("gpt2_small", T.TrainCfg(steps=14, ckpt_every=100, **tc),
                   smoke=True, resume=True, device="cpu")
    assert "[train] elastic resume from step 8" in capsys.readouterr().out
    assert len(out2["losses"]) == 6
    with torch.no_grad():
        before = float(M.loss_fn(cfg, sh, init, toks, labels))
        after = float(M.loss_fn(cfg, sh, out2["params"], toks, labels))
    assert after < before
    g = S.generate(cfg, sh, out2["params"], toks[:2, :8],
                   S.ServeCfg(max_new_tokens=3))
    assert tuple(g.shape) == (2, 3)
