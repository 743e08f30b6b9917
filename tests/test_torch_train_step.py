"""``launch.train.make_train_step`` of repro_torch against the JAX
package's: 3 steps on the gpt2, tinyllama and gemma3 smoke configs at
float32 compute (GELU and learned positions; RMSNorm, RoPE, GQA and the
SiLU gate; sliding windows and the logit softcap), 2 microbatches,
int8 compression on and off, and 1 step without compression on the
moonshot and jamba smoke configs (the MoE's two dispatches, Mamba), the JAX weights crossed by
``params_from_numpy``, the same batches from the data pipeline.

The optimizer runs at lr 1e-3 from its first step (warmup 1), so that the
bf16 weights move: at the default warmup's 3e-6 only the zero-initialised
norms and biases would.

The JAX step runs op by op (``jax.disable_jit()``; its scan becomes a
Python loop).  Compiled, XLA keeps a fusion's bfloat16 intermediates in
float32 (excess precision): ``1 + g`` of a norm's bf16 gain stays
1.001 where JAX op by op, and PyTorch, round it to bf16 1.0.  After one
update the compiled JAX step's loss then differs from its own op-by-op
run by up to ~2e-4; the port follows the op-by-op semantics.

Tolerances:
  * loss and grad norm: rtol 1e-4 (the packages sum float32 in different
    orders; measured: <= 2e-7 and <= 1.1e-5);
  * params (bf16): every element within 2 lr k + 2^-7 |p| after k steps,
    and at most 0.5% of the elements differ at all (measured: <= 0.13%).
    Adam's first steps are close to lr sign(g), so a near-zero gradient
    that differs in its last bits can move a weight by up to 2 lr a step,
    and so can an int8 code that rounds the other way; where the float32
    update differs in its last bits, the bf16 result can round to the
    neighbouring value (one ulp, <= 2^-7 |p|).
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
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
from repro_torch.launch import train as T
from repro_torch.models import model as M
from repro_torch.optim import adamw, compression

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)
STEPS, BATCH, SEQ = 3, 4, 16
CHANGED_SHARE = 0.005


def _leaves_f32(tree):
    if isinstance(tree, torch.Tensor):
        return [tree.float().numpy()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_f32(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_f32(v)]
    return [np.asarray(tree, np.float32)]


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ["gpt2_small", "tinyllama_1_1b", "gemma3_1b"])
def test_train_step_matches_jax(arch, compress):
    _steps_match_jax(arch, compress, STEPS)


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "jamba_v0_1_52b"])
def test_moe_train_step_matches_jax(arch):
    """One step of the MoE configs (moonshot's sort dispatch; jamba's
    einsum dispatch beside Mamba layers), compression off: the loss
    carries 0.01 x the aux loss, and its gradient reaches the router."""
    _steps_match_jax(arch, False, 1)


def _steps_match_jax(arch, compress, steps):
    jcfg = dataclasses.replace(jget_arch(arch).smoke, dtype=jnp.float32)
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
    jsh = jcfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    jp = JM.init(jcfg, jsh, jax.random.PRNGKey(0))
    tp = M.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp), sh,
                             device="cpu")
    kw = dict(microbatches=2, compress_grads=compress, remat=True)
    jstep = JT.make_train_step(jcfg, jsh, jadamw.AdamWCfg(**OPT),
                               JT.TrainCfg(**kw))
    tstep = T.make_train_step(cfg, sh, adamw.AdamWCfg(**OPT), T.TrainCfg(**kw))
    js, ts = jadamw.init(jp), adamw.init(tp)
    je = jcomp.init_ef(jp) if compress else jcomp.EFState(residual=0)
    te = compression.init_ef(tp) if compress else compression.EFState(residual=0)
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab, 0), BATCH, SEQ)
    for k in range(1, steps + 1):
        toks, labels = pipe.next_batch()
        with jax.disable_jit():
            jp, js, je, jm = jstep(jp, js, je, jnp.asarray(toks),
                                   jnp.asarray(labels))
        tp, ts, te, tm = tstep(tp, ts, te, torch.from_numpy(toks).long(),
                               torch.from_numpy(labels).long())
        assert int(ts.step) == k
        for key in ("loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-4), \
                (k, key)
        changed = total = 0
        for a, b in zip(_leaves_f32(jp), _leaves_f32(tp)):
            assert a.shape == b.shape
            d = np.abs(a - b)
            assert np.all(d <= 2 * OPT["lr"] * k + 2.0 ** -7 * np.abs(a)), k
            changed += int(np.count_nonzero(d))
            total += a.size
        assert changed <= CHANGED_SHARE * total, (k, changed, total)
        assert all(t.dtype == torch.bfloat16 for t in
                   jax.tree_util.tree_leaves(tp, is_leaf=torch.is_tensor))
