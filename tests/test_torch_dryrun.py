"""The port's dry run (``repro_torch.launch.dryrun``) and the trees it
reads against the JAX package.

* Every cell of both production meshes: the skip list, the ``ShardCfg``
  (at the JAX package's 16e9 budget), ``_rough_params`` and the bytes of
  parameters, optimizer state, caches and inputs on one device, exactly.
  The JAX side runs ``repro.launch.dryrun.build_cell`` (without lowering)
  in a subprocess, because importing that module sets ``XLA_FLAGS`` to
  512 host devices, and takes each leaf's per-device shape from
  ``NamedSharding(mesh, spec).shard_shape`` over its own specs.  A KV
  cache's ``len`` is a device int32 there and a host int here, so its
  bytes are left out of the comparison (ROADMAP, kept differences).
* ``model.specs``/``shapes``/``cache_specs``, the meta ``make_caches`` and
  ``configs.input_specs`` tree for tree.
* The meta trace's counts against the same step on real CPU tensors, and
  the gpt2 forward's FLOPs against their closed form.
* The caching allocator's bounds on the arguments' blocks, and the note on
  a sequence-sharded KV cache that the trace reads whole.
* The sequence-sharded decode cache (``ShardCfg.cache_seq``) against the
  JAX package's decode, the full-cache case included.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jget_arch
from repro.configs import input_specs as jinput_specs
from repro.models import model as JM
from repro_torch.configs import ARCHS, SHAPES, get_arch, input_specs
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from test_torch_models import B, EXACT, _close, _pair, _tokens

ROOT = os.path.join(os.path.dirname(__file__), "..")
ONE = Mesh(("data", "model"), (1, 1))
JDTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.int32): torch.int32}

REFERENCE = r'''
import dataclasses, json, math, sys
from repro.launch import dryrun as R      # sets XLA_FLAGS before jax starts
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, SHAPES, get_arch
from repro.launch.mesh import make_production_mesh, mesh_axes
from repro.models import model as MDL
from repro.optim import adamw


def nbytes(mesh, tree, specs, drop_len=False):
    out = []

    def one(path, s, x):
        if not (drop_len and getattr(path[-1], "key", None) == "len"):
            out.append(math.prod(NamedSharding(mesh, s).shard_shape(x.shape))
                       * x.dtype.itemsize)
    jax.tree_util.tree_map_with_path(one, specs, tree,
                                     is_leaf=lambda s: isinstance(s, P))
    return sum(out)


cells = {}
for mp, name in ((False, "16x16"), (True, "2x16x16")):
    mesh = make_production_mesh(multi_pod=mp)
    dp_axes = mesh_axes(mp)[0]
    for arch in ARCHS:
        for shape in SHAPES:
            built, skip = R.build_cell(arch, shape, mp)
            tag = f"{arch}.{shape}.{name}"
            if built is None:
                cells[tag] = {"skip": skip}
                continue
            _, args, _, sh = built
            cfg = get_arch(arch).cfg
            mode = get_arch(arch).shape_params(shape)["mode"]
            p_specs = MDL.specs(cfg, sh, scan_layers=True)
            dp = dp_axes if sh.batch_dp else None
            rec = {"sh": dataclasses.asdict(sh),
                   "rough_params": R._rough_params(cfg),
                   "params": nbytes(mesh, args[0], p_specs)}
            enc = ([(args[-1], P(dp, None, None))]
                   if cfg.encoder is not None else [])
            if mode == "train":
                rec["opt"] = nbytes(mesh, args[1], adamw.state_specs(p_specs))
                ins = [(args[2], P(dp, None)), (args[3], P(dp, None))]
            elif mode == "prefill":
                ins = [(args[1], P(dp, None))]
            else:
                c_specs = MDL.cache_specs(cfg, sh, scan_layers=True)
                rec["caches"] = nbytes(mesh, args[1], c_specs, drop_len=True)
                ins = [(args[2], P(dp, None)), (args[3], P(dp))]
            rec["inputs"] = sum(nbytes(mesh, x, s) for x, s in ins + enc)
            cells[tag] = rec
json.dump(cells, sys.stdout)
'''


@pytest.fixture(scope="module")
def reference_cells():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout)


def _port_cell(arch, shape, multi_pod):
    """The port's record for one cell at the JAX package's 16e9 budget."""
    cell, skip = D.build_cell(arch, shape, multi_pod, hbm_bytes=16e9)
    if cell is None:
        return {"skip": skip}
    mem = D.argument_bytes(cell)
    names = {"param_bytes_per_dev": "params", "opt_bytes_per_dev": "opt",
             "cache_bytes_per_dev": "caches", "input_bytes_per_dev": "inputs"}
    return {"sh": json.loads(json.dumps(dataclasses.asdict(cell.sh))),
            "rough_params": D._rough_params(cell.cfg),
            **{names[k]: v for k, v in mem.items() if k in names}}


def test_cells_match_the_reference(reference_cells):
    assert len(reference_cells) == len(ARCHS) * len(SHAPES) * 2
    for tag, want in reference_cells.items():
        arch, shape, mesh = tag.split(".")
        assert _port_cell(arch, shape, mesh == "2x16x16") == want, tag


def test_fsdp_choices_that_move_with_the_h100_budget():
    """The cells where half of the H100's 80 GB, not half of 16 GB, turns
    FSDP off for inference (PERF.md lists them); every other field of
    every ShardCfg is the same at both budgets."""
    moved = []
    for mp in (False, True):
        for arch in ARCHS:
            for shape in SHAPES:
                v5e, _ = D.build_cell(arch, shape, mp, hbm_bytes=16e9)
                h100, _ = D.build_cell(arch, shape, mp)
                if v5e is None:
                    continue
                if v5e.sh != h100.sh:
                    assert dataclasses.replace(v5e.sh, fsdp=h100.sh.fsdp) \
                        == h100.sh
                    assert v5e.sh.fsdp and not h100.sh.fsdp
                    moved.append((arch, shape, mp))
    assert moved == [(a, s, mp) for mp in (False, True)
                     for a in ("grok_1_314b", "qwen2_vl_72b")
                     for s in ("prefill_32k", "decode_32k")], moved


def _spec(entries):
    """A spec as a tuple, a one-axis tuple entry read as its axis (JAX's
    PartitionSpec stores ("data",) as "data")."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _jtree(t):
    """A JAX tree as plain Python: specs as tuples, ShapeDtypeStructs as
    (shape, torch dtype), lists for sequences."""
    if isinstance(t, JP):
        return _spec(t)
    if isinstance(t, jax.ShapeDtypeStruct):
        return (tuple(t.shape), JDTYPES[t.dtype])
    if isinstance(t, dict):
        return {k: _jtree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_jtree(v) for v in t]
    return t


def _ttree(t):
    """The port's tree the same way (spec tuples stay tuples)."""
    if isinstance(t, torch.Tensor):
        assert t.device.type == "meta"
        return (tuple(t.shape), t.dtype)
    if isinstance(t, dict):
        return {k: _ttree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_ttree(v) for v in t]
    if isinstance(t, tuple):
        return _spec(t)
    return t


def _shard_variants(cfg):
    """Production ShardCfgs: FSDP on 16x16, a sequence-sharded cache, and
    the multi-pod mesh with a replicated batch and FSDP off."""
    base = cfg.shard_cfg(dp=("data",), tp_size=16, dp_size=16)
    return [base,
            dataclasses.replace(base, cache_seq=("model",),
                                cache_seq_size=16),
            dataclasses.replace(cfg.shard_cfg(
                dp=("pod", "data"), tp_size=16, dp_size=32, batch_dp=False,
                cache_seq=("pod", "data", "model"), cache_seq_size=512),
                fsdp=False)]


@pytest.mark.parametrize("arch", ARCHS)
def test_trees_match_the_reference(arch):
    jcfg, cfg = jget_arch(arch).cfg, get_arch(arch).cfg
    for jsh, sh in zip(_shard_variants(jcfg), _shard_variants(cfg)):
        assert _ttree(M.specs(cfg, sh)) == _jtree(JM.specs(jcfg, jsh))
        params = M.shapes(cfg, sh)
        assert _ttree(params) == _jtree(JM.shapes(jcfg, jsh))
        assert _ttree(M.cache_specs(cfg, sh)) == _jtree(
            JM.cache_specs(jcfg, jsh))
        caches = _ttree(M.make_caches(cfg, sh, 4, 1024, device="meta"))
        for c in caches:
            if "len" in c:
                assert c["len"] == 0
                c["len"] = ((), torch.int32)
        assert caches == _jtree(jax.eval_shape(
            lambda: JM.make_caches(jcfg, jsh, 4, 1024)))
    # the optimizer state of meta parameters: float32 moments, an int32 step
    opt = adamw.init(params)
    assert opt.step.device.type == "meta" and opt.step.dtype == torch.int32
    f32 = M.L.tree_map_defs(lambda d: (tuple(d.shape), torch.float32),
                            M.model_defs(cfg, sh))
    assert _ttree(opt.m) == _ttree(opt.v) == f32


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_input_specs_match_the_reference(shape, batch):
    jcfg, cfg = jget_arch("qwen1_5_0_5b").cfg, get_arch("qwen1_5_0_5b").cfg
    sp = dict(SHAPES[shape], batch=batch)
    for dp_axes, mp in ((("data",), False), (("pod", "data"), True)):
        got = input_specs(cfg, sp, dp_axes, mp)
        want = jinput_specs(jcfg, sp, dp_axes, mp)
        assert _ttree(got) == _jtree(want)
        assert list(got) == list(want)


def _smoke_cell(arch, mode, batch, seq):
    cfg = get_arch(arch).smoke
    sh = D.shard_cfg(cfg, dict(seq=seq, batch=batch, mode=mode), ONE)
    params = M.shapes(cfg, sh)
    return D.Cell(arch=arch, shape=mode, mode=mode, cfg=cfg, sh=sh, mesh=ONE,
                  seq=seq, batch=batch, params=params,
                  opt_state=adamw.init(params) if mode == "train" else None,
                  step=D._step_fn(cfg, sh, mode))


@pytest.mark.parametrize("arch", ["gpt2_small", "moonshot_v1_16b_a3b",
                                  "jamba_v0_1_52b", "xlstm_350m",
                                  "whisper_small"])
def test_meta_trace_equals_real_tensors(arch):
    """A train step, a prefill and a decode step of the smoke config traced
    on meta count the same FLOPs, unfused bytes and peak temporary bytes
    as the same steps on real CPU tensors."""
    for mode, seq in (("train", 16), ("prefill", 16), ("decode", 32)):
        cell = _smoke_cell(arch, mode, 2, seq)
        meta = D.trace(cell.step, cell.arguments("meta")[0])
        real = D.trace(cell.step, D.materialize(
            cell, "cpu", torch.Generator().manual_seed(0)))
        assert meta == real, (mode, meta, real)
        assert meta["flops"] > 0 and meta["bytes"] > 0 and meta["temp"] > 0


def test_gpt2_forward_flops_closed_form():
    """2 x tokens x (the matmul weights and the head) plus the two
    attention einsums (scores and output), per layer."""
    cell = _smoke_cell("gpt2_small", "prefill", 2, 16)
    cfg = cell.cfg
    T, S = 2 * 16, 16
    per_layer = (cfg.d * cfg.heads * cfg.dh * 2 + cfg.d * cfg.kv_heads
                 * cfg.dh * 2 + 2 * cfg.d * cfg.d_ff)
    head = cfg.d * cfg.vocab_padded
    attn = 2 * (2 * 2 * cfg.heads * S * S * cfg.dh)
    want = 2 * T * (cfg.n_layers * per_layer + head) + cfg.n_layers * attn
    assert D.trace(cell.step, cell.arguments("meta")[0])["flops"] == want


def test_allocator_bounds():
    """512 B rounding for every block, none for an empty tensor, and up to
    1 MiB of unsplit tail for each block over 1 MiB."""
    mib = 1 << 20
    assert D.allocator_bounds([]) == (0, 0)
    assert D.allocator_bounds([0, 1, 512, 513]) == (0 + 512 + 512 + 1024,) * 2
    assert D.allocator_bounds([mib]) == (mib, mib)
    assert D.allocator_bounds([mib + 1, 3 * mib]) == (
        mib + 512 + 3 * mib, mib + 512 + 3 * mib + 2 * mib)


def test_argument_alloc_bounds():
    """The arguments' allocator bounds: their bytes rounded per tensor, and
    1 MiB more for each tensor over 1 MiB."""
    cell, _ = D.build_cell("qwen1_5_0_5b", "decode_32k")
    m = D.argument_bytes(cell)
    lo, hi = m["argument_alloc_min_per_dev"], m["argument_alloc_max_per_dev"]
    assert m["argument_bytes_per_dev"] <= lo < hi
    args, specs = cell.arguments("meta")
    sizes = [n for k in args
             for n in D.per_device_sizes(args[k], specs[k], cell.mesh.shape)]
    assert sum(sizes) == m["argument_bytes_per_dev"]
    assert hi - lo == D.ALLOC_TAIL * sum(n > D.ALLOC_TAIL for n in sizes)


@pytest.mark.parametrize("arch,shape,noted", [
    ("gemma3_1b", "long_500k", True),        # batch 1: data + model
    ("jamba_v0_1_52b", "long_500k", True),
    ("xlstm_350m", "long_500k", False),      # no KV cache
    ("qwen1_5_0_5b", "decode_32k", False)])  # over the model axis only
def test_cache_note_where_the_trace_reads_the_whole_cache(arch, shape,
                                                           noted):
    cell, _ = D.build_cell(arch, shape)
    notes = D._cache_notes(cell)
    assert bool(notes) == noted
    if noted:
        assert cell.sh.cache_seq_size == 256 and "16x" in notes[0]


def test_trace_counter_peak_and_scratch():
    """The peak counts storages from the op that makes them until they are
    freed, views and the arguments excluded; logsumexp adds its hidden
    temporary of its input's size."""
    x = torch.empty((1024,), device="meta")

    def step(x):
        a = x + 1                 # 4 KiB live
        b = a.view(32, 32) * 2    # 8 KiB live
        del a
        c = b + 1                 # 8 KiB live (a freed)
        return torch.logsumexp(c, dim=-1)   # + 128 B, + 4 KiB scratch
    got = D.trace(step, {"x": x})
    assert got["temp"] == 4096 * 2 + 128 + 4096
    assert got["bytes"] == 3 * 2 * 4096 + 4096 + 128
    assert got["flops"] == 0


def _decode_run(jcfg, cfg, jp, tp, jsh, sh, toks, cap, prefill):
    """A cached prefill then one decode step per remaining token, both
    packages; each step's logits compared and its argmax equal."""
    jc = JM.make_caches(jcfg, jsh, B, cap)
    tc = M.make_caches(cfg, sh, B, cap, device="cpu")
    jl, jc, _ = JM.forward(jcfg, jsh, jp, jnp.asarray(toks[:, :prefill]),
                           caches=jc)
    tl, tc, _ = M.forward(cfg, sh, tp, torch.as_tensor(toks[:, :prefill]),
                          caches=tc)
    _close(jl, tl, **EXACT)
    out = []
    for i in range(prefill, toks.shape[1]):
        jl, jc = JM.decode_step(jcfg, jsh, jp, jnp.asarray(toks[:, i:i + 1]),
                                jnp.full(B, i, jnp.int32), jc)
        tl, tc = M.decode_step(cfg, sh, tp, torch.as_tensor(toks[:, i:i + 1]),
                               torch.full((B,), i, dtype=torch.int64), tc)
        _close(jl, tl, **EXACT)
        assert np.array_equal(np.argmax(np.asarray(jl), -1),
                              tl.argmax(-1).numpy())
        out.append(tl)
    return out


def _seq_sharded(jsh, sh):
    """The cache sharded along the sequence over ``data``, the batch
    replicated, as the JAX package's decode cells pair them (its ``cstr``
    raises on ``data`` named for both the batch and the sequence)."""
    kw = dict(cache_seq=("data",), cache_seq_size=1, batch_dp=False)
    return dataclasses.replace(jsh, **kw), dataclasses.replace(sh, **kw)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "gemma3_1b"])
def test_cache_seq_matches_reference(arch):
    """tinyllama: a 16-token prefill into caches of 24, then 3 decode
    steps; gemma3 with window 4: the windowed layers' caches are rings of
    4 slots, a 3-token prefill, then 9 decode steps that wrap them."""
    jcfg, cfg, jp, tp, jsh, sh = _pair(arch)
    prefill, steps = 16, 3
    if arch == "gemma3_1b":
        jcfg = dataclasses.replace(jcfg, layers=tuple(
            dataclasses.replace(s, window=4) if s.window else s
            for s in jcfg.layers))
        cfg = dataclasses.replace(cfg, layers=tuple(
            dataclasses.replace(s, window=4) if s.window else s
            for s in cfg.layers))
        prefill, steps = 3, 9
    toks = _tokens(cfg, seed=5, n=prefill + steps)
    _decode_run(jcfg, cfg, jp, tp, *_seq_sharded(jsh, sh), toks, 24, prefill)


def test_cache_seq_full_cache_writes_nothing():
    """Decode steps past a full plain cache (len >= cap): the JAX package's
    masked insert matches no slot and writes nothing, where the unsharded
    path's slice clamps onto the last slot.  Both pinned against JAX."""
    jcfg, cfg, jp, tp, jsh, sh = _pair("tinyllama_1_1b")
    toks = _tokens(cfg, seed=6, n=10)
    plain = _decode_run(jcfg, cfg, jp, tp, jsh, sh, toks, 8, 8)
    sharded = _decode_run(jcfg, cfg, jp, tp, *_seq_sharded(jsh, sh), toks,
                          8, 8)
    assert not torch.equal(plain[-1], sharded[-1])
