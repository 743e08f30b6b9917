"""Dry run of the port: every (arch x shape x mesh) cell's per-device
arguments, FLOPs, bytes and memory, with roofline terms from the H100's
constants (mirrors ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch qwen1_5_0_5b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out reports/dryrun]

No device is needed: the cell's step runs once on ``meta`` tensors.  For
each cell:

* the ``ShardCfg`` follows the JAX package's rules (``shard_cfg``), with
  the FSDP-off budget taken from the card's HBM instead of a v5e's;
* each argument's bytes on one device are exact arithmetic: every
  dimension divided by the product of the mesh axes its partition spec
  names (``per_device_sizes``), and the blocks the caching allocator
  gives them lie within bounds set by its rule (``allocator_bounds``);
* the step (``loss_fn`` + backward + ``adamw.update`` with remat for
  train, ``forward`` for prefill, ``decode_step`` for decode) on the
  stacked parameter tree (``scan_layers``, as the JAX package's dry run)
  is traced at full width and depth and at one device's batch, under
  three counters:
  ``FlopCounterMode``, the bytes every op reads and writes, and the peak of
  bytes live beyond the arguments (``TraceCounter``);
* FLOPs and bytes are split evenly over the model axis.

Nothing is compiled and no collective is traced, so the record has no
``compile_s``, no HLO numbers and ``collective_s: null``.  Records land as
JSON under ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch._tree import leaves, tree_map
from repro_torch.configs import ARCHS, SHAPES, get_arch, input_specs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import model as MDL
from repro_torch.models.layers import P
from repro_torch.optim import adamw

# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU datasheet
# (dense rates, no sparsity, at the 700 W limit).
HBM_BYTES = 80e9             # device memory
PEAK_FLOPS = 989e12          # bf16 tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s

# The CUDA caching allocator's rule for one tensor's block (PyTorch's
# c10/cuda/CUDACachingAllocator.cpp, default settings): its bytes rounded
# up to 512 (kMinBlockSize); a block over 1 MiB (kSmallSize) comes from the
# large pool, which leaves a free block's remainder unsplit when it is
# 1 MiB or less, so such a block may hold up to 1 MiB more.
ALLOC_ROUND = 512
ALLOC_TAIL = 1 << 20

# timed steps after the counted one in check_on_card (their median is
# reported)
CARD_REPEATS = 3

NOTES = [
    "flops_per_dev and bytes_per_dev are the trace's totals at one "
    "device's batch divided evenly over the model axis (an ideal split)",
    "bytes_per_dev sums every op's input and output bytes, unfused",
    "temp_bytes_per_dev is the trace's peak beyond the arguments, not "
    "divided over the model axis: an upper bound where that axis shards "
    "activations",
    "collective_s and collectives_per_dev are null: the port has no SPMD "
    "partitioner, and the bytes GSPMD would move are not the port's to "
    "guess",
    "nothing is compiled: the terms are the dry run's estimates from the "
    "H100's datasheet constants, not a measurement",
]


def _rough_params(cfg) -> int:
    d, ff = cfg.d, cfg.d_ff
    n = cfg.vocab_padded * d * (1 if cfg.tie_embeddings else 2)
    for spec in cfg.layers:
        n += 4 * d * cfg.heads * cfg.dh // max(
            cfg.heads // cfg.kv_heads, 1) + 2 * d * cfg.heads * cfg.dh
        if spec.moe:
            n += cfg.n_experts * 3 * d * (cfg.moe_ff or ff)
        elif ff:
            n += (3 if cfg.gated_mlp else 2) * d * ff
    return n


def shard_cfg(cfg, sp: Dict, mesh: Mesh, hbm_bytes: float = HBM_BYTES):
    """The JAX package's ShardCfg rules for one cell:

    * the batch shards over the data axes when it divides by them;
    * a decode cache of at least 8192 whose length divides shards along
      the sequence over ``model`` (or over the data axes and ``model``);
    * inference drops FSDP when the bf16 weights split over ``model`` fit
      in half of ``hbm_bytes``, unless attention is replicated and the
      weights exceed a quarter of it (16e9 gives the JAX package's 8e9 and
      4e9 exactly)."""
    dp_axes, _, dp_size, tp_size = mesh.axes()
    seq, batch, mode = sp["seq"], sp["batch"], sp["mode"]
    batch_dp = batch % dp_size == 0
    cache_seq: tuple = ()
    cache_seq_size = 1
    if mode == "decode":
        cache_axes = ("model",) if batch_dp else dp_axes + ("model",)
        size = tp_size if batch_dp else dp_size * tp_size
        if seq % size == 0 and seq >= 8192:
            cache_seq, cache_seq_size = cache_axes, size
    sh = cfg.shard_cfg(dp=dp_axes, tp_size=tp_size, dp_size=dp_size,
                       cache_seq=cache_seq, cache_seq_size=cache_seq_size,
                       batch_dp=batch_dp)
    if mode in ("decode", "prefill"):
        pbytes = 2 * _rough_params(cfg)
        if pbytes / tp_size < hbm_bytes / 2 and (
                cfg.attn_tp or pbytes < hbm_bytes / 4):
            sh = dataclasses.replace(sh, fsdp=False)
    return sh


def _axis_count(entry, sizes: Dict[str, int]) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return sizes[entry]
    return math.prod(sizes[a] for a in entry)


def tensor_bytes_per_device(t: torch.Tensor, spec, sizes: Dict[str, int]
                            ) -> int:
    """A tensor's bytes on one device: each dimension divided by the
    product of the mesh axes its spec entry names (rounded up where they
    do not divide it)."""
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    n = 1
    for dim, entry in zip(t.shape, spec):
        n *= -(-dim // _axis_count(entry, sizes))
    return n * t.element_size()


def per_device_sizes(tree, specs, sizes: Dict[str, int]) -> List[int]:
    """The bytes on one device of each of a tree's tensors; ``specs`` has
    the tree's structure with a spec tuple for each tensor.  A non-tensor
    leaf (a KV cache's host-int ``len``) takes no device bytes."""
    if isinstance(tree, torch.Tensor):
        return [tensor_bytes_per_device(tree, specs, sizes)]
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in per_device_sizes(v, specs[k], sizes)]
    if isinstance(tree, (list, tuple)):
        return [n for v, s in zip(tree, specs)
                for n in per_device_sizes(v, s, sizes)]
    return []


def allocator_bounds(nbytes: List[int]) -> Tuple[int, int]:
    """The least and the most bytes the caching allocator's blocks for
    tensors of ``nbytes`` hold, by its rule (``ALLOC_ROUND``,
    ``ALLOC_TAIL``); an empty tensor takes no block."""
    blocks = [-(-n // ALLOC_ROUND) * ALLOC_ROUND for n in nbytes]
    tails = sum(ALLOC_TAIL for b in blocks if b > ALLOC_TAIL)
    return sum(blocks), sum(blocks) + tails


# ---------------------------------------------------------------------------
# Cells.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    mode: str
    cfg: Any
    sh: Any
    mesh: Mesh
    seq: int
    batch: int
    params: Any
    opt_state: Any
    step: Callable

    @property
    def scan_layers(self) -> bool:
        """Whether the parameters are the stacked tree (as ``build_cell``
        makes them) or the per-layer one."""
        return "blocks" in self.params

    @property
    def per_device_batch(self) -> int:
        dp_size = self.mesh.axes()[2]
        return self.batch // dp_size if self.sh.batch_dp else self.batch

    def arguments(self, device, batch: Optional[int] = None):
        """The step's keyword arguments and their spec trees at ``batch``
        (the cell's global batch by default).  Parameters, optimizer state
        and inputs are meta tensors; the caches are made on ``device``."""
        cfg, sh, mode = self.cfg, self.sh, self.mode
        batch = self.batch if batch is None else batch
        dp = sh.dp if sh.batch_dp else None
        inp = input_specs(cfg, dict(seq=self.seq, batch=batch, mode=mode))
        scan = self.scan_layers
        args: Dict[str, Any] = {"params": self.params}
        specs: Dict[str, Any] = {"params": MDL.specs(cfg, sh, scan)}
        if mode == "train":
            args["opt_state"] = self.opt_state
            specs["opt_state"] = adamw.state_specs(specs["params"])
            for k in ("tokens", "labels"):
                args[k], specs[k] = inp[k], P(dp, None)
        elif mode == "prefill":
            args["tokens"], specs["tokens"] = inp["tokens"], P(dp, None)
        else:
            args["caches"] = MDL.make_caches(cfg, sh, batch, self.seq,
                                             device=device, scan_layers=scan)
            specs["caches"] = MDL.cache_specs(cfg, sh, scan)
            args["token"], specs["token"] = inp["token"], P(dp, None)
            args["pos"], specs["pos"] = inp["pos"], P(dp)
        if cfg.encoder is not None:
            args["enc"] = torch.empty((batch, cfg.encoder.frames, cfg.d),
                                      dtype=cfg.dtype, device="meta")
            specs["enc"] = P(dp, None, None)
        return args, specs


def _step_fn(cfg, sh, mode: str) -> Callable:
    if mode == "train":
        opt_cfg = adamw.AdamWCfg()

        def train_step(params, opt_state, tokens, labels, enc=None):
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            with torch.enable_grad():
                loss = MDL.loss_fn(cfg, sh, live, tokens, labels,
                                   enc_input=enc, remat=True)
                grads = torch.autograd.grad(loss, leaves(live),
                                            materialize_grads=True)
            del live
            params, opt_state, metrics = adamw.update(opt_cfg, opt_state,
                                                      params, list(grads))
            metrics["loss"] = loss.detach()
            return params, opt_state, metrics
        return train_step

    if mode == "prefill":
        @torch.no_grad()
        def prefill(params, tokens, enc=None):
            logits, _, _ = MDL.forward(cfg, sh, params, tokens,
                                       enc_input=enc, remat=False)
            return logits
        return prefill

    @torch.no_grad()
    def serve_step(params, caches, token, pos, enc=None):
        return MDL.decode_step(cfg, sh, params, token, pos, caches,
                               enc_input=enc)
    return serve_step


def build_cell(arch: str, shape: str, multi_pod: bool = False, *,
               mesh: Optional[Mesh] = None, batch: Optional[int] = None,
               hbm_bytes: float = HBM_BYTES):
    """Returns (Cell, None), or (None, skip reason) for a skipped shape.
    The parameters (and a decode cell's caches) are the stacked tree
    (``scan_layers``), the argument tree the JAX package's dry run lowers.
    ``mesh`` defaults to the production mesh; ``batch`` replaces the
    shape's global batch (a cut, which the caller reports)."""
    bundle = get_arch(arch)
    cfg = bundle.cfg
    sp = bundle.shape_params(shape)
    if sp is None:
        return None, bundle.skip[shape]
    if batch is not None:
        sp = dict(sp, batch=batch)
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    sh = shard_cfg(cfg, sp, mesh, hbm_bytes)
    params = MDL.shapes(cfg, sh, scan_layers=True)
    opt_state = adamw.init(params) if sp["mode"] == "train" else None
    return Cell(arch=arch, shape=shape, mode=sp["mode"], cfg=cfg, sh=sh,
                mesh=mesh, seq=sp["seq"], batch=sp["batch"], params=params,
                opt_state=opt_state,
                step=_step_fn(cfg, sh, sp["mode"])), None


# ---------------------------------------------------------------------------
# The trace.
# ---------------------------------------------------------------------------
_aten = torch.ops.aten
# ops that allocate and write nothing, or only alias their input
_NO_DATA = {_aten._unsafe_view.default, _aten.lift_fresh.default,
            _aten.empty.memory_format, _aten.empty_strided.default,
            _aten.empty_like.default, _aten.new_empty.default,
            _aten.new_empty_strided.default}
# ATen kernels that build a temporary a dispatch mode cannot see:
# logsumexp makes ``self - max`` (exponentiated in place) of its input's
# size, freed before it returns
_SCRATCH = {_aten.logsumexp.default: lambda args: _nbytes(args[0])}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceCounter(TorchDispatchMode):
    """Counts, over every op dispatched while it is active:

    * ``bytes``: the bytes of each op's tensor inputs and outputs (views and
      allocations without a write count nothing);
    * ``peak``: the most bytes held at once by storages made while it was
      active, the storages of ``keep`` (the arguments, which the caller
      keeps alive throughout) excluded; a storage counts from the op that
      makes it until it is freed."""

    def __init__(self, keep=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._keep = {id(t.untyped_storage()) for t in keep}
        self._seen = set()

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not (func.is_view or func in _NO_DATA):
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._keep or key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            weakref.finalize(st, self._free, key, n)
        scratch = _SCRATCH.get(func)
        extra = scratch(args) if scratch is not None else 0
        self.peak = max(self.peak, self.live + extra)
        return out


def trace(step: Callable, args: Dict[str, Any]) -> Dict[str, int]:
    """Run ``step(**args)`` once under FlopCounterMode and a TraceCounter:
    its FLOPs, unfused bytes and peak bytes beyond the arguments."""
    keep = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    with FlopCounterMode(display=False) as flops, TraceCounter(keep) as cnt:
        out = step(**args)
        del out
    return {"flops": int(flops.get_total_flops()), "bytes": cnt.bytes,
            "temp": cnt.peak}


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.axis_sizes)


def argument_bytes(cell: Cell) -> Dict[str, int]:
    """The arguments' bytes on one device: parameters, optimizer state
    (train), caches (decode), inputs, and their sum; then the least and
    the most that the caching allocator's blocks for them hold."""
    args, specs = cell.arguments("meta")
    part = {k: per_device_sizes(args[k], specs[k], cell.mesh.shape)
            for k in args}
    lo, hi = allocator_bounds([n for v in part.values() for n in v])
    memory = {"param_bytes_per_dev": sum(part.pop("params"))}
    if "opt_state" in part:
        memory["opt_bytes_per_dev"] = sum(part.pop("opt_state"))
    if "caches" in part:
        memory["cache_bytes_per_dev"] = sum(part.pop("caches"))
    memory["input_bytes_per_dev"] = sum(sum(v) for v in part.values())
    memory["argument_bytes_per_dev"] = sum(memory.values())
    memory["argument_alloc_min_per_dev"] = lo
    memory["argument_alloc_max_per_dev"] = hi
    return memory


def estimate(cell: Cell) -> Dict[str, Any]:
    """The cell's record: per-device argument bytes, the trace's counts and
    the roofline terms."""
    memory = argument_bytes(cell)
    t0 = time.perf_counter()
    trace_args, _ = cell.arguments("meta", cell.per_device_batch)
    counts = trace(cell.step, trace_args)
    trace_s = time.perf_counter() - t0
    memory["temp_bytes_per_dev"] = counts["temp"]
    tp_size = cell.mesh.axes()[3]
    flops = counts["flops"] / tp_size
    byts = counts["bytes"] / tp_size
    rec = {"n_chips": cell.mesh.size, "trace_s": trace_s,
           "per_device_batch": cell.per_device_batch,
           "flops_traced": counts["flops"], "bytes_unfused": counts["bytes"],
           "flops_per_dev": flops, "bytes_per_dev": byts, "memory": memory,
           "compute_s": flops / PEAK_FLOPS, "memory_s": byts / HBM_BW,
           "collective_s": None, "collectives_per_dev": None}
    rec["bottleneck"] = max(("compute_s", "memory_s"), key=lambda k: rec[k])
    rec["fits"] = (memory["argument_alloc_max_per_dev"]
                   + memory["temp_bytes_per_dev"]) <= HBM_BYTES
    rec["notes"] = NOTES + _cache_notes(cell)
    return rec


def _cache_notes(cell: Cell) -> List[str]:
    """Where a KV cache shards along the sequence over more devices than
    the model axis, the trace still reads it whole."""
    n, tp_size = cell.sh.cache_seq_size, cell.mesh.axes()[3]
    if n <= tp_size or all(s.kind != "attn" for s in cell.cfg.layers):
        return []
    return [f"the KV cache shards along the sequence over {n} devices, but the "
            "trace reads it at full length and flops_per_dev and "
            "bytes_per_dev divide it by the model axis only: they overstate "
            f"each device's cache traffic by up to {n // tp_size}x, and "
            "temp_bytes_per_dev holds a full-length copy of it"]


def materialize(cell: Cell, device, gen: torch.Generator) -> Dict[str, Any]:
    """The step's arguments as real tensors on ``device``, of the meta
    arguments' shapes and dtypes: weights drawn by ``model.init`` from
    ``gen``, zero optimizer state and caches, token ids uniform in the
    vocabulary, positions 0, a normal ``enc_input``."""
    dev = resolve_device(device)
    meta, _ = cell.arguments("meta")
    args, _ = cell.arguments(dev)
    args["params"] = MDL.init(cell.cfg, cell.sh, gen, dev, cell.scan_layers)
    if "opt_state" in args:
        args["opt_state"] = adamw.init(args["params"])
    for k in ("tokens", "labels", "token"):
        if k in args:
            args[k] = torch.randint(0, cell.cfg.vocab, tuple(meta[k].shape),
                                    generator=gen, device=gen.device,
                                    dtype=torch.int32).to(dev)
    if "pos" in args:
        args["pos"] = torch.zeros(meta["pos"].shape, dtype=torch.int32,
                                  device=dev)
    if "enc" in args:
        args["enc"] = torch.randn(tuple(meta["enc"].shape), generator=gen,
                                  device=gen.device).to(dev, cell.cfg.dtype)
    got = [(tuple(t.shape), t.dtype) for t in tree_leaves(args)
           if isinstance(t, torch.Tensor)]
    want = [(tuple(t.shape), t.dtype) for t in tree_leaves(meta)
            if isinstance(t, torch.Tensor)]
    if got != want:
        raise ValueError(f"{cell.arch}.{cell.shape}: materialised arguments "
                         "differ from the meta arguments")
    return args


def check_on_card(cell: Cell, device, gen: torch.Generator
                  ) -> Dict[str, Any]:
    """The estimate of a one-device cell held against the same step run
    for real on one card: the bytes that ``memory_allocated`` gains when
    the arguments are materialised (between ``argument_alloc_min_per_dev``
    and ``argument_alloc_max_per_dev``, the allocator's rule applied to
    each tensor), the bytes the allocator was asked for (equal to
    ``argument_bytes_per_dev``), the peak allocated over a step (within
    10% of arguments plus ``temp_bytes_per_dev``), and FlopCounterMode's
    count (equal to the meta trace's).  ``misses`` lists what failed; the
    step's wall ms (median of ``CARD_REPEATS`` after the counted step) is
    reported beside the roofline's, never checked."""
    dev = resolve_device(device)
    if dev.type != "cuda" or cell.mesh.size != 1:
        raise ValueError("check_on_card runs a one-device cell on a card")
    est = estimate(cell)
    mem = est["memory"]
    gc.collect()
    torch.cuda.synchronize(dev)

    def requested():
        return torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
    base, base_requested = torch.cuda.memory_allocated(dev), requested()
    args = materialize(cell, dev, gen)
    torch.cuda.synchronize(dev)
    arg_allocated = torch.cuda.memory_allocated(dev) - base
    arg_bytes = requested() - base_requested
    n_tensors = sum(isinstance(t, torch.Tensor) for t in tree_leaves(args))
    torch.cuda.reset_peak_memory_stats(dev)
    with FlopCounterMode(display=False) as counter:
        out = cell.step(**args)
        del out
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    flops = int(counter.get_total_flops())
    times = []
    for _ in range(CARD_REPEATS):
        t0 = time.perf_counter()
        out = cell.step(**args)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        del out
    del args
    gc.collect()
    step_ms = statistics.median(times) * 1e3
    roofline_ms = max(est["compute_s"], est["memory_s"]) * 1e3
    want_args = mem["argument_bytes_per_dev"]
    lo = mem["argument_alloc_min_per_dev"]
    hi = mem["argument_alloc_max_per_dev"]
    want_peak = want_args + mem["temp_bytes_per_dev"]
    misses = []
    if not lo <= arg_allocated <= hi:
        misses.append(f"arguments allocated {arg_allocated} B, the "
                      f"allocator's rule gives {lo}..{hi} B "
                      f"({n_tensors} tensors)")
    if arg_bytes != want_args:
        misses.append(f"arguments requested {arg_bytes} B, estimated "
                      f"{want_args} B")
    if abs(peak - want_peak) > 0.1 * want_peak:
        misses.append(f"peak allocated {peak} B, estimated {want_peak} B")
    if flops != est["flops_traced"]:
        misses.append(f"FLOPs on the card {flops}, meta trace "
                      f"{est['flops_traced']}")
    return {"estimate": est, "argument_bytes_requested": arg_bytes,
            "argument_bytes_allocated": arg_allocated,
            "tensors": n_tensors, "peak_bytes": peak,
            "peak_over_estimate": peak / want_peak, "flops": flops,
            "step_ms": step_ms, "roofline_ms": roofline_ms,
            "step_over_roofline": step_ms / roofline_ms, "misses": misses}


def _write(rec: Dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, rec["cell"] + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str):
    mesh = make_production_mesh(multi_pod=multi_pod)
    name = mesh_name(mesh)
    tag = f"{arch}.{shape}.{name}"
    rec: Dict[str, Any] = {"cell": tag, "arch": arch, "shape": shape,
                           "mesh": name}
    try:
        cell, skip_reason = build_cell(arch, shape, multi_pod)
        if cell is None:
            print(f"[SKIP] {tag}: {skip_reason}")
            rec.update(status="skip", reason=skip_reason)
            _write(rec, out_dir)
            return rec
        rec["status"] = "ok"
        rec.update(estimate(cell))
        m = rec["memory"]
        print(f"[OK] {tag}: trace {rec['trace_s']:.2f}s | flops/dev "
              f"{rec['flops_per_dev']:.3e} bytes/dev "
              f"{rec['bytes_per_dev']:.3e} | compute "
              f"{rec['compute_s'] * 1e3:.2f}ms memory "
              f"{rec['memory_s'] * 1e3:.2f}ms -> {rec['bottleneck']} | "
              f"args {m['argument_bytes_per_dev'] / 1e9:.3f} GB temp "
              f"{m['temp_bytes_per_dev'] / 1e9:.3f} GB fits {rec['fits']}")
    except Exception as e:  # noqa: BLE001  (a cell's failure is its record)
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        print(f"[FAIL] {tag}: {rec['error']}")
        traceback.print_exc()
    _write(rec, out_dir)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="reports/dryrun")
    args = ap.parse_args(argv)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        archs = [a for a in ARCHS if a not in ("gpt2_small",
                                               "tinyllama_1_1b")]
        cells = [(a, s) for a in archs for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    results = [run_cell(a, s, mp, args.out) for mp in meshes
               for a, s in cells]
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skip, {n_fail} fail ==")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
