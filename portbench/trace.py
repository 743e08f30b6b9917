"""What a traced run reads: the device's activity under torch.profiler
(CUDA activity only) and the logical shape of every call into the
program's K1 and K3 kernel wrappers, recorded from here by wrapping their
entry functions for the length of one call of ``fn``."""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, List, Tuple

import torch

from . import cost

# The program's kernel names (csrc/poseidon2.cu, csrc/sumcheck_round.cu)
# by the wrapper they belong to.
KERNEL_NAMES = {
    "k1": ("permute_kernel", "sponge_kernel", "squeeze_kernel",
           "compress_kernel"),
    "k3": ("partial_kernel", "absorb_kernel", "fold_kernel", "tail_kernel"),
}
TOP = 10


def _k1_entries(K1, calls: List[Tuple[str, cost.Work]]):
    def permute_batch(states):
        calls.append(("k1", cost.k1_permute(states.shape[0])))
        return orig["permute_batch"](states)

    def sponge(init, elems, seg_len, nseg=1, out_width=cost.WIDTH):
        calls.append(("k1", cost.k1_sponge(elems.shape[0], seg_len, nseg,
                                           out_width, init is not None)))
        return orig["sponge"](init, elems, seg_len, nseg, out_width)

    def squeeze(states, nblocks):
        calls.append(("k1", cost.k1_squeeze(states.shape[0], nblocks)))
        return orig["squeeze"](states, nblocks)

    def compress_pairs(left, right):
        calls.append(("k1", cost.k1_compress(left.numel() // cost.DIGEST)))
        return orig["compress_pairs"](left, right)

    orig = {f.__name__: getattr(K1, f.__name__)
            for f in (permute_batch, sponge, squeeze, compress_pairs)}
    return orig, dict(permute_batch=permute_batch, sponge=sponge,
                      squeeze=squeeze, compress_pairs=compress_pairs)


def _k3_entries(K3, calls: List[Tuple[str, cost.Work]]):
    def prove_rounds(factors, states):
        K, n = factors[0].shape[0], factors[0].shape[1]
        # the round batcher pads K to a power of two with zero states:
        # the padding is not work the protocol needs
        real = int((states != 0).any(dim=1).sum()) if K > 1 else 1
        calls.append(("k3", cost.k3_prove(len(factors), n, real)))
        return orig["prove_rounds"](factors, states)

    orig = {"prove_rounds": K3.prove_rounds}
    return orig, dict(prove_rounds=prove_rounds)


@contextlib.contextmanager
def recorded_calls(calls: List[Tuple[str, cost.Work]]):
    """Record (kernel, work) of every K1 and K3 wrapper call inside."""
    from repro_torch.kernels import poseidon2_kernel as K1
    from repro_torch.kernels import sumcheck_round as K3
    patches = [(K1, *_k1_entries(K1, calls)), (K3, *_k3_entries(K3, calls))]
    for mod, _, new in patches:
        for name, fn in new.items():
            setattr(mod, name, fn)
    try:
        yield calls
    finally:
        for mod, orig, _ in patches:
            for name, fn in orig.items():
                setattr(mod, name, fn)


def k2k4_shapes():
    """The program's K2 and K4 call histograms as they stand."""
    from repro_torch.kernels import modmatmul as K4
    from repro_torch.kernels import ntt_kernel as K2
    return collections.Counter(K2.launch_shapes), \
        collections.Counter(K4.launch_shapes)


def k2k4_ops(before) -> Dict[str, float]:
    """Modular products of the K2 and K4 calls made since ``before``
    (k2k4_shapes), from the program's histograms of their shapes."""
    k2, k4 = (now - then for now, then in zip(k2k4_shapes(), before))
    return dict(k2=sum(n * cost.k2_encode(*s)[0] for s, n in k2.items()),
                k4=sum(n * cost.k4_modmatmul(*s)[0] for s, n in k4.items()))


def _union(intervals: List[Tuple[float, float, str]]):
    """Merged busy intervals (start, end, first name, last name)."""
    out = []
    for s, e, name in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1], out[-1][3] = e, name
        else:
            out.append([s, e, name, name])
    return out


def profiled(fn: Callable, *args) -> Tuple[object, Dict]:
    """Run fn(*args) under torch.profiler; return its result and what the
    trace says: wall seconds of the traced call, seconds in which an
    operation ran on the device, kernels launched, device seconds by
    operation name and by KERNEL_NAMES group, the longest idle gaps, and
    the work of the K1/K3 calls made."""
    from torch.profiler import ProfilerActivity, profile
    calls: List[Tuple[str, cost.Work]] = []
    t0 = time.monotonic()
    # a CPU run (the tests) traces the host: it has no device activity
    activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU)
    with profile(activities=[activity]) as prof:
        with recorded_calls(calls):
            result = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
    parse_s = time.monotonic() - t0 - wall
    t1 = time.monotonic()
    spans, by_name, launches = [], collections.Counter(), 0
    # the profiler's raw events: building its FunctionEvent tree for a few
    # hundred thousand kernels takes minutes
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s = ev.start_ns() / 1e9
        e = s + ev.duration_ns() / 1e9
        name = ev.name()
        spans.append((s, e, name))
        by_name[name] += e - s
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
    busy = _union(spans)
    gaps = sorted(((nxt[0] - cur[1], f"after {cur[3][:60]} / before {nxt[2][:60]}")
                   for cur, nxt in zip(busy, busy[1:])), reverse=True)
    groups = {g: sum(t for n, t in by_name.items()
                     if any(k in n for k in names))
              for g, names in KERNEL_NAMES.items()}
    work = {g: [w for k, w in calls if k == g] for g in KERNEL_NAMES}
    return result, dict(
        wall_s=wall, parse_s=parse_s, read_s=time.monotonic() - t1, busy_s=sum(e - s for s, e, _, _ in busy),
        launches=launches, group_device_s=groups,
        group_bound_s={g: sum(cost.bound_s(w) for w in ws)
                       for g, ws in work.items()},
        group_calls={g: len(ws) for g, ws in work.items()},
        group_ops={g: sum(w[0] for w in ws) for g, ws in work.items()},
        top_ops=[[n[:120], t] for n, t in by_name.most_common(TOP)],
        idle_gaps=[[label, t] for t, label in gaps[:TOP]])
