#!/usr/bin/env python3
"""The benchmark of ``repro_torch``: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card.  A cell is
a ``workloads`` entry of ``BENCHMARK.json``: a configuration
(``portbench/configs/<name>.json``) under a traffic mix
(``portbench/traffic/<name>.json``).

A run builds a ``repro_torch.api.ProofService`` over the configuration's
layers with weights drawn from the seed and publishes its ModelCard (the
weight commitments and their range proofs), with every kernel library
built and loaded first: that is set-up.  Then one client runs a closed
loop for ``--seconds``, one query at a time: attest (and encode the v2
wire bytes), then verify those bytes against the card as the client
does.  The window holds two cycles at least, and closes at the cycle's
end nearest to ``--seconds``: no further cycle starts once the time
left is under half the median cycle.  With
``--trace 1`` one more attestation and its verification run under
torch.profiler after the window.  Once the program is closed, the plain
reference checks every attestation the run made (``portbench/check.py``)
and the run prints one JSON line: ``correct``, ``attempted``, ``failed``,
the cell's end-to-end (``--trace 0``) or per-layer (``--trace 1``) metrics
read by ``portbench/metrics/<name>.py``, the device, and the numbers
compared with their limits.

Exits 2 without a result when no card is present, and 3 when the JAX
package or JAX is loaded in this process.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import resource
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

T_START = time.monotonic()
HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a finished run recorded; each metric's reader reads it."""
    cell: object
    block: Dict
    layers: int
    setup_s: float = 0.0
    setup_peak_bytes: int = 0
    window_peak_bytes: int = 0
    window_s: float = 0.0
    cycles: List[Dict] = dataclasses.field(default_factory=list)
    profile: Optional[Dict] = None

    @property
    def peak_bytes(self) -> int:
        return max(self.setup_peak_bytes, self.window_peak_bytes)

    def total(self, key: str) -> float:
        return sum(c[key] for c in self.cycles)

    def mean(self, key: str) -> float:
        return self.total(key) / len(self.cycles)

    def median(self, key: str) -> float:
        return statistics.median(c[key] for c in self.cycles)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    import torch
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _reset_peak(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


class GcClock:
    """Seconds the garbage collector ran, from ``gc.callbacks``."""

    def __init__(self):
        self.seconds = 0.0
        self._t0 = None

    def __call__(self, phase: str, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None


def _switches() -> int:
    """Involuntary context switches of this process so far."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw


def _served(att_bytes: bytes, query, ok: bool, device):
    """The client's view of one attestation, decoded from its wire bytes."""
    import numpy as np
    from repro_torch import api

    from portbench.check import Served
    att = api.Attestation.from_bytes(att_bytes, device)
    stores = []
    for layer in att.layer_stores() or []:
        for root, mp in layer:
            stores.append((np.asarray(root), np.asarray(mp.indices),
                           np.asarray(mp.leaves)))
    return Served(query=query,
                  boundary_roots=[np.asarray(r)
                                  for r in att.proof.boundary_roots],
                  stores=stores, verified=ok)


def note(what: str, **kw) -> None:
    """A progress line on standard error (phase times, trace costs)."""
    kw["t"] = time.monotonic() - T_START
    print("portbench: " + what + " " + json.dumps(kw), file=sys.stderr,
          flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> Dict:
    """One run of ``cell`` on ``device``; returns the result line."""
    import torch
    from repro_torch import api
    from repro_torch.core.blocks import BlockCfg
    from repro_torch.kernels import _build, launch_counts

    from portbench import check, cost, inputs
    from portbench import trace as TR

    tr = cell.traffic
    if tr["clients"] != 1 or tr["loop"] != "closed":
        raise ValueError(f"traffic {cell.entry['traffic']}: only one client "
                         "in a closed loop is implemented")
    b = inputs.block(cell.config, tr["seq"])
    layers = cell.config["block"]["layers"]
    run = Run(cell=cell, block=b, layers=layers)
    policy = api.VerifyPolicy(budget=tr["budget"],
                              pcs_queries=tr["pcs_queries"])
    wires: List = []            # (wire bytes, query, verified)
    gc_clock = GcClock()

    def cycle(svc, card, index: int) -> Dict:
        # besides the wall times: the process's CPU seconds, the garbage
        # collector's seconds and the involuntary context switches of
        # each half, which tell host stalls from slower work
        x = inputs.query(b, seed, index, tr["query_std"])
        g0, n0, c0 = gc_clock.seconds, _switches(), time.process_time()
        t0 = time.monotonic()
        att = svc.attest(x, policy)
        wire = att.to_bytes(2)
        t1 = time.monotonic()
        g1, n1, c1 = gc_clock.seconds, _switches(), time.process_time()
        k1 = launch_counts()["poseidon2"]
        rep = api.verify(wire, x, card, policy, device=device)
        t2 = time.monotonic()
        g2, n2, c2 = gc_clock.seconds, _switches(), time.process_time()
        r = svc.last_report
        wires.append((wire, x, bool(rep.ok)))
        return dict(attest_s=t1 - t0, verify_s=t2 - t1,
                    forward_s=r.forward_seconds, commit_s=r.commit_seconds,
                    prove_s=r.prove_seconds,
                    verify_k1=launch_counts()["poseidon2"] - k1,
                    attest_cpu_s=c1 - c0, verify_cpu_s=c2 - c1,
                    attest_gc_s=g1 - g0, verify_gc_s=g2 - g1,
                    attest_nivcsw=n1 - n0, verify_nivcsw=n2 - n1,
                    wire_bytes=len(wire), ok=bool(rep.ok), reason=rep.reason)

    note("start")
    t_setup = time.monotonic()
    if device.type == "cuda":
        _build.build_all()
        for name in _build.SOURCES:
            _build.load(name)
    wts = inputs.weights(b, layers, seed, device)
    cfg = BlockCfg(**{k: b[k] for k in ("family", "d", "dff", "heads",
                                         "kv_heads", "dh", "seq")})
    svc = api.ProofService([cfg] * layers, wts, pcs_blowup=tr["pcs_blowup"],
                           default_queries=tr["pcs_queries"],
                           workers=tr["workers"], backend=tr["backend"],
                           name=cell.name, device=device)
    gc.callbacks.append(gc_clock)
    try:
        card = svc.model_card.to_bytes()
        _sync(device)
        run.setup_s = time.monotonic() - t_setup
        note("set-up", setup_s=run.setup_s, peak_bytes=_peak(device))
        run.setup_peak_bytes = _peak(device)
        _reset_peak(device)
        t0 = time.monotonic()
        index = 0
        while len(run.cycles) < 2 or time.monotonic() - t0 + statistics.median(
                c["attest_s"] + c["verify_s"] for c in run.cycles) / 2 < seconds:
            run.cycles.append(cycle(svc, card, index))
            index += 1
        run.window_s = time.monotonic() - t0
        run.window_peak_bytes = _peak(device)
        note("window", window_s=run.window_s, cycles=[
            {k: c[k] for k in ("attest_s", "verify_s", "prove_s",
                               "attest_cpu_s", "verify_cpu_s", "attest_gc_s",
                               "verify_gc_s", "attest_nivcsw",
                               "verify_nivcsw", "wire_bytes", "ok")}
            for c in run.cycles], peak_bytes=run.window_peak_bytes)
        if trace:
            x = inputs.query(b, seed, index, tr["query_std"])
            shapes = TR.k2k4_shapes()
            att, pa = TR.profiled(lambda: svc.attest(x, policy).to_bytes(2))
            pa["group_ops"].update(TR.k2k4_ops(shapes))
            rep, pv = TR.profiled(lambda: api.verify(att, x, card, policy,
                                                     device=device))
            wires.append((att, x, bool(rep.ok)))
            run.profile = dict(attest=pa, verify=pv)
            note("trace", **{k: {f: p[f] for f in (
                "wall_s", "parse_s", "read_s", "busy_s", "launches",
                "group_calls", "group_device_s", "group_bound_s", "group_ops")}
                for k, p in run.profile.items()})
            note("work", model_ops=cost.attest_work(b, layers,
                                                    tr["pcs_blowup"])[0],
                 counted_ops=pa["group_ops"])
        card_roots = list(api.ModelCard.from_bytes(card).wt_roots)
        served = [_served(w, x, ok, device) for w, x, ok in wires]
        note("decoded")
    finally:
        svc.close()
        gc.callbacks.remove(gc_clock)
    del svc, wires
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    counts = check.compare(b, wts, card_roots, served, tr["pcs_blowup"],
                           device)
    note("reference", seconds=time.monotonic() - t0, **counts)
    return result(run, counts, trace, device)


def result(run: Run, counts: Dict, trace: bool, device) -> Dict:
    import torch

    from portbench import check
    metrics = {}
    for m in run.cell.metrics(trace):
        value = run.cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    failed = sum(not c["ok"] for c in run.cycles)
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=1, memory_peak_bytes=run.peak_bytes)
    out = dict(correct=check.correct(counts) and failed == 0,
               attempted=len(run.cycles), failed=failed, metrics=metrics,
               device=dev)
    if trace and run.profile is not None:
        pa, pv = run.profile["attest"], run.profile["verify"]
        dev.update(busy_s=pa["busy_s"] + pv["busy_s"],
                   window_s=pa["wall_s"] + pv["wall_s"])
        ops: Dict[str, float] = {}
        for name, t in pa["top_ops"] + pv["top_ops"]:
            ops[name] = ops.get(name, 0.0) + t
        out["breakdown"] = dict(
            device_ops=sorted(([n, t] for n, t in ops.items()),
                              key=lambda r: -r[1])[:10],
            idle_gaps=sorted(pa["idle_gaps"] + pv["idle_gaps"],
                             key=lambda r: -r[1])[:10])
    out["checks"] = {k: dict(value=counts[k], limit=lim)
                     for k, lim in check.LIMITS.items()}
    out["checks"]["attestations"] = dict(value=counts["attestations"],
                                         limit=">= 1")
    return out


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]
    from portbench import check, spec
    cell = spec.Cell(spec.load_bench(CHECKOUT), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: {cell.name} needs {cell.entry['chips']} CUDA "
              "device(s); none usable here", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    counts = {k: v["value"] for k, v in out["checks"].items()}
    print(json.dumps(out), flush=True)
    for line in check.lines(counts):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
