"""Staged prover engine (mirrors ``repro.runtime.engine``):

  stage 1  quantized forward replay (blocks.block_forward on the device),
           recording h_0..h_L and every layer's witness trace;
  stage 2  one batched PCS commit over all L+1 boundary activations of
           every query of the window, with weight commitments from a
           WeightCommitCache;
  stage 3  one proof job per selected layer of every query of the
           window, drained by a fleet of worker threads
           (runtime/scheduler.py).  With more than one thread a
           ``SumcheckRoundBatcher`` stacks the concurrent layer proofs'
           same-shape sum-check claims into multi-claim K3 calls.  The
           ``process`` backend hands each job to a spawned worker process
           instead: CUDA tensors cross as IPC handles, never as copies.

Proving is Fiat-Shamir deterministic, so the proofs do not depend on the
worker count, the backend or the batcher.

Lock order (ranked in repro_torch.analysis.locks): ``ProverEngine._pool_lock``
is rank 30 and ``WeightCommitCache._lock`` rank 40.  Both may be taken
under the service lock (rank 20); ``_pool_lock`` is held only while the
process pool is created or swapped out (never while it shuts down),
``WeightCommitCache._lock`` only for dictionary
bookkeeping (the weight setup runs outside it), and neither is held while
another lock is acquired.  ``SumcheckRoundBatcher._cv`` is rank 60: it is
taken on worker threads under no other lock, and a wave's K3 call runs
while it is held, which takes only rank-70 leaves (the kernel build and
counter locks).
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import hashlib
import os
import pickle
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from multiprocessing.reduction import ForkingPickler
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.multiprocessing

from repro_torch.core import blocks as B
from repro_torch.core import chain as CH
from repro_torch.core import field as F
from repro_torch.core import layer_proof as LP
from repro_torch.core import pcs as PCS
from repro_torch.core import sumcheck as SC
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.kernels import sumcheck_round as K3

from .scheduler import ProofScheduler, ScheduleStats


def _weights_digest(cfg: B.BlockCfg, w: Dict[str, np.ndarray],
                    params: PCS.PCSParams, device) -> bytes:
    h = hashlib.sha256()
    h.update(repr((cfg, params.blowup, params.queries, str(device))).encode())
    for k in sorted(w):
        a = np.ascontiguousarray(w[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.digest()


class WeightCommitCache:
    """WeightCommits keyed by content digest and by weight root; a root
    that is already cached reuses its range proof.  Thread-safe."""

    def __init__(self):
        self._by_digest: Dict[bytes, LP.WeightCommit] = {}
        self._by_root: Dict[tuple, LP.WeightCommit] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._by_root)

    def get_or_setup(self, cfg: B.BlockCfg, w: Dict[str, np.ndarray],
                     params: PCS.PCSParams, name: str = "wt",
                     device=None) -> LP.WeightCommit:
        dev = resolve_device(device)
        digest = _weights_digest(cfg, w, params, dev)
        with self._lock:
            cached = self._by_digest.get(digest)
            if cached is not None:
                self.hits += 1
                return cached
        wt = LP.commit_weights(cfg, w, params, name, dev)
        if wt.root is None:
            return wt
        root_key = (params.blowup, params.queries, str(dev), wt.root.tobytes())
        with self._lock:
            cached = self._by_root.get(root_key)
            if cached is not None:
                self.hits += 1
                self._by_digest[digest] = cached
                return cached
        wt.range_tape = LP.weight_range_proof(wt, params, name)
        with self._lock:
            self.misses += 1
            self._by_digest[digest] = wt
            self._by_root[root_key] = wt
        return wt


# ---------------------------------------------------------------------------
# Cross-layer sum-check round batching (thread backend, workers > 1).
#
# K3 carries one sponge row per claim, so K claims from *different* layer
# proofs (independent transcripts) can share one call.  Worker threads
# register for the duration of a job; sumcheck.prove routes their claims
# here, and whichever thread completes a wave (every registered thread has
# a claim pending, or the straggler timeout fires) stacks the same-shape
# claims and runs them through ONE K3.prove_rounds call, read back once.
# Each claim rides its own sponge row, so every transcript stays byte-
# identical to the direct path.
# ---------------------------------------------------------------------------
def _stack(rows: List[torch.Tensor], kp: int) -> torch.Tensor:
    """rows stacked on a new first axis and padded with zero rows to kp;
    a lone row is a view (a K = 1 wave copies nothing, as the direct
    path)."""
    if len(rows) == kp == 1:
        return rows[0].unsqueeze(0).contiguous()
    return torch.stack(rows + [torch.zeros_like(rows[0])] * (kp - len(rows)))


class SumcheckRoundBatcher:
    """Coalesces concurrent same-shape sum-check claims into multi-claim
    K3 calls.  Installed by ``ProverEngine._run_jobs`` (thread backend,
    more than one worker); threads that never registered bypass it.  A
    failed stacked call raises on every thread whose claim it carried."""

    def __init__(self, timeout: float = 0.05):
        self._cv = threading.Condition()
        self._registered: Set[int] = set()
        self._pending: Dict[int, Tuple[tuple, torch.Tensor]] = {}
        self._results: Dict[int, object] = {}
        self._timeout = timeout
        self.batched_claims = 0      # claims that shared a call with >= 1 peer
        self.launch_waves = 0        # K3 calls issued
        # (d, n, claims) -> K3 calls of that shape (K padded past claims)
        self.wave_shapes: collections.Counter = collections.Counter()
        # where the waiting goes: a flush runs every pending claim; its
        # gather time runs from the first claim's submission to the flush,
        # and the straggler guard's flushes are counted apart
        self.flushes = 0
        self.timeout_flushes = 0
        self.gather_seconds = 0.0
        self.timeout_gather_seconds = 0.0
        self.flush_seconds = 0.0         # the K3 calls and host reads
        self._gather_start = 0.0

    def register(self) -> None:
        with self._cv:
            self._registered.add(threading.get_ident())

    def deregister(self) -> None:
        with self._cv:
            self._registered.discard(threading.get_ident())
            # a departing thread may be the last hold-out of a wave
            self._cv.notify_all()

    def registered(self) -> bool:
        return threading.get_ident() in self._registered

    def _wave_complete(self) -> bool:
        return self._registered <= set(self._pending)

    def _flush(self, timed_out: bool) -> None:
        """Run every pending claim, grouped by (d, n) into stacked calls
        with K padded to a power of two by zero rows and zero states.
        Caller holds the lock."""
        t0 = time.monotonic()
        self.flushes += 1
        self.gather_seconds += t0 - self._gather_start
        if timed_out:
            self.timeout_flushes += 1
            self.timeout_gather_seconds += t0 - self._gather_start
        pending, self._pending = self._pending, {}
        groups: Dict[Tuple[int, int], List[int]] = {}
        for ident, (factors, _) in pending.items():
            groups.setdefault(
                (len(factors), factors[0].shape[0]), []).append(ident)
        for (d, n), idents in groups.items():
            K = len(idents)
            kp = 1 << max(K - 1, 0).bit_length()
            try:
                fs = [_stack([pending[i][0][t] for i in idents], kp)
                      for t in range(d)]
                sts = _stack([pending[i][1] for i in idents], kp)
                rp, pts, fins, sts_out = K3.prove_rounds(fs, sts)
                del fs
                m = rp.shape[1]
                host = F.to_np(torch.cat([rp[:K, :, 1:].reshape(-1),
                                          fins[:K].reshape(-1)]))
                rp_np = host[:K * m * d * 4].reshape(K, m, d, 4)
                fin_np = host[K * m * d * 4:].reshape(K, d, 4)
                for k, ident in enumerate(idents):
                    self._results[ident] = (rp_np[k].copy(), pts[k],
                                            fin_np[k].copy(), sts_out[k])
            except Exception as e:  # every claim of the wave raises
                err = RuntimeError(
                    f"round batcher: stacked K3 call (d={d}, n={n}, "
                    f"K={kp}) failed: {e!r}")
                err.__cause__ = e
                for ident in idents:
                    self._results[ident] = err
                continue
            self.launch_waves += 1
            self.wave_shapes[(d, n, K)] += 1
            if K > 1:
                self.batched_claims += K
        self.flush_seconds += time.monotonic() - t0
        self._cv.notify_all()

    def prove(self, factors: tuple, transcript) -> tuple:
        """Called from sumcheck.prove on a registered worker thread: submit
        the claim, wait for its wave, return (SumcheckProof, point) with
        the transcript advanced exactly as the direct path would."""
        me = threading.get_ident()
        with self._cv:
            if not self._pending:
                self._gather_start = time.monotonic()
            self._pending[me] = (factors, transcript.state)
            self._cv.notify_all()
            deadline = time.monotonic() + self._timeout
            while me not in self._results:
                if self._wave_complete():
                    self._flush(timed_out=False)
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:      # straggler guard: a partial wave
                    self._flush(timed_out=True)
                    continue
                self._cv.wait(remaining)
            res = self._results.pop(me)
        if isinstance(res, BaseException):
            raise res
        rp, pt, fin, st = res
        transcript.set_state(st)
        return SC.SumcheckProof(round_polys=rp, final_evals=fin), pt


# ---------------------------------------------------------------------------
# Process-backed proving.
#
# The prover is host-bound (the device idles most of an attest), and the
# GIL serialises a thread fleet's host work.  The "process" backend keeps
# the thread fleet for the scheduler's claim/requeue semantics but hands
# each layer proof to a spawned worker process.  The job is pickled with
# torch.multiprocessing's reductions: a CUDA tensor crosses as an IPC
# handle to the parent's memory (a CPU tensor through shared memory), so
# the weight commitment's matrix, codewords and Merkle levels are never
# copied.  The weight ints (setup's range proof reads them; prove_layer
# does not) and the setup's range tape stay behind, and the forward trace
# crosses as host arrays.  The parent holds every tensor of a job until
# the job's result is back; the child drops them before it returns.
# ---------------------------------------------------------------------------
def _process_prove_layer(payload):
    (cfg, layer_index, wt, b_in, b_out, trace, params, cir) = payload
    return LP.prove_layer(cfg, layer_index, wt, b_in, b_out, trace, params,
                          check_input_range=cir)


def _shippable(payload) -> tuple:
    """The job as it crosses to a worker process (see above)."""
    (cfg, layer_index, wt, b_in, b_out, trace, params, cir) = payload
    wt = dataclasses.replace(wt, ints=None, range_tape=[])
    trace = {k: LP._host(v) for k, v in trace.items()}
    return (cfg, layer_index, wt, b_in, b_out, trace, params, cir)


def _child_prove(device: str, blob: bytes):
    """Worker-process side of one job: unpickle (CUDA tensors open as IPC
    mappings of the parent's memory), prove, and return the host
    LayerProof with what the job cost this process: its pid, the pickled
    payload's bytes, its kernel launches, and on the card the device bytes
    it had allocated once the payload was in (IPC mappings do not count:
    nothing was copied) and its peak while proving."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    payload = pickle.loads(blob)
    info = dict(pid=os.getpid(), payload_bytes=len(blob))
    if dev.type == "cuda":
        info["allocated_after_payload"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts()
    lp = _process_prove_layer(payload)
    info["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    if dev.type == "cuda":
        info["max_allocated"] = torch.cuda.max_memory_allocated(dev)
        # a tensor the parent sent stays allocated there until every
        # mapping of it here is gone: wait for this job's kernels, then
        # drop the payload and whatever of it a reference cycle holds
        torch.cuda.synchronize(dev)
    del payload
    gc.collect()
    return lp, info


# ---------------------------------------------------------------------------
# Engine.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ForwardTrace:
    """Stage-1 output: boundary activations h_0..h_L + per-layer traces
    (int64 tensors on the engine's device)."""
    acts: List[torch.Tensor]
    traces: List[Dict[str, torch.Tensor]]


@dataclasses.dataclass
class EngineReport:
    forward_seconds: float
    commit_seconds: float
    prove_seconds: float
    total_seconds: float
    workers: int
    jobs: int
    claims: int
    losses: int
    cache_hits: int
    cache_misses: int
    batched_claims: int = 0   # claims that shared a K3 call (round batcher)
    launch_waves: int = 0     # K3 calls the round batcher made
    # the batcher's K3 calls by (d, n, claims)
    wave_shapes: Dict = dataclasses.field(default_factory=dict)
    # the batcher's flushes, and the seconds its claims waited for one
    # (see SumcheckRoundBatcher)
    flushes: int = 0
    timeout_flushes: int = 0
    gather_seconds: float = 0.0
    timeout_gather_seconds: float = 0.0
    flush_seconds: float = 0.0
    # process backend, one entry per job (see _child_prove)
    process_jobs: List[Dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BatchEngineReport(EngineReport):
    """EngineReport of a coalesced multi-query window (``prove_many``):
    ``commit_seconds`` is the ONE shared boundary-commit pass for all
    ``batch_size`` queries."""
    batch_size: int = 1


class ProverEngine:
    """Staged layerwise prover: forward replay -> batched commit ->
    per-layer proof jobs on a thread fleet, or on worker processes."""

    def __init__(self, cfgs: Sequence[B.BlockCfg],
                 weights_raw: Sequence[Dict[str, np.ndarray]],
                 params: PCS.PCSParams,
                 wt_commits: Optional[Sequence[LP.WeightCommit]] = None,
                 weight_cache: Optional[WeightCommitCache] = None,
                 workers: int = 1,
                 fail_claims: Optional[Set[int]] = None,
                 backend: str = "thread", device=None):
        assert len(cfgs) == len(weights_raw)
        if backend not in ("thread", "process"):
            raise ValueError(f"unknown backend {backend!r}")
        self.device = resolve_device(device)
        self.cfgs = list(cfgs)
        self.weights_raw = [{k: np.asarray(v) for k, v in w.items()}
                            for w in weights_raw]
        self.weights = [B.weights_from_numpy(cfg, w, self.device)
                        for cfg, w in zip(self.cfgs, self.weights_raw)]
        self.params = params
        self.workers = max(1, int(workers))
        self.fail_claims = fail_claims
        self.backend = backend
        self.weight_cache = (weight_cache if weight_cache is not None
                             else WeightCommitCache())
        self._wt_commits: Optional[List[LP.WeightCommit]] = (
            list(wt_commits) if wt_commits is not None else None)
        self._pool = None
        self._pool_lock = threading.Lock()

    # -- process-pool lifecycle (backend="process") ---------------------------
    def _ensure_pool(self) -> ProcessPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ProcessPoolExecutor(
                    max_workers=self.workers,
                    mp_context=torch.multiprocessing.get_context("spawn"))
            return self._pool

    def _drop_pool(self, pool: ProcessPoolExecutor) -> None:
        """Forget a pool that lost a worker: the next job spawns anew."""
        with self._pool_lock:
            if self._pool is pool:
                self._pool = None

    def close(self):
        """Shut the process pool down (nothing to do for threads): its
        workers finish their jobs and exit, having released what they were
        sent; then the device memory the parent freed while they held it
        goes back to the allocator."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
            if self.device.type == "cuda":
                torch.cuda.ipc_collect()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- stage 0: setup (amortized) -----------------------------------------
    @property
    def wt_commits(self) -> List[LP.WeightCommit]:
        if self._wt_commits is None:
            self._wt_commits = [
                self.weight_cache.get_or_setup(cfg, w, self.params,
                                               device=self.device)
                for cfg, w in zip(self.cfgs, self.weights_raw)]
        return self._wt_commits

    # -- stage 1: quantized forward replay ------------------------------------
    def run_forward(self, x0) -> ForwardTrace:
        h = torch.as_tensor(np.asarray(x0, dtype=np.int64), device=self.device)
        acts, traces = [h], []
        for cfg, w in zip(self.cfgs, self.weights):
            h, tr = B.block_forward(cfg, w, h)
            acts.append(h)
            traces.append(tr)
        return ForwardTrace(acts=acts, traces=traces)

    # -- stage 2: batched boundary commitment ---------------------------------
    def _boundary_cfgs(self) -> List[B.BlockCfg]:
        L = len(self.cfgs)
        return [self.cfgs[0]] + [self.cfgs[min(l + 1, L - 1)]
                                 for l in range(L)]

    def commit_boundaries(self, fwd: ForwardTrace) -> List[LP.BoundaryCommit]:
        return self.commit_boundaries_coalesced([fwd])[0]

    def commit_boundaries_coalesced(self, fwds: Sequence[ForwardTrace]
                                    ) -> List[List[LP.BoundaryCommit]]:
        """Stage 2 for MANY queries in one pass: every query's boundary
        activations ride ONE ``layer_proof.commit_boundaries`` call, so
        same-width boundaries across queries share one ``pcs.commit_batch``
        encode and Merkle pass.  ``commit_batch`` equals per-vector
        ``commit`` word for word, so a query's commitments do not depend
        on the window."""
        bnd_cfgs = self._boundary_cfgs()
        n = len(bnd_cfgs)
        all_cfgs: List[B.BlockCfg] = []
        all_acts: List[torch.Tensor] = []
        for fwd in fwds:
            all_cfgs += bnd_cfgs
            all_acts += fwd.acts
        flat = LP.commit_boundaries(all_cfgs, all_acts, self.params,
                                    device=self.device)
        return [flat[i * n:(i + 1) * n] for i in range(len(fwds))]

    # -- stage 3: layer proving ------------------------------------------------
    def _run_jobs(self, job_keys: Sequence, payload_fn
                  ) -> Tuple[Dict, ScheduleStats, Dict]:
        """Dispatch prove-layer jobs over the worker fleet.

        ``job_keys`` are hashable ids (a layer index, or a ``(query,
        layer)`` pair when a window's queries share the fleet);
        ``payload_fn(key)`` builds the ``_process_prove_layer`` payload.
        Returns the scheduler's ``(done, stats)`` and the fleet's telemetry
        (``batched_claims``, ``launch_waves``, ``wave_shapes``,
        ``process_jobs``)."""
        telemetry: Dict = dict(batched_claims=0, launch_waves=0,
                               wave_shapes={}, process_jobs=[])
        batcher = None
        if self.backend == "process":
            pool = self._ensure_pool()
            device = str(self.device)

            def prove_one(key) -> LP.LayerProof:
                # the claiming thread blocks on its worker process; the
                # payload (and every tensor in it) lives until it returns
                payload = _shippable(payload_fn(key))
                blob = bytes(ForkingPickler.dumps(payload))
                try:
                    lp, info = pool.submit(_child_prove, device, blob).result()
                except BrokenProcessPool:
                    # a worker died (killed, out of memory): this job and
                    # the window fail; the next window spawns a new pool
                    self._drop_pool(pool)
                    raise
                telemetry["process_jobs"].append(info)
                return lp
        else:
            batcher = SumcheckRoundBatcher() if self.workers > 1 else None

            def prove_one(key) -> LP.LayerProof:
                if batcher is None:
                    return _process_prove_layer(payload_fn(key))
                batcher.register()
                try:
                    return _process_prove_layer(payload_fn(key))
                finally:
                    batcher.deregister()

        sched = ProofScheduler(workers=self.workers,
                               fail_claims=self.fail_claims)
        if batcher is None:
            done, stats = sched.run(list(job_keys), prove_one)
            return done, stats, telemetry
        # additive install: concurrent proves (each with its own batcher)
        # coexist; a worker thread is routed to the batcher it registered
        # with
        SC.add_round_batcher(batcher)
        try:
            done, stats = sched.run(list(job_keys), prove_one)
        finally:
            SC.remove_round_batcher(batcher)
        telemetry.update(
            batched_claims=batcher.batched_claims,
            launch_waves=batcher.launch_waves,
            wave_shapes=dict(batcher.wave_shapes), flushes=batcher.flushes,
            timeout_flushes=batcher.timeout_flushes,
            gather_seconds=batcher.gather_seconds,
            timeout_gather_seconds=batcher.timeout_gather_seconds,
            flush_seconds=batcher.flush_seconds)
        return done, stats, telemetry

    # -- full pipeline ----------------------------------------------------------
    def prove(self, x0, layer_subset: Optional[Sequence[int]] = None
              ) -> Tuple[CH.ModelProof, EngineReport]:
        """One query: ``prove_many`` over a window of one."""
        proofs, report = self.prove_many(
            [x0], None if layer_subset is None else [layer_subset])
        return proofs[0], report

    def prove_many(self, x0s: Sequence, layer_subsets:
                   Optional[Sequence[Sequence[int]]] = None
                   ) -> Tuple[List[CH.ModelProof], BatchEngineReport]:
        """Prove a WINDOW of queries: one coalesced boundary-commit pass
        (``commit_boundaries_coalesced``) and every ``(query, layer)`` job
        in ONE scheduler run over the fleet.  Fiat-Shamir determinism and
        the word-for-word batched commit make each ``ModelProof`` the same
        whatever window its query rides in (``prove`` is a window of
        one)."""
        K = len(x0s)
        hits0 = self.weight_cache.hits
        misses0 = self.weight_cache.misses
        wt_commits = self.wt_commits          # setup (cached/amortized)
        self._sync()
        t = [time.monotonic()]
        fwds = [self.run_forward(x) for x in x0s]
        self._sync()
        t.append(time.monotonic())
        per_query_bounds = self.commit_boundaries_coalesced(fwds)
        self._sync()
        t.append(time.monotonic())
        if layer_subsets is None:
            layer_subsets = [list(range(len(self.cfgs)))] * K
        subsets = [list(s) for s in layer_subsets]
        assert len(subsets) == K

        def payload(key):
            qi, l = key
            return (self.cfgs[l], l, wt_commits[l],
                    per_query_bounds[qi][l], per_query_bounds[qi][l + 1],
                    fwds[qi].traces[l], self.params, l == 0)

        job_keys = [(qi, l) for qi, sub in enumerate(subsets) for l in sub]
        done, stats, telemetry = self._run_jobs(job_keys, payload)
        self._sync()
        t.append(time.monotonic())
        proofs = [
            CH.ModelProof(
                layer_proofs=[done[(qi, l)] for l in subsets[qi]],
                boundary_roots=[b.root for b in per_query_bounds[qi]],
                wt_roots=[w.root for w in wt_commits])
            for qi in range(K)]
        return proofs, BatchEngineReport(
            forward_seconds=t[1] - t[0], commit_seconds=t[2] - t[1],
            prove_seconds=t[3] - t[2], total_seconds=t[3] - t[0],
            workers=stats.workers, jobs=stats.jobs, claims=stats.claims,
            losses=stats.losses,
            cache_hits=self.weight_cache.hits - hits0,
            cache_misses=self.weight_cache.misses - misses0,
            batch_size=K, **telemetry)
