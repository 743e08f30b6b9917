"""Staged prover engine (mirrors ``repro.runtime.engine``, thread backend):

  stage 1  quantized forward replay (blocks.block_forward on the device),
           recording h_0..h_L and every layer's witness trace;
  stage 2  one batched PCS commit over all L+1 boundary activations, with
           weight commitments from a WeightCommitCache;
  stage 3  one ProofJob per selected layer, drained by a thread fleet
           (runtime/scheduler.py).

Proving is Fiat-Shamir deterministic, so the proofs do not depend on the
worker count.  The process backend, the cross-layer sum-check round
batcher and ``prove_many`` are not ported yet.

Lock order (ranked in repro_torch.analysis.locks): ``WeightCommitCache._lock``
is rank 40.  It may be taken under the service lock (rank 20) and is held
only for dictionary bookkeeping: no other lock is acquired while it is
held, and the weight setup itself runs outside it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import blocks as B
from repro_torch.core import chain as CH
from repro_torch.core import layer_proof as LP
from repro_torch.core import pcs as PCS
from repro_torch.device import resolve_device

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


@dataclasses.dataclass
class ProofJob:
    """One unit of stage-3 work: prove layer ``layer`` of the query."""
    layer: int
    check_input_range: bool


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


class ProverEngine:
    """Staged layerwise prover: forward replay -> batched commit ->
    per-layer proof jobs on a thread fleet."""

    def __init__(self, cfgs: Sequence[B.BlockCfg],
                 weights_raw: Sequence[Dict[str, np.ndarray]],
                 params: PCS.PCSParams,
                 wt_commits: Optional[Sequence[LP.WeightCommit]] = None,
                 weight_cache: Optional[WeightCommitCache] = None,
                 workers: int = 1,
                 fail_claims: Optional[Set[int]] = None,
                 backend: str = "thread", device=None):
        assert len(cfgs) == len(weights_raw)
        if backend != "thread":
            raise NotImplementedError(
                f"backend {backend!r}: only the thread backend is ported")
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

    def close(self):
        """Nothing to tear down for the thread backend."""

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
        return LP.commit_boundaries(self._boundary_cfgs(), fwd.acts,
                                    self.params, device=self.device)

    # -- stage 3: layer proving ------------------------------------------------
    def prove_layers(self, jobs: Sequence[ProofJob],
                     boundaries: List[LP.BoundaryCommit], fwd: ForwardTrace
                     ) -> Tuple[Dict[int, LP.LayerProof], ScheduleStats]:
        by_layer = {j.layer: j for j in jobs}

        def prove_one(l: int) -> LP.LayerProof:
            return LP.prove_layer(self.cfgs[l], l, self.wt_commits[l],
                                  boundaries[l], boundaries[l + 1],
                                  fwd.traces[l], self.params,
                                  check_input_range=by_layer[l].check_input_range)

        sched = ProofScheduler(workers=self.workers,
                               fail_claims=self.fail_claims)
        return sched.run([j.layer for j in jobs], prove_one)

    # -- full pipeline ----------------------------------------------------------
    def prove(self, x0, layer_subset: Optional[Sequence[int]] = None
              ) -> Tuple[CH.ModelProof, EngineReport]:
        hits0 = self.weight_cache.hits
        misses0 = self.weight_cache.misses
        wt_commits = self.wt_commits          # setup (cached/amortized)
        self._sync()
        t0 = time.monotonic()
        fwd = self.run_forward(x0)
        self._sync()
        t1 = time.monotonic()
        boundaries = self.commit_boundaries(fwd)
        self._sync()
        t2 = time.monotonic()
        subset = list(range(len(self.cfgs)) if layer_subset is None
                      else layer_subset)
        jobs = [ProofJob(layer=l, check_input_range=(l == 0))
                for l in subset]
        done, stats = self.prove_layers(jobs, boundaries, fwd)
        self._sync()
        t3 = time.monotonic()
        proof = CH.ModelProof(
            layer_proofs=[done[l] for l in subset],
            boundary_roots=[b.root for b in boundaries],
            wt_roots=[w.root for w in wt_commits])
        report = EngineReport(
            forward_seconds=t1 - t0, commit_seconds=t2 - t1,
            prove_seconds=t3 - t2, total_seconds=t3 - t0,
            workers=stats.workers, jobs=stats.jobs, claims=stats.claims,
            losses=stats.losses,
            cache_hits=self.weight_cache.hits - hits0,
            cache_misses=self.weight_cache.misses - misses0)
        return proof, report
