"""Proof-worker fleet: threads draining a ProofWorkReplayQueue.

Layer proofs are independent given the boundary commitments (paper §3.3),
so stage 3 of the ProverEngine (runtime/engine.py) is embarrassingly
parallel: each ProofJob is claimed from the replay queue by one of
``workers`` threads, proven, and completed.  A worker that dies mid-proof
simply loses its claim — ``ProofWorkReplayQueue.worker_lost`` requeues the
layer and another worker (or the same one after restart) re-proves it.
Proving is deterministic (Fiat-Shamir transcripts), so a redo yields the
identical proof.

Fault injection: ``fail_claims`` is a set of global claim sequence numbers
(0-based, in queue claim order) that are dropped as if the claiming worker
crashed after claiming but before completing.  Tests use this to exercise
the requeue-on-loss path deterministically.

Lock order (the ranks of the JAX package's lock registry): the local ``lock`` in
``run()`` (errors/busy bookkeeping) is rank 50 — it may be taken while
engine locks (ranks <= 40) are held and may itself be held while the
batcher (rank 60) or leaf (rank 70) locks are acquired.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set

from .fault import ProofWorkReplayQueue


@dataclasses.dataclass
class ScheduleStats:
    workers: int
    jobs: int
    claims: int          # total claim events (jobs + redos)
    losses: int          # claims lost to (injected) worker deaths
    wall_seconds: float
    worker_seconds: Dict[str, float]  # busy time per worker


class ProofScheduler:
    """Dispatch ProofJobs over a thread fleet with replay-on-loss.

    ``run(layer_ids, prove_fn)`` returns ``(done, stats)`` where ``done``
    maps layer id -> prove_fn(layer id).  With ``workers == 1`` this
    degenerates to the sequential loop (same claim order, same results),
    which is what makes parallel-vs-sequential transcript equivalence
    testable.
    """

    def __init__(self, workers: int = 1,
                 fail_claims: Optional[Set[int]] = None,
                 max_losses: int = 64):
        assert workers >= 1
        self.workers = workers
        self.fail_claims = set(fail_claims or ())
        self.max_losses = max_losses

    def run(self, layer_ids: Sequence[int],
            prove_fn: Callable[[int], object]
            ) -> tuple[Dict[int, object], ScheduleStats]:
        queue = ProofWorkReplayQueue(list(layer_ids))
        errors: List[BaseException] = []
        busy: Dict[str, float] = {}
        lock = threading.Lock()

        def worker_loop(wid: str):
            t_busy = 0.0
            while True:
                with lock:
                    if errors or queue.losses > self.max_losses:
                        break
                got = queue.claim_with_seq(wid)
                if got is None:
                    if queue.finished:
                        break
                    # a peer may still crash and requeue its layer
                    time.sleep(0.001)
                    continue
                layer, seq = got
                if seq in self.fail_claims:
                    queue.worker_lost(wid)
                    continue
                t0 = time.monotonic()
                try:
                    proof = prove_fn(layer)
                except BaseException as e:  # noqa: BLE001 — surface to caller
                    with lock:
                        errors.append(e)
                    queue.worker_lost(wid)
                    break
                t_busy += time.monotonic() - t0
                queue.complete(wid, proof)
            with lock:
                busy[wid] = t_busy

        t0 = time.monotonic()
        if self.workers == 1:
            worker_loop("w0")
        else:
            threads = [threading.Thread(target=worker_loop, args=(f"w{i}",),
                                        name=f"proof-worker-{i}")
                       for i in range(self.workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        wall = time.monotonic() - t0
        if errors:
            raise errors[0]
        assert queue.finished, "scheduler exited with unproven layers"
        stats = ScheduleStats(workers=self.workers, jobs=len(layer_ids),
                              claims=queue.claims, losses=queue.losses,
                              wall_seconds=wall, worker_seconds=busy)
        return queue.done, stats
