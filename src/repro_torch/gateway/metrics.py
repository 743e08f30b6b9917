"""Gateway metrics: counters + fixed-bucket histograms, exported as JSON
(mirrors ``repro.gateway.metrics``).

The serving tier's observability surface.  Everything here is plain
Python under one lock — the gateway's hot path is dominated by proving
(seconds per query), so metric overhead is irrelevant; what matters is
that ``snapshot()`` is always JSON-serializable and cheap enough to call
from a live admin endpoint or fold into ``BENCH_engine.json``.

Lock order (ranked in repro_torch.analysis.locks): ``GatewayMetrics._lock``
is a rank-70 leaf — no other lock is ever acquired while it is held.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence


class Histogram:
    """Fixed-boundary histogram (cumulative ``le`` buckets + count/sum/max).

    Boundaries are chosen per metric at construction; values above the
    last boundary land in the implicit ``+inf`` bucket.
    """

    def __init__(self, bounds: Sequence[float]):
        self.bounds = [float(b) for b in bounds]
        assert self.bounds == sorted(self.bounds), "bounds must ascend"
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        while i < len(self.bounds) and v > self.bounds[i]:
            i += 1
        self.buckets[i] += 1
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v

    def to_dict(self) -> Dict:
        labels = [str(b) for b in self.bounds] + ["+inf"]
        return {"count": self.count, "sum": self.sum, "max": self.max,
                "mean": (self.sum / self.count) if self.count else 0.0,
                "buckets": dict(zip(labels, self.buckets))}


#: seconds-scale latency buckets (forward/commit/prove take from
#: hundredths of a second to minutes, by width)
LATENCY_BOUNDS = (0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0)
#: coalesce batch sizes are small integers bounded by GatewayConfig.max_batch
BATCH_BOUNDS = (1, 2, 3, 4, 6, 8, 12, 16, 32)


class GatewayMetrics:
    """All gateway counters/histograms behind one lock.

    ``snapshot()`` returns a plain JSON-able dict: admission counts
    (admitted / rejected-by-reason — backpressure must be *observable*),
    live queue depth, coalesce batch-size distribution, and per-stage
    latency histograms for the proving pipeline.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.admitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected: Dict[str, int] = {}
        self.queue_depth = 0                     # gauge, set by the gateway
        self.queue_depth_peak = 0
        self.coalesce_batch_size = Histogram(BATCH_BOUNDS)
        self.coalesced_queries = 0               # queries sharing a window
        self.solo_queries = 0                    # windows of size 1
        self.admission_wait_seconds = Histogram(LATENCY_BOUNDS)
        self.stage_seconds = {
            stage: Histogram(LATENCY_BOUNDS)
            for stage in ("forward", "commit", "prove", "total")}

    # -- recording ----------------------------------------------------------
    def on_admit(self, depth: int) -> None:
        with self._lock:
            self.admitted += 1
            self.queue_depth = depth
            if depth > self.queue_depth_peak:
                self.queue_depth_peak = depth

    def on_reject(self, reason: str) -> None:
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1

    def on_window(self, batch_size: int, waits: Sequence[float],
                  depth: int) -> None:
        with self._lock:
            self.queue_depth = depth
            self.coalesce_batch_size.observe(batch_size)
            if batch_size > 1:
                self.coalesced_queries += batch_size
            else:
                self.solo_queries += 1
            for w in waits:
                self.admission_wait_seconds.observe(w)

    def on_batch_done(self, batch_size: int, report,
                      error: Optional[BaseException] = None) -> None:
        with self._lock:
            if error is not None:
                self.failed += batch_size
                return
            self.completed += batch_size
            if report is not None:
                self.stage_seconds["forward"].observe(report.forward_seconds)
                self.stage_seconds["commit"].observe(report.commit_seconds)
                self.stage_seconds["prove"].observe(report.prove_seconds)
                self.stage_seconds["total"].observe(report.total_seconds)

    # -- export -------------------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "admitted": self.admitted,
                "completed": self.completed,
                "failed": self.failed,
                "rejected": dict(self.rejected),
                "rejected_total": sum(self.rejected.values()),
                "queue_depth": self.queue_depth,
                "queue_depth_peak": self.queue_depth_peak,
                "coalesce": {
                    "batch_size": self.coalesce_batch_size.to_dict(),
                    "coalesced_queries": self.coalesced_queries,
                    "solo_queries": self.solo_queries,
                },
                "admission_wait_seconds":
                    self.admission_wait_seconds.to_dict(),
                "stage_seconds": {k: h.to_dict()
                                  for k, h in self.stage_seconds.items()},
            }


def merge_batch_sizes(snapshot: Dict) -> List[List[int]]:
    """Flatten a snapshot's coalesce histogram into [size, count] pairs,
    empty buckets left out (for benchmark reporting)."""
    buckets = snapshot["coalesce"]["batch_size"]["buckets"]
    return [[k, v] for k, v in buckets.items() if v]
