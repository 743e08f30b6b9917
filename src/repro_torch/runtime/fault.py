"""Fault tolerance + straggler mitigation runtime (DESIGN.md §5).

Three mechanisms, designed for 1000+ node fleets:

1. HeartbeatMonitor — per-host step timings; a host is a STRAGGLER when
   its step time exceeds median * threshold for `patience` consecutive
   steps, DEAD when no heartbeat arrives within `dead_after` seconds. The
   controller reacts by (a) excluding the host from the next allocation
   and (b) triggering an elastic restart from the latest checkpoint on
   the surviving topology (checkpoint.restore with new shardings).

2. resilient_step — wraps a train step; on transient device errors it
   reloads the last checkpoint and replays (bounded retries). The data
   pipeline is deterministic in (host, step), so replays are exact.

3. Proof-worker pool — layer proofs are stateless + independent (paper
   §3.3), so prover fault-tolerance is a simple redo: a lost worker's
   layer is re-queued. This is a systems BENEFIT of the paper's
   layerwise decomposition.

Lock order (the ranks of the JAX package's lock registry): ``ProofWorkReplayQueue._lock``
is a rank-70 leaf — queue bookkeeping only, no other lock is ever
acquired while it is held.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Set


@dataclasses.dataclass
class HostStatus:
    last_beat: float = 0.0
    slow_steps: int = 0
    timings: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=32))


class HeartbeatMonitor:
    def __init__(self, hosts: List[str], slow_factor: float = 2.0,
                 patience: int = 3, dead_after: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.hosts: Dict[str, HostStatus] = {h: HostStatus() for h in hosts}
        self.slow_factor = slow_factor
        self.patience = patience
        self.dead_after = dead_after
        self.clock = clock

    def beat(self, host: str, step_time: float):
        st = self.hosts[host]
        st.last_beat = self.clock()
        st.timings.append(step_time)

    def _median_step(self) -> float:
        all_t = sorted(t for st in self.hosts.values() for t in st.timings)
        return all_t[len(all_t) // 2] if all_t else 0.0

    def stragglers(self) -> Set[str]:
        med = self._median_step()
        out = set()
        if med <= 0:
            return out
        for h, st in self.hosts.items():
            recent = list(st.timings)[-self.patience:]
            if len(recent) == self.patience and \
                    all(t > self.slow_factor * med for t in recent):
                out.add(h)
        return out

    def dead(self) -> Set[str]:
        now = self.clock()
        return {h for h, st in self.hosts.items()
                if st.last_beat and now - st.last_beat > self.dead_after}

    def healthy_hosts(self) -> List[str]:
        bad = self.stragglers() | self.dead()
        return [h for h in self.hosts if h not in bad]


def resilient_step(step_fn: Callable, reload_fn: Callable,
                   max_retries: int = 2):
    """Run step_fn(); on failure reload state and retry (exact replay —
    the data pipeline is deterministic in (host, step))."""
    def wrapped(*args, **kwargs):
        err = None
        for attempt in range(max_retries + 1):
            try:
                return step_fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — device loss is generic
                err = e
                args, kwargs = reload_fn(attempt)
        raise RuntimeError(f"step failed after {max_retries} retries: {err}")
    return wrapped


class ProofWorkReplayQueue:
    """Work queue for layer proofs: lost workers' layers are re-queued.

    The paper's layerwise independence makes this trivially correct: a
    layer proof depends only on (weights commit, boundary commits, trace),
    all immutable for a given query.

    Thread-safe: runtime/engine.py drains this queue with a real worker
    fleet (one thread per prover worker), so claim/complete/worker_lost
    are serialized under a lock.  ``claims`` and ``losses`` count total
    claim events and injected/observed worker losses for reporting.
    """

    def __init__(self, layer_ids: List[int]):
        self.pending = deque(layer_ids)
        self.in_flight: Dict[str, int] = {}
        self.done: Dict[int, object] = {}
        self.claims = 0
        self.losses = 0
        self._lock = threading.Lock()

    def claim(self, worker: str) -> Optional[int]:
        got = self.claim_with_seq(worker)
        return None if got is None else got[0]

    def claim_with_seq(self, worker: str) -> Optional[tuple]:
        """Claim the next layer, returning (layer, claim_seq) where
        claim_seq is the global 0-based claim counter — the hook the
        scheduler's deterministic fault injection keys on."""
        with self._lock:
            if not self.pending:
                return None
            layer = self.pending.popleft()
            self.in_flight[worker] = layer
            seq = self.claims
            self.claims += 1
            return layer, seq

    def complete(self, worker: str, proof: object):
        with self._lock:
            layer = self.in_flight.pop(worker)
            self.done[layer] = proof

    def worker_lost(self, worker: str):
        with self._lock:
            if worker in self.in_flight:
                self.pending.appendleft(self.in_flight.pop(worker))
                self.losses += 1

    @property
    def finished(self) -> bool:
        with self._lock:
            return not self.pending and not self.in_flight
