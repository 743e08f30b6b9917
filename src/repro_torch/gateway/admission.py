"""Async admission: bounded queue, per-client limits, reasoned rejection
(mirrors ``repro.gateway.admission``).

The serving tier's front door.  A query is either *admitted* — it gets a
``Ticket`` whose result materializes when the prover fleet reaches it —
or *rejected right now* with a machine-readable reason (queue full,
client over its in-flight limit, gateway shutting down, malformed
request).  There is no silent drop and no unbounded buffering: the queue
depth and the per-client in-flight count are both hard caps, and hitting
either is explicit backpressure the client can see on the wire
(``transport.py`` maps ``AdmissionRejected`` to a REJ message).

Coalescing windows are formed here too: ``take_window`` pops a FIFO run
of queued tickets that share ``pcs_queries`` (the PCS-parameter knob that
fixes the commitment shape), waiting up to the window duration for
late-arriving peers so concurrent queries can share one batched
boundary-commit pass.

Lock order (ranked in repro_torch.analysis.locks): ``AdmissionQueue._cv`` is
a rank-70 leaf — no other lock in the stack is ever acquired while it
is held.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.api.types import VerifyPolicy

# -- rejection reasons (stable codes: these cross the wire) -----------------
REJECT_QUEUE_FULL = "queue_full"
REJECT_CLIENT_LIMIT = "client_limit"
REJECT_SHUTDOWN = "shutting_down"
REJECT_BAD_REQUEST = "bad_request"


class GatewayError(Exception):
    """Base class for gateway-side failures."""


class AdmissionRejected(GatewayError):
    """Explicit backpressure: the query was NOT admitted, and here is why."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason
        self.detail = detail

    def __str__(self) -> str:
        return f"[{self.reason}] {self.detail}" if self.detail \
            else f"[{self.reason}]"


class Ticket:
    """One admitted query: a waitable slot for its Attestation.

    ``result()`` blocks until the dispatcher proves the query (or fails),
    mirroring concurrent.futures without pulling in an executor the
    dispatcher does not use.
    """

    def __init__(self, client_id: str, query: np.ndarray,
                 policy: VerifyPolicy, tokens: Optional[np.ndarray] = None):
        self.client_id = client_id
        self.query = query
        self.policy = policy
        self.tokens = tokens
        self.submitted_at = time.monotonic()
        self.admitted_at: Optional[float] = None
        self.batch_size: int = 0       # size of the coalescing window served
        self._ev = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def set_result(self, attestation) -> None:
        self._result = attestation
        self._ev.set()

    def set_error(self, err: BaseException) -> None:
        self._error = err
        self._ev.set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise GatewayError(
                f"attestation not ready within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass(frozen=True)
class ClientQuota:
    """Per-client policy limits enforced at admission."""
    max_inflight: int = 4          # admitted-but-unfinished queries
    max_pcs_queries: int = 64      # cap on the prover-cost policy knob


class AdmissionQueue:
    """Bounded FIFO of admitted tickets with per-client accounting.

    Thread-safe.  ``submit`` either enqueues and returns the ticket or
    raises :class:`AdmissionRejected`; ``take_window`` is the dispatcher
    side (blocking, coalescing); ``task_done`` releases the per-client
    in-flight slot once the ticket's result is set.
    """

    def __init__(self, max_depth: int = 32,
                 quota: Optional[ClientQuota] = None,
                 quotas: Optional[Dict[str, ClientQuota]] = None):
        assert max_depth >= 1
        self.max_depth = max_depth
        self.default_quota = quota or ClientQuota()
        self.quotas = dict(quotas or {})        # per-client overrides
        self._q: Deque[Ticket] = deque()
        self._inflight: Dict[str, int] = {}
        self._cv = threading.Condition()
        self.closed = False

    def __len__(self) -> int:
        with self._cv:
            return len(self._q)

    def quota_for(self, client_id: str) -> ClientQuota:
        return self.quotas.get(client_id, self.default_quota)

    # -- client side --------------------------------------------------------
    def submit(self, ticket: Ticket) -> Ticket:
        quota = self.quota_for(ticket.client_id)
        if not isinstance(ticket.policy, VerifyPolicy):
            raise AdmissionRejected(REJECT_BAD_REQUEST,
                                    "request carries no VerifyPolicy")
        if ticket.policy.pcs_queries > quota.max_pcs_queries:
            raise AdmissionRejected(
                REJECT_BAD_REQUEST,
                f"pcs_queries={ticket.policy.pcs_queries} exceeds the "
                f"client cap {quota.max_pcs_queries}")
        with self._cv:
            if self.closed:
                raise AdmissionRejected(
                    REJECT_SHUTDOWN, "gateway is draining; not admitting "
                    "new queries")
            if len(self._q) >= self.max_depth:
                raise AdmissionRejected(
                    REJECT_QUEUE_FULL,
                    f"admission queue at capacity ({len(self._q)}/"
                    f"{self.max_depth}); retry with backoff")
            inflight = self._inflight.get(ticket.client_id, 0)
            if inflight >= quota.max_inflight:
                raise AdmissionRejected(
                    REJECT_CLIENT_LIMIT,
                    f"client {ticket.client_id!r} already has {inflight} "
                    f"in-flight queries (limit {quota.max_inflight})")
            ticket.admitted_at = time.monotonic()
            self._inflight[ticket.client_id] = inflight + 1
            self._q.append(ticket)
            self._cv.notify_all()
        return ticket

    def task_done(self, ticket: Ticket) -> None:
        with self._cv:
            n = self._inflight.get(ticket.client_id, 0)
            if n <= 1:
                self._inflight.pop(ticket.client_id, None)
            else:
                self._inflight[ticket.client_id] = n - 1
            self._cv.notify_all()

    # -- dispatcher side ----------------------------------------------------
    def take_window(self, max_batch: int, window_seconds: float,
                    poll_timeout: float = 0.2) -> List[Ticket]:
        """Pop the next coalescing window (blocking).

        Waits for the first ticket (up to ``poll_timeout``; returns [] so
        a draining dispatcher can re-check its stop flag), then keeps the
        window open ``window_seconds`` for late arrivals.  The window is
        the FIFO prefix of tickets sharing the head's ``pcs_queries`` —
        queries with a different PCS shape stay queued for the next
        window, preserving arrival order per shape.
        """
        deadline = None
        with self._cv:
            while not self._q:
                if self.closed:
                    return []
                if deadline is None:
                    deadline = time.monotonic() + poll_timeout
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cv.wait(remaining)
            head_q = self._q[0].policy.pcs_queries
            window_end = time.monotonic() + window_seconds
            while not self.closed:
                compatible = 0       # FIFO prefix sharing the head's shape
                for t in self._q:
                    if t.policy.pcs_queries != head_q:
                        break
                    compatible += 1
                if compatible >= max_batch:
                    break
                remaining = window_end - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            out: List[Ticket] = []
            keep: List[Ticket] = []
            while self._q and len(out) < max_batch:
                t = self._q.popleft()
                if t.policy.pcs_queries == head_q:
                    out.append(t)
                else:           # different PCS shape: next window's problem
                    keep.append(t)
                    break       # stop at the first mismatch (strict FIFO)
            for t in reversed(keep):
                self._q.appendleft(t)
            return out

    # -- shutdown -----------------------------------------------------------
    def close(self) -> None:
        """Stop admitting; queued tickets still drain via take_window."""
        with self._cv:
            self.closed = True
            self._cv.notify_all()

    def drain_reject(self) -> List[Ticket]:
        """Hard shutdown: pop every queued ticket (caller rejects them)."""
        with self._cv:
            out = list(self._q)
            self._q.clear()
            self._cv.notify_all()
            return out
