"""AttestationGateway: the serving tier in front of ``ProofService``
(mirrors ``repro.gateway.gateway``).

``ProofService`` is warm but serves one call at a time; this gateway
makes it a multi-client service:

* **async admission** — ``submit`` returns a waitable ``Ticket`` or
  raises :class:`AdmissionRejected` (bounded queue, per-client limits —
  see ``admission.py``);
* **cross-query coalescing** — a dispatcher thread pulls FIFO windows of
  admitted queries that share ``pcs_queries`` and proves each window with
  ``ProofService.attest_many``: ONE batched boundary-commit pass and one
  scheduler run over the resident fleet, whose threads' sum-checks meet
  in multi-claim K3 calls.  Every attestation equals its serial twin
  byte for byte;
* **metrics** — queue depth, admission/reject counts, coalesce batch
  sizes and per-stage latency histograms (``metrics.py``), exported as a
  JSON-able dict via ``metrics_snapshot()``;
* **graceful shutdown** — ``close()`` stops admitting (new submits get a
  reasoned ``shutting_down`` rejection) and drains every in-flight and
  queued proof before returning.

The socket transport over this object lives in ``transport.py``
(``gateway.serve()`` starts it); its wire protocol is the JAX package's,
``src/repro/gateway/PROTOCOL.md``.

Lock order (ranked in repro_torch.analysis.locks): ``AttestationGateway._lock``
is rank 10, the outermost lock of the stack — it may be held while
calling into the service/engine layers (ranks 20+) but must never be
acquired while any other lock of the port is held.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.api.service import ProofService
from repro_torch.api.types import VerifyPolicy

from .admission import (REJECT_SHUTDOWN, AdmissionQueue, AdmissionRejected,
                        ClientQuota, GatewayError, Ticket)
from .metrics import GatewayMetrics


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Admission / coalescing knobs."""
    max_queue_depth: int = 32      # bounded admission queue (backpressure)
    max_batch: int = 4             # coalescing window size cap
    window_seconds: float = 0.05   # how long a window waits for peers
    per_client_inflight: int = 4   # per-client policy limit
    max_pcs_queries: int = 64      # per-client cap on the prover-cost knob
    drain_timeout: float = 120.0   # close(): max wait for in-flight proofs


class AttestationGateway:
    """Admission + coalescing + metrics around one resident ProofService.

    Lifecycle: ``start()`` (or enter as a context manager) spawns the
    dispatcher; ``submit(...)`` from any number of threads; ``close()``
    drains and stops.  The wrapped service's engine fleet and
    WeightCommitCache stay resident across windows — the gateway adds
    concurrency, it never cold-starts the prover.
    """

    def __init__(self, service: ProofService,
                 config: Optional[GatewayConfig] = None,
                 quotas: Optional[Dict[str, ClientQuota]] = None):
        self.service = service
        self.config = config or GatewayConfig()
        self.metrics = GatewayMetrics()
        self.admission = AdmissionQueue(
            max_depth=self.config.max_queue_depth,
            quota=ClientQuota(
                max_inflight=self.config.per_client_inflight,
                max_pcs_queries=self.config.max_pcs_queries),
            quotas=quotas)
        self._dispatcher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._inflight_window = 0
        self._lock = threading.Lock()
        self._servers: List = []         # transports serving this gateway

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "AttestationGateway":
        if self._dispatcher is None:
            self._stop.clear()
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, name="gateway-dispatcher",
                daemon=True)
            self._dispatcher.start()
        return self

    def __enter__(self) -> "AttestationGateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def running(self) -> bool:
        return self._dispatcher is not None and self._dispatcher.is_alive()

    def close(self, drain: bool = True) -> None:
        """Stop admitting, drain queued + in-flight proofs, stop serving.

        With ``drain=False`` queued tickets are rejected (reasoned
        ``shutting_down`` error on their ``result()``) instead of proven.
        """
        self.admission.close()           # new submits now get REJ
        for srv in list(self._servers):  # stop accepting connections first
            srv.stop_accepting()
        if not drain:
            for t in self.admission.drain_reject():
                t.set_error(AdmissionRejected(
                    REJECT_SHUTDOWN, "gateway closed before this query "
                    "was proven"))
                self.admission.task_done(t)
        deadline = time.monotonic() + self.config.drain_timeout
        while time.monotonic() < deadline:
            with self._lock:
                busy = self._inflight_window
            if not busy and not len(self.admission):
                break
            time.sleep(0.01)
        self._stop.set()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=self.config.drain_timeout)
            self._dispatcher = None
        for srv in list(self._servers):  # then drain/close live connections
            srv.close()
        self._servers.clear()

    # -- client surface -----------------------------------------------------
    def submit(self, query: np.ndarray,
               policy: Optional[VerifyPolicy] = None,
               client_id: str = "anon",
               tokens: Optional[np.ndarray] = None) -> Ticket:
        """Admit one query.  Returns a waitable Ticket, or raises
        :class:`AdmissionRejected` with a stable reason code — explicit
        backpressure, never a silent drop."""
        if policy is None:
            policy = VerifyPolicy(pcs_queries=self.service.default_queries)
        ticket = Ticket(client_id=str(client_id), query=np.asarray(query),
                        policy=policy, tokens=tokens)
        try:
            self.admission.submit(ticket)
        except AdmissionRejected as rej:
            self.metrics.on_reject(rej.reason)
            raise
        self.metrics.on_admit(len(self.admission))
        return ticket

    def attest(self, query: np.ndarray,
               policy: Optional[VerifyPolicy] = None,
               client_id: str = "anon",
               tokens: Optional[np.ndarray] = None,
               timeout: Optional[float] = None):
        """Blocking convenience: submit + wait for the attestation."""
        return self.submit(query, policy, client_id, tokens).result(timeout)

    def metrics_snapshot(self) -> Dict:
        snap = self.metrics.snapshot()
        snap["queue_depth"] = len(self.admission)
        snap["queries_served"] = self.service.queries_served
        return snap

    def serve(self, host: str = "127.0.0.1", port: int = 0, **kw):
        """Start the socket transport for this gateway (see transport.py).

        Returns a started ``GatewayServer``; its address is
        ``server.address``.  The server is closed by ``gateway.close()``
        or directly via ``server.close()``.
        """
        from .transport import GatewayServer
        self.start()
        srv = GatewayServer(self, host=host, port=port, **kw).start()
        self._servers.append(srv)
        return srv

    # -- dispatcher ---------------------------------------------------------
    def _dispatch_loop(self) -> None:
        cfg = self.config
        while True:
            window = self.admission.take_window(cfg.max_batch,
                                                cfg.window_seconds)
            if not window:
                if self._stop.is_set() or (self.admission.closed
                                           and not len(self.admission)):
                    return
                continue
            with self._lock:
                self._inflight_window = len(window)
            try:
                self._prove_window(window)
            finally:
                with self._lock:
                    self._inflight_window = 0

    def _prove_window(self, window: List[Ticket]) -> None:
        now = time.monotonic()
        self.metrics.on_window(
            len(window),
            [now - t.admitted_at for t in window if t.admitted_at],
            len(self.admission))
        try:
            atts = self.service.attest_many(
                [t.query for t in window],
                [t.policy for t in window],
                [t.tokens for t in window])
        except BaseException as e:  # noqa: BLE001 — fail every waiter, not the loop
            self.metrics.on_batch_done(len(window), None, error=e)
            err = GatewayError(f"window proving failed: {e!r}")
            err.__cause__ = e
            for t in window:
                t.set_error(err)
                self.admission.task_done(t)
            return
        self.metrics.on_batch_done(len(window), self.service.last_report)
        for t, att in zip(window, atts):
            t.batch_size = len(window)
            t.set_result(att)
            self.admission.task_done(t)
