"""repro_torch.gateway — the serving tier in front of ``ProofService``
(mirrors ``repro.gateway``).

Provider side::

    service = api.ProofService(block_cfgs, weights)    # workers=2
    gw = AttestationGateway(service, GatewayConfig(max_batch=4))
    with gw:
        server = gw.serve(port=0)        # socket transport
        host, port = server.address
        ...

Client side::

    with GatewayClient(host, port, client_id="alice") as cli:
        report = cli.attest_verify(x0, card, policy)   # streamed verify

The wire protocol and its backpressure are the JAX package's:
``src/repro/gateway/PROTOCOL.md``.
"""
from .admission import (REJECT_BAD_REQUEST, REJECT_CLIENT_LIMIT,
                        REJECT_QUEUE_FULL, REJECT_SHUTDOWN, AdmissionQueue,
                        AdmissionRejected, ClientQuota, GatewayError, Ticket)
from .gateway import AttestationGateway, GatewayConfig
from .metrics import GatewayMetrics, Histogram
from .transport import GatewayClient, GatewayServer, TransportError

__all__ = [
    "AdmissionQueue", "AdmissionRejected", "AttestationGateway",
    "ClientQuota", "GatewayClient", "GatewayConfig", "GatewayError",
    "GatewayMetrics", "GatewayServer", "Histogram", "REJECT_BAD_REQUEST",
    "REJECT_CLIENT_LIMIT", "REJECT_QUEUE_FULL", "REJECT_SHUTDOWN", "Ticket",
    "TransportError",
]
