"""The port's attestation gateway (``repro_torch.gateway``) on the CPU,
mirroring ``tests/test_gateway.py`` at the golden toy's size: admission
limits and window formation (no proving), lifecycle and metrics, the
socket round trip with two concurrent clients (one stream-verifies), the
backpressure on the wire, and malformed requests.  The golden bytes are
the oracle: every attestation served must be golden_v2.bin."""
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from repro_torch import api
from repro_torch.core import blocks as B
from repro_torch.gateway import (REJECT_BAD_REQUEST, REJECT_CLIENT_LIMIT,
                                 REJECT_QUEUE_FULL, REJECT_SHUTDOWN,
                                 AdmissionQueue, AdmissionRejected,
                                 AttestationGateway, ClientQuota,
                                 GatewayClient, GatewayConfig, GatewayError,
                                 Ticket)
from repro_torch.gateway import transport as T

DATA = os.path.join(os.path.dirname(__file__), "data")
CFG = B.BlockCfg(family="gpt2", d=8, dff=16, heads=1, kv_heads=1, dh=8, seq=4)
POLICY = api.VerifyPolicy(pcs_queries=1)
TOKENS = np.arange(3, dtype=np.int32)


def _read(name):
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def golden():
    qrng = np.random.default_rng(5678)
    query = np.clip(np.round(qrng.normal(0, 0.5, (CFG.d_pad, CFG.seq)) * 256),
                    -32768, 32767).astype(np.int64)
    v2 = _read("golden_v2.bin")
    return dict(query=query, v2=v2, card=_read("golden_card.bin"),
                seconds=api.Attestation.from_bytes(v2, device="cpu")
                .prove_seconds)


@pytest.fixture(scope="module")
def service():
    weights = [B.init_weights(CFG, np.random.default_rng(1234))]
    with api.ProofService([CFG], weights, default_queries=1, workers=2,
                          name="golden-model", device="cpu") as svc:
        yield svc


def _golden_bytes(wire, golden):
    att = api.Attestation.from_bytes(wire, device="cpu")
    att.prove_seconds = golden["seconds"]
    att.__dict__.pop("_wire_cache", None)
    return att.to_bytes(2)


def _wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# Admission queue (no proving).
# ---------------------------------------------------------------------------
def _ticket(client="c", pcs=1):
    return Ticket(client_id=client, query=np.zeros((2, 2), np.int64),
                  policy=api.VerifyPolicy(pcs_queries=pcs))


def test_queue_full_is_reasoned():
    q = AdmissionQueue(max_depth=2, quota=ClientQuota(max_inflight=8))
    q.submit(_ticket("a"))
    q.submit(_ticket("b"))
    with pytest.raises(AdmissionRejected) as ei:
        q.submit(_ticket("c"))
    assert ei.value.reason == REJECT_QUEUE_FULL and "retry" in ei.value.detail
    assert str(AdmissionRejected("queue_full", "q at 2/2")) == \
        "[queue_full] q at 2/2"


def test_client_limits_and_overrides():
    q = AdmissionQueue(max_depth=16, quota=ClientQuota(max_inflight=2),
                       quotas={"vip": ClientQuota(max_inflight=3)})
    t1 = _ticket("a")
    q.submit(t1)
    q.submit(_ticket("a"))
    with pytest.raises(AdmissionRejected) as ei:
        q.submit(_ticket("a"))
    assert ei.value.reason == REJECT_CLIENT_LIMIT
    for _ in range(3):
        q.submit(_ticket("vip"))           # its own, larger quota
    q.task_done(t1)                        # the slot comes back
    q.submit(_ticket("a"))
    with pytest.raises(AdmissionRejected) as ei:
        AdmissionQueue(quota=ClientQuota(max_pcs_queries=8)).submit(
            _ticket(pcs=64))
    assert ei.value.reason == REJECT_BAD_REQUEST
    q.close()
    with pytest.raises(AdmissionRejected) as ei:
        q.submit(_ticket("b"))
    assert ei.value.reason == REJECT_SHUTDOWN


def test_take_window_coalesces_fifo_prefix():
    q = AdmissionQueue(max_depth=16, quota=ClientQuota(max_inflight=16))
    a, b, odd, c = (_ticket("a", 2), _ticket("a", 2), _ticket("a", 4),
                    _ticket("a", 2))
    for t in (a, b, odd, c):
        q.submit(t)
    assert q.take_window(max_batch=4, window_seconds=0.01) == [a, b]
    assert q.take_window(max_batch=4, window_seconds=0.01) == [odd]
    assert q.take_window(max_batch=4, window_seconds=0.01) == [c]
    ts = [_ticket() for _ in range(3)]
    for t in ts:
        q.submit(t)
    assert q.take_window(max_batch=2, window_seconds=0.01) == ts[:2]
    assert q.take_window(max_batch=2, window_seconds=0.01) == ts[2:]
    assert q.take_window(4, 0.01, poll_timeout=0.01) == []
    with pytest.raises(GatewayError):
        _ticket().result(timeout=0.01)


# ---------------------------------------------------------------------------
# Gateway lifecycle (no proving).
# ---------------------------------------------------------------------------
def test_lifecycle_and_metrics(service, golden):
    gw = AttestationGateway(service)       # dispatcher not started
    t1 = gw.submit(golden["query"], POLICY)
    with pytest.raises(AdmissionRejected):
        gw.submit(golden["query"], api.VerifyPolicy(pcs_queries=10**6))
    gw.close(drain=False)
    with pytest.raises(AdmissionRejected) as ei:
        t1.result(timeout=1)
    assert ei.value.reason == REJECT_SHUTDOWN
    with pytest.raises(AdmissionRejected) as ei:
        gw.submit(golden["query"], POLICY)
    assert ei.value.reason == REJECT_SHUTDOWN
    snap = gw.metrics_snapshot()
    json.dumps(snap)
    assert snap["admitted"] == 1
    assert snap["rejected"] == {REJECT_BAD_REQUEST: 1, REJECT_SHUTDOWN: 1}


# ---------------------------------------------------------------------------
# Proving through the gateway.
# ---------------------------------------------------------------------------
def test_socket_two_concurrent_clients(service, golden):
    """Two clients at once over the socket: one takes the raw wire, one
    stream-verifies as the chunks arrive.  Both queries ride one window
    (coalesced), and the wire is the golden attestation."""
    card = service.model_card
    cfg = GatewayConfig(max_batch=2, window_seconds=2.0)
    with AttestationGateway(service, cfg) as gw:
        srv = gw.serve(port=0)
        host, port = srv.address
        out, errors = {}, []
        gate = threading.Barrier(2)

        def client(i):
            try:
                with GatewayClient(host, port, client_id=f"sock-{i}",
                                   timeout=120, device="cpu") as cli:
                    gate.wait(timeout=30)
                    if i == 0:
                        out[i] = cli.attest_bytes(golden["query"], POLICY,
                                                  TOKENS)
                    else:
                        out[i] = cli.attest_verify(golden["query"], card,
                                                   POLICY, TOKENS)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        snap = gw.metrics_snapshot()
    wire, info = out[0]
    assert info["batch_size"] == 2 and info["size_bytes"] == len(wire)
    assert _golden_bytes(wire, golden) == golden["v2"]
    assert out[1].ok and out[1].complete, out[1].reason
    assert out[1].checked_layers == 1
    assert snap["completed"] == 2
    assert snap["coalesce"]["coalesced_queries"] == 2
    assert srv.connections_served == 2
    json.dumps(snap)


def test_backpressure_on_the_wire(service, golden):
    """A REJ message with the queue_full code while one proof is in flight
    and one is queued; the held requests are then served."""
    cfg = GatewayConfig(max_queue_depth=1, max_batch=1, window_seconds=0.02)
    with AttestationGateway(service, cfg) as gw:
        srv = gw.serve(port=0)
        host, port = srv.address
        with GatewayClient(host, port, client_id="g1", timeout=120) as c1, \
                GatewayClient(host, port, client_id="g2", timeout=120) as c2:
            c1._request(golden["query"], POLICY, TOKENS)   # -> proving
            _wait_for(lambda: len(gw.admission) == 0)
            c2._request(golden["query"], POLICY, TOKENS)   # queued: 1/1
            _wait_for(lambda: len(gw.admission) == 1)
            with GatewayClient(host, port, client_id="late") as c3:
                with pytest.raises(AdmissionRejected) as ei:
                    c3.attest_bytes(golden["query"], POLICY)
            assert ei.value.reason == REJECT_QUEUE_FULL
            for c in (c1, c2):
                parts = []
                c._stream_response(parts.append)
                assert _golden_bytes(b"".join(parts), golden) == golden["v2"]
    snap = gw.metrics_snapshot()
    assert snap["rejected"][REJECT_QUEUE_FULL] == 1
    assert snap["completed"] == 2


def test_socket_rejects_malformed_requests(service):
    with AttestationGateway(service) as gw:
        srv = gw.serve(port=0)
        host, port = srv.address
        for raw in (T.MSG_QUERY + (9).to_bytes(4, "big") + b"\x00garbage!",
                    b"WAT?" + (0).to_bytes(4, "big"),
                    # oversized body: rejected before it is read
                    T.MSG_QUERY + (1 << 30).to_bytes(4, "big")):
            with socket.create_connection((host, port), timeout=10) as s:
                s.sendall(raw)
                mtype, body = T.recv_msg(s, 1 << 20)
                assert mtype == T.MSG_REJECT
                assert T.codec.decode_obj(body)["reason"] == \
                    REJECT_BAD_REQUEST
    snap = gw.metrics_snapshot()
    assert snap["completed"] == 0 and snap["admitted"] == 0
