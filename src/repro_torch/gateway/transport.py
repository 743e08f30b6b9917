"""Length-prefixed socket transport for the attestation gateway (mirrors
``repro.gateway.transport``; the wire protocol is the JAX package's,
``src/repro/gateway/PROTOCOL.md``).

One TCP connection carries a sequence of messages, each

    message := mtype(4) | body_len(u32 BE) | body

Request/response bodies are ``repro_torch.api.codec`` objects — the same
pickle-free tagged encoding the attestation wire uses, so a hostile body
is a clean ``CodecError``, never code execution.  Attestations stream as
raw v2 frame bytes in ``CHNK`` messages: the client feeds each chunk into
a ``StreamingVerifier`` the moment it arrives, verifying layer *k* while
layer *k+1* is still crossing the network.

Backpressure is on the wire: an admission rejection is a ``REJ.`` message
carrying the stable reason code (``queue_full`` / ``client_limit`` /
``shutting_down`` / ``bad_request``) and a human-readable detail.  The
server enforces read timeouts and a per-connection request-size cap; the
client enforces response timeouts and a buffered-unverified-bytes cap.

Lock order (ranked in repro_torch.analysis.locks): ``GatewayServer._lock``
(connection registry) is a rank-70 leaf — no other lock is ever
acquired while it is held.
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import api
from repro_torch.api import codec
from repro_torch.api.types import VerifyPolicy

from .admission import (REJECT_BAD_REQUEST, AdmissionRejected, GatewayError)

_U32 = struct.Struct(">I")
_HDR = 8                               # mtype(4) + body_len(4)

MSG_QUERY = b"QRY."                    # client -> server: attestation request
MSG_ACK = b"ACK."                      # server -> client: admitted
MSG_REJECT = b"REJ."                   # server -> client: NOT admitted + why
MSG_CHUNK = b"CHNK"                    # server -> client: raw wire bytes
MSG_DONE = b"DONE"                     # server -> client: attestation end
MSG_ERROR = b"ERR."                    # server -> client: proving failed

#: per-connection cap on one request body (queries are small: a packed
#: int64 activation matrix + policy; proofs are the big direction)
DEFAULT_MAX_REQUEST_BYTES = 8 << 20
DEFAULT_CHUNK_BYTES = 64 << 10


class TransportError(GatewayError):
    """Connection-level failure (closed, timed out, malformed message)."""


# ---------------------------------------------------------------------------
# Message plumbing (both directions share it).
# ---------------------------------------------------------------------------
def send_msg(sock: socket.socket, mtype: bytes, body: bytes = b"") -> None:
    assert len(mtype) == 4, mtype
    sock.sendall(mtype + _U32.pack(len(body)) + body)


def send_obj(sock: socket.socket, mtype: bytes, obj) -> None:
    send_msg(sock, mtype, codec.encode_obj(obj))


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on orderly EOF at a message boundary."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            if not buf:
                return None
            raise TransportError("connection closed mid-message")
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket, max_body: int
             ) -> Optional[Tuple[bytes, bytes]]:
    """Read one message; None on orderly EOF.  Oversized bodies raise
    TransportError BEFORE any allocation of the announced size."""
    hdr = _recv_exact(sock, _HDR)
    if hdr is None:
        return None
    mtype = hdr[:4]
    (blen,) = _U32.unpack(hdr[4:])
    if blen > max_body:
        raise TransportError(
            f"message body {blen} bytes exceeds the {max_body}-byte "
            "per-connection cap")
    body = _recv_exact(sock, blen) if blen else b""
    if blen and body is None:
        raise TransportError("connection closed mid-message")
    return mtype, body


# ---------------------------------------------------------------------------
# Server.
# ---------------------------------------------------------------------------
class GatewayServer:
    """Accept loop + per-connection handlers over an AttestationGateway.

    ``start()`` binds and spawns the accept thread; ``close()`` performs
    a graceful shutdown: stop accepting, let every live connection finish
    the response it is sending (in-flight proofs were already drained by
    ``gateway.close()``), then join all handler threads.
    """

    def __init__(self, gateway, host: str = "127.0.0.1", port: int = 0,
                 read_timeout: float = 30.0,
                 max_request_bytes: int = DEFAULT_MAX_REQUEST_BYTES,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 result_timeout: float = 600.0):
        self.gateway = gateway
        self.host = host
        self.port = port
        self.read_timeout = read_timeout
        self.max_request_bytes = int(max_request_bytes)
        self.chunk_bytes = int(chunk_bytes)
        self.result_timeout = result_timeout
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: List[socket.socket] = []
        self._handlers: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self.connections_served = 0

    # -- lifecycle ----------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        assert self._sock is not None, "server not started"
        return self._sock.getsockname()[:2]

    def start(self) -> "GatewayServer":
        if self._sock is not None:
            return self
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(16)
        s.settimeout(0.2)              # accept loop polls the stop flag
        self._sock = s
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="gateway-accept", daemon=True)
        self._accept_thread.start()
        return self

    def __enter__(self) -> "GatewayServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def stop_accepting(self) -> None:
        self._stopping.set()

    def close(self) -> None:
        """Graceful: no new connections, drain handlers, close sockets."""
        self._stopping.set()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None
        with self._lock:
            handlers = list(self._handlers)
        for t in handlers:
            t.join(timeout=self.result_timeout)
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
            self._handlers.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- accept + handle ----------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(self.read_timeout)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 name="gateway-conn", daemon=True)
            with self._lock:
                self._conns.append(conn)
                self._handlers.append(t)
                self.connections_served += 1
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            while not self._stopping.is_set():
                try:
                    msg = recv_msg(conn, self.max_request_bytes)
                except socket.timeout:
                    return             # idle client: read timeout closes it
                except TransportError as e:
                    self._try_send(conn, MSG_REJECT, {
                        "reason": REJECT_BAD_REQUEST, "detail": str(e)})
                    return
                if msg is None:
                    return             # client closed cleanly
                mtype, body = msg
                if mtype != MSG_QUERY:
                    self._try_send(conn, MSG_REJECT, {
                        "reason": REJECT_BAD_REQUEST,
                        "detail": f"unexpected message type {mtype!r}"})
                    return
                if not self._serve_query(conn, body):
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                me = threading.current_thread()
                if me in self._handlers:
                    self._handlers.remove(me)

    def _serve_query(self, conn: socket.socket, body: bytes) -> bool:
        """Handle one QRY body; returns False to drop the connection."""
        try:
            req = codec.decode_obj(body)
            query = np.asarray(req["query"])
            policy = req.get("policy")
            tokens = req.get("tokens")
            client_id = str(req.get("client_id", "anon"))
            if policy is not None and not isinstance(policy, VerifyPolicy):
                raise codec.CodecError("policy is not a VerifyPolicy")
        except (codec.CodecError, KeyError, TypeError, ValueError) as e:
            self._try_send(conn, MSG_REJECT, {
                "reason": REJECT_BAD_REQUEST,
                "detail": f"malformed request: {e}"})
            return False
        try:
            ticket = self.gateway.submit(query, policy=policy,
                                         client_id=client_id, tokens=tokens)
        except AdmissionRejected as rej:
            # explicit backpressure ON THE WIRE; connection stays open so
            # the client can back off and retry
            return self._try_send(conn, MSG_REJECT, {
                "reason": rej.reason, "detail": rej.detail})
        if not self._try_send(conn, MSG_ACK,
                              {"queue_depth": len(self.gateway.admission)}):
            return False
        try:
            att = ticket.result(timeout=self.result_timeout)
            wire = att.to_bytes(2)
        except BaseException as e:  # noqa: BLE001 — report, don't kill the conn
            return self._try_send(conn, MSG_ERROR, {"detail": str(e)})
        for off in range(0, len(wire), self.chunk_bytes):
            if not self._try_send_raw(conn, MSG_CHUNK,
                                      wire[off:off + self.chunk_bytes]):
                return False
        return self._try_send(conn, MSG_DONE, {
            "size_bytes": len(wire),
            "batch_size": ticket.batch_size,
            "prove_seconds": float(att.prove_seconds)})

    def _try_send(self, conn, mtype, obj) -> bool:
        return self._try_send_raw(conn, mtype, codec.encode_obj(obj))

    def _try_send_raw(self, conn, mtype, body: bytes) -> bool:
        try:
            send_msg(conn, mtype, body)
            return True
        except OSError:
            return False


# ---------------------------------------------------------------------------
# Client.
# ---------------------------------------------------------------------------
class GatewayClient:
    """Thin client for the gateway socket protocol.

    ``attest_bytes`` returns the raw attestation wire; ``attest_verify``
    feeds chunks into a :class:`api.StreamingVerifier` AS THEY ARRIVE and
    returns the final ``VerifyReport`` — the client never holds the whole
    attestation unless asked to.  Admission rejections surface as
    :class:`AdmissionRejected` with the server's reason code.  ``device``
    is where ``attest_verify`` runs the verifier's field work.
    """

    def __init__(self, host: str, port: int, client_id: str = "anon",
                 timeout: float = 600.0,
                 max_response_bytes: int = 1 << 30,
                 max_buffered_bytes: int = 256 << 20, device=None):
        self.client_id = client_id
        self.device = device
        self.timeout = timeout
        self.max_response_bytes = int(max_response_bytes)
        self.max_buffered_bytes = int(max_buffered_bytes)
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request ------------------------------------------------------------
    def _request(self, query: np.ndarray, policy: Optional[VerifyPolicy],
                 tokens: Optional[np.ndarray]) -> Dict:
        send_obj(self._sock, MSG_QUERY, {
            "query": np.asarray(query),
            "policy": policy,
            "tokens": None if tokens is None else np.asarray(tokens),
            "client_id": self.client_id,
        })
        mtype, body = self._recv()
        if mtype == MSG_REJECT:
            info = self._decode(body)
            raise AdmissionRejected(str(info.get("reason", "rejected")),
                                    str(info.get("detail", "")))
        if mtype != MSG_ACK:
            raise TransportError(f"expected ACK, got {mtype!r}")
        return self._decode(body)

    def _recv(self) -> Tuple[bytes, bytes]:
        msg = recv_msg(self._sock, self.max_response_bytes)
        if msg is None:
            raise TransportError("server closed the connection")
        return msg

    @staticmethod
    def _decode(body: bytes) -> Dict:
        obj = codec.decode_obj(body)
        if not isinstance(obj, dict):
            raise TransportError("malformed server message body")
        return obj

    def _stream_response(self, on_chunk) -> Dict:
        """Consume CHNK* + DONE, invoking ``on_chunk`` per chunk."""
        while True:
            mtype, body = self._recv()
            if mtype == MSG_CHUNK:
                on_chunk(body)
            elif mtype == MSG_DONE:
                return self._decode(body)
            elif mtype == MSG_ERROR:
                info = self._decode(body)
                raise GatewayError(
                    f"server-side proving failed: {info.get('detail', '')}")
            else:
                raise TransportError(
                    f"unexpected message type {mtype!r} in response stream")

    # -- public calls -------------------------------------------------------
    def attest_bytes(self, query: np.ndarray,
                     policy: Optional[VerifyPolicy] = None,
                     tokens: Optional[np.ndarray] = None
                     ) -> Tuple[bytes, Dict]:
        """Request an attestation; returns (wire_bytes, done_info)."""
        self._request(query, policy, tokens)
        parts: List[bytes] = []
        info = self._stream_response(parts.append)
        wire = b"".join(parts)
        if info.get("size_bytes") != len(wire):
            raise TransportError(
                "attestation size mismatch: announced "
                f"{info.get('size_bytes')}, received {len(wire)}")
        return wire, info

    def attest_verify(self, query: np.ndarray, model_card,
                      policy: Optional[VerifyPolicy] = None,
                      tokens: Optional[np.ndarray] = None
                      ) -> "api.VerifyReport":
        """Request + STREAM-verify an attestation in one round trip.

        Every ``CHNK`` is fed to a ``StreamingVerifier`` on arrival, so
        layer k is checked while layer k+1 is still in flight and the
        client's memory stays bounded (``max_buffered_bytes``).  Returns
        the final ``VerifyReport``; a mid-stream rejection stops reading
        early.
        """
        self._request(query, policy, tokens)
        sv = api.StreamingVerifier(
            np.asarray(query), model_card, policy=policy,
            max_buffered_bytes=self.max_buffered_bytes, device=self.device)
        rejected = []

        def on_chunk(b: bytes):
            if not rejected:
                for rep in sv.feed(b):
                    if not rep.ok:
                        rejected.append(rep)
        try:
            self._stream_response(on_chunk)
        except GatewayError:
            if rejected:           # verification verdict beats transport
                return rejected[0]
            raise
        if rejected:
            return rejected[0]
        return sv.finish()
