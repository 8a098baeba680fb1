"""Pub/sub control-plane transport with bulk-payload offload — the
MQTT+S3 role (a copy of
``fedml_tpu/core/distributed/communication/pubsub``; its frames and
messages are the JAX package's, so parties of both share one broker and
one store).

Parity target: the reference's default cross-silo/cross-device transport
(``mqtt_s3/mqtt_s3_multi_clients_comm_manager.py:20``): control messages
ride MQTT topics ``fedml_<runid>_<src>_<dst>``, model payloads are uploaded
to S3 and the message carries the key; the broker's last-will marks dead
clients. paho/MQTT brokers are unavailable in this environment, so the
broker here is a stdlib-TCP pub/sub daemon with the same semantics
(topic subscribe/publish, per-connection last-will) — protocol-shape
parity, not MQTT wire compatibility.

``PubSubStorageCommManager`` implements the control/data split: any
``Message`` whose payload exceeds ``offload_threshold`` bytes has its
``model_params`` field swapped for a ``model_params_url`` object-store key
(:mod:`...distributed_storage`), exactly the reference's S3 pattern.
"""

from __future__ import annotations

import hmac
import hashlib
import logging
import os
import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

import msgpack

from ..base_com_manager import BaseCommunicationManager
from ..message import Message
from ...distributed_storage import LocalObjectStorage

logger = logging.getLogger(__name__)


def broker_secret() -> Optional[bytes]:
    """Deployment-wide shared secret for broker authentication, from
    ``FEDML_TPU_BROKER_SECRET``. None = open broker (local-first default).
    The reference binds devices through its account manager
    (``scheduler_core/account_manager.py:1-469``); this is the local
    equivalent: no secret, no pub/sub."""
    s = os.environ.get("FEDML_TPU_BROKER_SECRET", "")
    return s.encode() if s else None


def _challenge_mac(secret: bytes, nonce: bytes) -> str:
    return hmac.new(secret, b"fedml-tpu/broker-auth" + nonce,
                    hashlib.sha256).hexdigest()


def client_connect(host: str, port: int,
                   secret: Optional[bytes] = None) -> socket.socket:
    """Connect to a PubSubBroker and complete its hello/challenge
    handshake. The broker always speaks first (a ``hello`` frame); when it
    demands auth the client must answer the nonce with an HMAC under the
    shared secret before any sub/pub/lwt is accepted."""
    sock = socket.create_connection((host, int(port)))
    hello = _recv_frame(sock)
    if not isinstance(hello, dict) or hello.get("kind") != "hello":
        sock.close()
        raise ConnectionError("broker did not send hello frame")
    if hello.get("auth_required"):
        if secret is None:
            secret = broker_secret()
        if secret is None:
            sock.close()
            raise PermissionError(
                "broker requires authentication; set "
                "FEDML_TPU_BROKER_SECRET or pass secret=")
        _send_frame(sock, {"kind": "auth", "mac": _challenge_mac(
            secret, bytes.fromhex(hello["nonce"]))})
        # the broker acks the handshake so a wrong secret surfaces HERE as
        # PermissionError, not later as an unexplained dead connection
        ack = _recv_frame(sock)
        if (not isinstance(ack, dict) or ack.get("kind") != "auth_result"
                or not ack.get("ok")):
            sock.close()
            raise PermissionError(
                "broker rejected authentication (wrong shared secret?)")
    return sock


def _send_frame(sock: socket.socket, obj) -> None:
    blob = msgpack.packb(obj, use_bin_type=True)
    sock.sendall(struct.pack(">I", len(blob)) + blob)


def _recv_frame(sock: socket.socket):
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    n, = struct.unpack(">I", hdr)
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 16))
        if not chunk:
            return None
        buf += chunk
    return msgpack.unpackb(buf, raw=False)


class PubSubBroker:
    """Topic broker: SUB/PUB/LWT frames over TCP. One per deployment (the
    MQTT broker analogue). With ``secret`` set (default: the
    ``FEDML_TPU_BROKER_SECRET`` env), every connection must answer a fresh
    HMAC challenge before any frame is honored — an unauthenticated peer
    that reaches the socket cannot publish ``start_train`` (or anything
    else)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 secret: Optional[bytes] = None):
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self.host = host
        self.secret = secret if secret is not None else broker_secret()
        self._subs: Dict[str, List[socket.socket]] = {}
        self._wills: Dict[socket.socket, Tuple[str, dict]] = {}
        self._lock = threading.Lock()
        # per-subscriber write locks: concurrent publishes from different
        # connection threads must not interleave frame bytes
        self._send_locks: Dict[socket.socket, threading.Lock] = {}
        self._running = True
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _handshake(self, conn: socket.socket) -> bool:
        """Broker speaks first: hello (+nonce). With a secret configured,
        the first client frame must be the HMAC answer."""
        nonce = os.urandom(16)
        _send_frame(conn, {"kind": "hello",
                           "auth_required": self.secret is not None,
                           "nonce": nonce.hex()})
        if self.secret is None:
            return True
        frame = _recv_frame(conn)
        ok = (isinstance(frame, dict) and frame.get("kind") == "auth"
              and hmac.compare_digest(
                  str(frame.get("mac", "")),
                  _challenge_mac(self.secret, nonce)))
        try:
            _send_frame(conn, {"kind": "auth_result", "ok": bool(ok)})
        except OSError:
            return False
        if not ok:
            logger.warning("broker: rejecting unauthenticated connection")
        return ok

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            try:
                if not self._handshake(conn):
                    conn.close()
                    return
            except OSError:
                return
            while True:
                frame = _recv_frame(conn)
                if frame is None:
                    break
                kind = frame.get("kind")
                if kind == "sub":
                    with self._lock:
                        self._subs.setdefault(frame["topic"], []).append(conn)
                        self._send_locks.setdefault(conn, threading.Lock())
                elif kind == "pub":
                    self._publish(frame["topic"], frame["payload"])
                elif kind == "lwt":
                    with self._lock:
                        self._wills[conn] = (frame["topic"],
                                             frame["payload"])
                elif kind == "disconnect":
                    # graceful goodbye clears the will (MQTT semantics:
                    # LWT fires only on abnormal disconnect)
                    with self._lock:
                        self._wills.pop(conn, None)
        finally:
            with self._lock:
                will = self._wills.pop(conn, None)
                for lst in self._subs.values():
                    if conn in lst:
                        lst.remove(conn)
                self._send_locks.pop(conn, None)
            if will is not None:  # last-will: notify liveness watchers
                self._publish(*will)

    def _publish(self, topic: str, payload) -> None:
        with self._lock:
            targets = [(t, self._send_locks.setdefault(t, threading.Lock()))
                       for t in self._subs.get(topic, [])]
        for t, slock in targets:
            try:
                with slock:
                    _send_frame(t, {"topic": topic, "payload": payload})
            except OSError:
                pass

    def stop(self) -> None:
        self._running = False
        try:
            self._srv.close()
        except OSError:
            pass


class PubSubStorageCommManager(BaseCommunicationManager):
    """MQTT+S3-analogue manager: control plane = broker topics
    ``fedml_<run>_<src>_<dst>``; data plane = object store."""

    OFFLOAD_KEYS = (Message.MSG_ARG_KEY_MODEL_PARAMS,)

    def __init__(self, rank: int, broker_host: str = "127.0.0.1",
                 broker_port: int = 0, run_id: str = "0",
                 storage: Optional[LocalObjectStorage] = None,
                 offload_threshold: int = 4096,
                 secret: Optional[bytes] = None):
        super().__init__()
        self.rank = int(rank)
        self.run_id = run_id
        self.storage = storage or LocalObjectStorage()
        self.offload_threshold = int(offload_threshold)
        self._sock = client_connect(broker_host, broker_port, secret)
        self._running = False
        self._lock = threading.Lock()
        # subscribe to every topic addressed to me: fedml_<run>_*_<me>
        _send_frame(self._sock, {"kind": "sub",
                                 "topic": self._topic("*", self.rank)})
        # last-will: liveness signal on the server's status topic (same
        # wire encoding as a normal publish so the receive path is uniform)
        will = Message("client_offline", self.rank, 0)
        _send_frame(self._sock, {"kind": "lwt",
                                 "topic": self._topic("*", 0),
                                 "payload": will.encode()})

    def _topic(self, src, dst) -> str:
        return f"fedml_{self.run_id}_{src}_{dst}"

    def send_message(self, msg: Message) -> None:
        from ..message import _pack_np
        params = dict(msg.msg_params)
        for key in self.OFFLOAD_KEYS:
            if key in params:
                blob = msgpack.packb(params[key], default=_pack_np,
                                     use_bin_type=True)
                if len(blob) >= self.offload_threshold:
                    # control/data split: payload -> object store, message
                    # carries the key (reference S3 write-on-send :274-304)
                    params.pop(key)
                    params[Message.MSG_ARG_KEY_MODEL_PARAMS_URL] = (
                        self.storage.put_object(blob))
        wire = Message()
        wire.msg_params = params
        from ....obs import trace as obs_trace
        # same send-span instrumentation as TCP/gRPC; the traceparent
        # param survives the control/data-plane split (it stays in the
        # control frame, never offloaded)
        with obs_trace.span(
                "comm.send",
                attrs={"transport": "pubsub",
                       "receiver": int(msg.get_receiver_id()),
                       "msg_type": str(msg.get_type())}):
            with self._lock:
                _send_frame(self._sock, {
                    "kind": "pub",
                    "topic": self._topic("*", msg.get_receiver_id()),
                    "payload": wire.encode()})

    def handle_receive_message(self) -> None:
        # blocking reads; stop_receive_message closes the socket which
        # unblocks recv — a read timeout could desync mid-frame instead
        self._running = True
        while self._running:
            try:
                frame = _recv_frame(self._sock)
            except OSError:
                break
            if frame is None:
                break
            msg = Message.decode(bytes(frame["payload"]))
            url = msg.get(Message.MSG_ARG_KEY_MODEL_PARAMS_URL)
            if url:  # data-plane fetch (reference read-on-receive :215-226)
                from ..message import _unpack_np
                blob = self.storage.get_object(url)
                msg.add_params(
                    Message.MSG_ARG_KEY_MODEL_PARAMS,
                    msgpack.unpackb(blob, ext_hook=_unpack_np, raw=False,
                                    strict_map_key=False))
            self.notify(msg)

    def stop_receive_message(self) -> None:
        self._running = False
        try:
            # graceful goodbye clears the last-will at the broker, then an
            # orderly FIN (a bare close() can RST mid-frame and race the
            # broker's reader thread at interpreter shutdown)
            with self._lock:
                _send_frame(self._sock, {"kind": "disconnect"})
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
