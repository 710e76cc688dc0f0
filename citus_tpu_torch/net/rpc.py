"""Coordinator RPC: length-prefixed JSON (+ binary) frames over TCP
(stdlib only), byte-compatible with the JAX package's
``citus_tpu/net/rpc.py``.

It carries the control plane — metadata sync, node management — AND
the cross-host bulk data plane (shard file transfer, remote ingest,
pushed worker tasks; the analog of the reference's COPY-protocol file
transmission, executor/transmit.c, over libpq).  A dependency-free
socket protocol keeps the system self-contained.

Protocol: every frame is ``<uint32 big-endian length><body>``.
Requests: {"id": n, "method": str, "payload": {...}} ->
responses {"id": n, "result": {...}} or {"id": n, "error": str}.
A request or response may carry ONE binary attachment: the JSON frame
sets "bin": <byte length> and the raw bytes follow as the next frame —
bulk data never round-trips through base64/JSON.
A client may upgrade a connection to a subscription with method
"subscribe"; the server then pushes {"event": ..., ...} frames to it.

Authentication (reference: utils/enable_ssl.c + pg_dist_authinfo): when
a shared secret is configured, every JSON frame carries
"hmac": HMAC-SHA256(secret, canonical-body), and the receiving side
rejects frames whose tag is absent or wrong — an unauthenticated peer
cannot register, fetch the catalog, or read shard bytes.  The secret is
distributed out-of-band (config/env), never over the wire.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import json
import socket
import struct
import threading
from typing import Callable, Optional


def _tag(secret: Optional[bytes], data: bytes) -> str:
    return _hmac.new(secret, data, hashlib.sha256).hexdigest()


def encode_message(obj: dict, secret: Optional[bytes] = None,
                   blob: Optional[bytes] = None) -> bytes:
    """Serialize one request/response (JSON frame + optional binary
    frame) to the full on-wire byte string.  Shared by the blocking
    client/server paths here and the non-blocking event loop
    (net/event_loop.py), so both speak the identical protocol."""
    if blob is not None:
        obj = dict(obj, bin=len(blob))
        if secret is not None:
            # the blob's content digest rides inside the authenticated
            # JSON frame, so substituting blob bytes (even same-length)
            # fails verification
            obj["bin_sha256"] = hashlib.sha256(blob).hexdigest()
    if secret is not None:
        body = json.dumps(obj, sort_keys=True).encode()
        obj = dict(obj, hmac=_tag(secret, body))
    data = json.dumps(obj).encode()
    out = struct.pack(">I", len(data)) + data
    if blob is not None:
        out += struct.pack(">I", len(blob)) + blob
    return out


def _send(sock: socket.socket, obj: dict,
          secret: Optional[bytes] = None,
          blob: Optional[bytes] = None) -> None:
    sock.sendall(encode_message(obj, secret, blob))


def _recv_raw(sock: socket.socket) -> Optional[bytes]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack(">I", hdr)
    body = b""
    while len(body) < n:
        chunk = sock.recv(min(1 << 20, n - len(body)))
        if not chunk:
            return None
        body += chunk
    return body


def _shut(sock: socket.socket) -> None:
    """Shut a socket down and close it: the shutdown wakes a thread
    blocked in accept() or recv() on it, which a close() alone does not
    on Linux."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class AuthError(RuntimeError):
    """Frame failed HMAC verification."""


def decode_json_frame(body: bytes, secret: Optional[bytes] = None) -> dict:
    """Parse + authenticate one JSON frame body (hmac popped/verified).
    Raises AuthError on a bad or missing tag.  The "bin"/"bin_sha256"
    keys are left in place — the caller decides how to read the blob
    frame (blocking here, incrementally in the event loop)."""
    msg = json.loads(body)
    if secret is not None:
        tag = msg.pop("hmac", None)
        canon = json.dumps(msg, sort_keys=True).encode()
        if tag is None or not _hmac.compare_digest(tag, _tag(secret, canon)):
            raise AuthError("frame failed authentication")
    return msg


def _recv(sock: socket.socket, secret: Optional[bytes] = None
          ) -> Optional[tuple[dict, Optional[bytes]]]:
    body = _recv_raw(sock)
    if body is None:
        return None
    msg = decode_json_frame(body, secret)
    blob = None
    nbin = msg.pop("bin", None)
    want_digest = msg.pop("bin_sha256", None)
    if nbin is not None:
        blob = _recv_raw(sock)
        if blob is None or len(blob) != nbin:
            return None
        if secret is not None:
            got = hashlib.sha256(blob).hexdigest()
            if want_digest is None or not _hmac.compare_digest(
                    got, want_digest):
                raise AuthError("binary frame failed authentication")
    return msg, blob


class RpcServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 secret: Optional[bytes] = None):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()
        self.secret = secret
        self.handlers: dict[str, Callable[[dict], dict]] = {}
        self._subscribers: list[socket.socket] = []
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self._stopping = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)

    def register(self, method: str, fn: Callable[[dict], dict]) -> None:
        self.handlers[method] = fn

    def start(self) -> "RpcServer":
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # lint: disable=THR02 -- per-connection handler exits when stop() closes its socket; nothing to join
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.append(conn)
        try:
            while True:
                try:
                    got = _recv(conn, self.secret)
                except AuthError:
                    # reject and drop the connection: an unauthenticated
                    # peer gets no second guess on the same socket
                    try:
                        _send(conn, {"error": "authentication failed"},
                              self.secret)
                    except OSError:
                        pass
                    break
                if got is None:
                    break
                msg, blob = got
                if msg.get("method") == "subscribe":
                    with self._lock:
                        self._subscribers.append(conn)
                    _send(conn, {"id": msg.get("id"), "result": {"ok": True}},
                          self.secret)
                    # connection now belongs to the push loop: it stays
                    # open until broadcast fails or the server stops
                    return
                fn = self.handlers.get(msg.get("method", ""))
                try:
                    if fn is None:
                        raise KeyError(f"unknown method {msg.get('method')!r}")
                    payload = msg.get("payload") or {}
                    if blob is not None:
                        result = fn(payload, blob)
                    else:
                        result = fn(payload)
                    out_blob = None
                    if isinstance(result, tuple):
                        result, out_blob = result
                    _send(conn, {"id": msg.get("id"), "result": result or {}},
                          self.secret, blob=out_blob)
                except Exception as e:  # report, keep serving
                    _send(conn, {"id": msg.get("id"), "error": str(e)},
                          self.secret)
        except OSError:
            pass
        with self._lock:
            if conn in self._subscribers:
                self._subscribers.remove(conn)
            if conn in self._conns:
                self._conns.remove(conn)
        try:
            conn.close()
        except OSError:
            pass

    def broadcast(self, event: dict) -> None:
        with self._lock:
            subs = list(self._subscribers)
        for s in subs:
            try:
                _send(s, event, self.secret)
            except OSError:
                with self._lock:
                    if s in self._subscribers:
                        self._subscribers.remove(s)

    def stop(self) -> None:
        """Stop serving: close the listener, every push channel, AND
        every in-flight request connection — a stopped server must look
        dead to clients, or failover paths never exercise."""
        self._stopping = True
        # shutdown before close: on Linux a close() does not wake a
        # thread blocked in accept()/recv() on the socket, shutdown does
        _shut(self._sock)
        with self._lock:
            for s in self._subscribers + self._conns:
                _shut(s)
            self._subscribers.clear()
            self._conns.clear()
        # closing the listen socket unblocks accept(); reap the loop
        if self._thread.is_alive():
            self._thread.join(timeout=1.0)


class RpcError(RuntimeError):
    pass


class RpcClient:
    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 secret: Optional[bytes] = None):
        self.addr = (host, port)
        self.secret = secret
        self._sock = socket.create_connection(self.addr, timeout=timeout)
        self._lock = threading.Lock()
        self._next_id = 0
        self._listener: Optional[threading.Thread] = None
        self._sub_sock: Optional[socket.socket] = None

    def call(self, method: str, payload: Optional[dict] = None,
             blob: Optional[bytes] = None) -> dict:
        r, _b = self.call_binary(method, payload, blob)
        return r

    def call_binary(self, method: str, payload: Optional[dict] = None,
                    blob: Optional[bytes] = None
                    ) -> tuple[dict, Optional[bytes]]:
        """Like call(), returning (result, binary attachment)."""
        try:
            with self._lock:
                self._next_id += 1
                rid = self._next_id
                # lint: disable=BLK01 -- the client lock SERIALIZES the wire protocol: one request/response
                _send(self._sock, {"id": rid, "method": method,
                                   "payload": payload or {}},
                      self.secret, blob=blob)
                # lint: disable=BLK01 -- in flight per socket is the design; async callers use RpcEventLoop instead
                got = _recv(self._sock, self.secret)
        except AuthError as e:
            raise RpcError(str(e)) from e
        except OSError as e:
            raise RpcError(f"coordinator connection failed: {e}") from e
        if got is None:
            raise RpcError("connection closed by coordinator")
        resp, rblob = got
        if resp.get("error"):
            raise RpcError(resp["error"])
        return resp.get("result") or {}, rblob

    def subscribe(self, callback: Callable[[dict], None],
                  on_close: Optional[Callable[[], None]] = None) -> None:
        """Open a push channel; ``callback`` runs on a daemon thread for
        every event the server broadcasts.  ``on_close`` fires when the
        channel dies (server gone), so the owner can fall back."""
        self._sub_sock = socket.create_connection(self.addr, timeout=10.0)
        _send(self._sub_sock, {"id": 0, "method": "subscribe"}, self.secret)
        ack = _recv(self._sub_sock, self.secret)  # {"result": {"ok": true}}
        if not (ack and ack[0].get("result", {}).get("ok")):
            raise RpcError("subscription refused")
        self._sub_sock.settimeout(None)

        def listen():
            try:
                while True:
                    try:
                        event = _recv(self._sub_sock, self.secret)
                    except (OSError, AuthError):
                        return
                    if event is None:
                        return
                    try:
                        callback(event[0])
                    # lint: disable=SWL01 -- a broken subscriber callback must not kill the listener thread
                    except Exception:
                        pass
            finally:
                if on_close is not None:
                    try:
                        on_close()
                    # lint: disable=SWL01 -- on_close is a user callback; the listener is already exiting
                    except Exception:
                        pass

        self._listener = threading.Thread(target=listen, daemon=True)
        self._listener.start()

    def close(self) -> None:
        for s in (self._sock, self._sub_sock):
            if s is not None:
                _shut(s)
        # closing _sub_sock makes the listener's recv fail; reap it —
        # unless close() is running ON the listener (an on_close
        # callback closing its own client must not self-join)
        _listener = getattr(self, "_listener", None)
        if _listener is not None and _listener.is_alive() \
                and _listener is not threading.current_thread():
            _listener.join(timeout=1.0)
