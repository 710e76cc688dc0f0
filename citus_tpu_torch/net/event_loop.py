"""Single-event-loop RPC dispatcher: one selector-driven thread owns
every in-flight data-plane RPC for this coordinator.

Reference: Citus's adaptive executor multiplexes hundreds of worker
connections on ONE process via a WaitEventSet (SURVEY §2.5, §5.8) —
non-blocking sockets, readiness-driven state machines, no
thread-per-connection.  This is that shape for the pushed-task fan-out:
pipeline.py submits `execute_task` RPCs as futures, the loop drives
connect/send/recv for all of them concurrently, and completes each
future when its response frame lands.  A 64-shard fan-out costs O(1)
coordinator threads instead of 64.

Threading contract (LOCK01): the loop thread exclusively owns the
selector, the connection objects, and the per-endpoint idle pool;
callers only touch the command queue under ``_mu`` and wake the loop
through a socketpair.  Completion callbacks passed to submit() run ON
the loop thread — never inline on the submitting thread — so a caller
may hold its own locks across submit() without deadlock.
"""

from __future__ import annotations

import errno
import selectors
import socket
import struct
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional

from citus_tpu_torch.net.rpc import (
    AuthError, RpcError, decode_json_frame, encode_message,
)

import hashlib
import hmac as _hmac


class _Req:
    """One in-flight RPC: wire bytes out, a future to complete, and the
    loop-thread callback that hands the result to the dispatcher."""

    __slots__ = ("key", "data", "fut", "timeout", "done_cb")

    def __init__(self, key, data: bytes, fut: Future, timeout: float,
                 done_cb: Optional[Callable[[Future], None]]):
        self.key = key
        self.data = data
        self.fut = fut
        self.timeout = timeout
        self.done_cb = done_cb


class _Conn:
    """Per-socket state machine: connecting -> sending -> reading."""

    __slots__ = ("sock", "key", "req", "out", "out_off", "buf", "msg",
                 "nbin", "want_digest", "deadline", "connecting")

    def __init__(self, sock: socket.socket, key):
        self.sock = sock
        self.key = key
        self.req: Optional[_Req] = None
        self.out: Optional[bytes] = None
        self.out_off = 0
        self.buf = bytearray()
        self.msg: Optional[dict] = None
        self.nbin = 0
        self.want_digest: Optional[str] = None
        self.deadline = 0.0
        self.connecting = False


class RpcEventLoop:
    """One non-blocking dispatcher thread multiplexing data-plane RPCs.

    ``submit()`` is thread-safe and returns a Future resolving to
    ``(result_dict, blob_or_None)`` — the same shape as
    ``RpcClient.call_binary`` — or raising ``RpcError``.  Connections
    are pooled per endpoint inside the loop (bounded by IDLE_MAX) and
    evicted on error or on an explicit ``evict_endpoint`` (node death
    reported by the stat fan-out)."""

    #: idle loop-owned connections kept per endpoint
    IDLE_MAX = 8

    def __init__(self, secret: Optional[bytes] = None,
                 name: str = "citus-rpc-loop"):
        self.secret = secret
        self._sel = selectors.DefaultSelector()
        self._mu = threading.Lock()
        self._cmds: deque = deque()
        self._next_id = 0
        self._stopping = False
        self._started = False
        # wake channel: submit()/close() poke the selector out of its
        # wait so new commands are picked up immediately
        self._rs, self._ws = socket.socketpair()
        self._rs.setblocking(False)
        self._ws.setblocking(False)
        self._sel.register(self._rs, selectors.EVENT_READ, data=None)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)

    # ---- caller-side API (any thread) ----------------------------------

    def submit(self, endpoint: tuple, method: str,
               payload: Optional[dict] = None,
               blob: Optional[bytes] = None, timeout: float = 10.0,
               done_cb: Optional[Callable[[Future], None]] = None
               ) -> Future:
        """Queue one RPC; the returned future completes on the loop
        thread.  ``done_cb`` (if given) also runs on the loop thread
        right after completion — use it instead of
        ``Future.add_done_callback`` when the continuation takes locks
        the submitting thread may hold."""
        key = (str(endpoint[0]), int(endpoint[1]))
        fut: Future = Future()
        with self._mu:
            if self._stopping:
                raise RpcError("event loop is closed")
            self._next_id += 1
            rid = self._next_id
        # JSON-encode OUTSIDE the lock: encode cost parallelizes across
        # submitting threads; only the queue append is serialized
        data = encode_message({"id": rid, "method": method,
                               "payload": payload or {}},
                              self.secret, blob)
        req = _Req(key, data, fut, float(timeout), done_cb)
        with self._mu:
            if self._stopping:
                raise RpcError("event loop is closed")
            self._cmds.append(("submit", req))
            if not self._started:
                self._started = True
                self._thread.start()
        self._wake()
        return fut

    def evict_endpoint(self, endpoint: tuple) -> None:
        """Drop every pooled idle connection to ``endpoint`` (the node
        was reported dead); in-flight requests fail on their own."""
        key = (str(endpoint[0]), int(endpoint[1]))
        with self._mu:
            if self._stopping or not self._started:
                return
            self._cmds.append(("evict", key))
        self._wake()

    def close(self) -> None:
        with self._mu:
            self._stopping = True
            started = self._started
        if not started:
            for s in (self._rs, self._ws):
                try:
                    s.close()
                except OSError:
                    pass
            self._sel.close()
            return
        self._wake()
        self._thread.join(timeout=5.0)

    def _wake(self) -> None:
        try:
            self._ws.send(b"\x00")
        except (BlockingIOError, OSError):
            pass  # a pending wake byte (or a closed pipe) suffices

    # ---- loop thread ---------------------------------------------------

    def _run(self) -> None:
        from citus_tpu_torch.utils import sanitizer as _san
        _san.register_loop_thread()  # this thread must never block
        conns: dict[socket.socket, _Conn] = {}
        idle: dict[tuple, list] = {}
        try:
            while True:
                # lint: disable=BLK01 -- queue-swap microsection: every holder is O(us) and never blocks inside
                with self._mu:
                    cmds, self._cmds = self._cmds, deque()
                    stopping = self._stopping
                for kind, arg in cmds:
                    if kind == "submit":
                        self._start_request(arg, conns, idle)
                    elif kind == "evict":
                        for c in idle.pop(arg, []):
                            self._close_conn(c, conns)
                if stopping:
                    break
                timeout = None
                now = time.monotonic()
                for c in conns.values():
                    if c.req is not None:
                        left = max(0.0, c.deadline - now)
                        timeout = left if timeout is None \
                            else min(timeout, left)
                for skey, _ev in self._sel.select(timeout):
                    if skey.fileobj is self._rs:
                        try:
                            # lint: disable=BLK01 -- wake-channel drain: the socketpair is non-blocking by construction
                            while self._rs.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                        continue
                    c = conns.get(skey.fileobj)
                    if c is not None:
                        # lint: disable=BLK01 -- conn sockets are non-blocking; recv/send return EWOULDBLOCK, never park
                        self._service(c, conns, idle)
                self._reap_timeouts(conns, idle)
        finally:
            for c in list(conns.values()):
                if c.req is not None:
                    self._complete(c.req, exc=RpcError("event loop closed"))
                try:
                    self._sel.unregister(c.sock)
                except (KeyError, ValueError, OSError):
                    pass
                try:
                    c.sock.close()
                except OSError:
                    pass
            for s in (self._rs, self._ws):
                try:
                    s.close()
                except OSError:
                    pass
            self._sel.close()
            _san.unregister_loop_thread()

    def _start_request(self, req: _Req, conns, idle) -> None:
        pool = idle.get(req.key)
        while pool:
            c = pool.pop()
            if c.buf:
                # stray bytes on a parked connection: protocol desync,
                # never reuse it
                self._close_conn(c, conns)
                continue
            c.req = req
            c.out = req.data
            c.out_off = 0
            c.deadline = time.monotonic() + req.timeout
            self._sel.modify(c.sock, selectors.EVENT_WRITE)
            return
        try:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setblocking(False)
            rc = sock.connect_ex(req.key)
            if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
                raise OSError(rc, os_strerror(rc))
        except OSError as e:
            try:
                sock.close()
            except OSError:
                pass
            # a dead endpoint's parked siblings are stale too
            for c in idle.pop(req.key, []):
                self._close_conn(c, conns)
            self._complete(req, exc=RpcError(
                f"coordinator connection failed: {e}"))
            return
        c = _Conn(sock, req.key)
        c.req = req
        c.out = req.data
        c.out_off = 0
        c.connecting = True
        c.deadline = time.monotonic() + req.timeout
        conns[sock] = c
        self._sel.register(sock, selectors.EVENT_WRITE, data=None)

    def _service(self, c: _Conn, conns, idle) -> None:
        if c.connecting:
            err = c.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                self._fail_conn(c, conns, idle, RpcError(
                    f"coordinator connection failed: {os_strerror(err)}"))
                return
            c.connecting = False
        if c.out is not None:
            try:
                n = c.sock.send(memoryview(c.out)[c.out_off:])
            except BlockingIOError:
                return
            except OSError as e:
                self._fail_conn(c, conns, idle, RpcError(
                    f"coordinator connection failed: {e}"))
                return
            c.out_off += n
            if c.req is not None:
                c.deadline = time.monotonic() + c.req.timeout
            if c.out_off >= len(c.out):
                c.out = None
                c.out_off = 0
                self._sel.modify(c.sock, selectors.EVENT_READ)
            return
        # reading
        got_any = False
        while True:
            try:
                # lint: disable=BLK01 -- socket is non-blocking: recv returns or raises BlockingIOError immediately
                chunk = c.sock.recv(1 << 20)
            except BlockingIOError:
                break
            except OSError as e:
                self._fail_conn(c, conns, idle, RpcError(
                    f"coordinator connection failed: {e}"))
                return
            if not chunk:
                if c.req is not None:
                    self._fail_conn(c, conns, idle, RpcError(
                        "connection closed by coordinator"))
                else:
                    self._close_conn(c, conns, idle)
                return
            c.buf += chunk
            got_any = True
        if got_any and c.req is not None:
            c.deadline = time.monotonic() + c.req.timeout
        self._parse(c, conns, idle)

    def _parse(self, c: _Conn, conns, idle) -> None:
        while c.req is not None:
            if len(c.buf) < 4:
                return
            (n,) = struct.unpack(">I", bytes(c.buf[:4]))
            if len(c.buf) < 4 + n:
                return
            body = bytes(c.buf[4:4 + n])
            del c.buf[:4 + n]
            if c.msg is None:
                try:
                    msg = decode_json_frame(body, self.secret)
                except (AuthError, ValueError) as e:
                    self._fail_conn(c, conns, idle, RpcError(str(e)))
                    return
                nbin = msg.pop("bin", None)
                c.want_digest = msg.pop("bin_sha256", None)
                if nbin is None:
                    self._finish(c, conns, idle, msg, None)
                else:
                    c.msg = msg
                    c.nbin = int(nbin)
            else:
                if len(body) != c.nbin:
                    self._fail_conn(c, conns, idle, RpcError(
                        "binary frame length mismatch"))
                    return
                if self.secret is not None:
                    got = hashlib.sha256(body).hexdigest()
                    if c.want_digest is None or not _hmac.compare_digest(
                            got, c.want_digest):
                        self._fail_conn(c, conns, idle, RpcError(
                            "binary frame failed authentication"))
                        return
                msg, c.msg, c.nbin, c.want_digest = c.msg, None, 0, None
                self._finish(c, conns, idle, msg, body)

    def _finish(self, c: _Conn, conns, idle, msg: dict,
                blob: Optional[bytes]) -> None:
        req, c.req = c.req, None
        # park the connection BEFORE completing the future: a done_cb
        # that immediately submits the next task to this endpoint
        # (slow-start window ramp) finds the socket already reusable
        # lint: disable=BLK01 -- stopping-flag read: microsecond hold, no holder blocks inside
        with self._mu:
            stopping = self._stopping
        pool = idle.setdefault(c.key, [])
        if stopping or len(pool) >= self.IDLE_MAX:
            self._close_conn(c, conns)
        else:
            pool.append(c)
        if msg.get("error"):
            self._complete(req, exc=RpcError(msg["error"]))
        else:
            self._complete(req, result=(msg.get("result") or {}, blob))

    def _complete(self, req: _Req, result=None,
                  exc: Optional[BaseException] = None) -> None:
        if exc is not None:
            req.fut.set_exception(exc)
        else:
            req.fut.set_result(result)
        if req.done_cb is not None:
            try:
                req.done_cb(req.fut)
            # lint: disable=SWL01 -- a broken completion callback must not kill the dispatcher loop
            except Exception:
                pass

    def _fail_conn(self, c: _Conn, conns, idle,
                   exc: BaseException) -> None:
        req, c.req = c.req, None
        self._close_conn(c, conns, idle)
        if req is not None:
            self._complete(req, exc=exc)

    def _close_conn(self, c: _Conn, conns, idle=None) -> None:
        try:
            self._sel.unregister(c.sock)
        except (KeyError, ValueError, OSError):
            pass
        conns.pop(c.sock, None)
        if idle is not None:
            pool = idle.get(c.key)
            if pool and c in pool:
                pool.remove(c)
        try:
            c.sock.close()
        except OSError:
            pass

    def _reap_timeouts(self, conns, idle) -> None:
        now = time.monotonic()
        for c in [c for c in conns.values()
                  if c.req is not None and now > c.deadline]:
            self._fail_conn(c, conns, idle, RpcError(
                f"rpc timed out after {c.req.timeout:.1f}s "
                f"(endpoint {c.key[0]}:{c.key[1]})"))


def os_strerror(code: int) -> str:
    import os
    try:
        return os.strerror(code)
    except (ValueError, OverflowError):
        return f"errno {code}"
