"""Control-plane message transport.

The reference's control plane is gRPC (src/ray/rpc/) with one service per
daemon. On-node we use unix-domain sockets via multiprocessing.connection
(length-prefixed frames) — the same request/reply + push pattern, without
a schema compiler. A ``PeerConn`` wraps a Connection with a send lock, a
reader thread, request/reply correlation futures, and a handler for
unsolicited pushes (the pubsub direction).

Two message shapes share each connection:

- dicts with a "type" key: the general control plane (replies carry the
  originating "req_id").
- tuples: compact frames for the two hot paths — task/actor-call
  execution and its reply. A tuple costs a fraction of a dict to pickle
  and carries no field-name strings (reference: the hot RPCs are
  hand-rolled protobufs while the long tail shares generic plumbing).

Senders may coalesce: ``send_lazy`` buffers frames and ships them as one
``("B", [...])`` envelope — one pickle header + one syscall for a whole
burst. This is the single biggest control-plane cost lever: every
message otherwise pays its own pickle + write + reader wakeup
(reference: gRPC channel-level batching / writev).
"""
from __future__ import annotations

import itertools
import pickle
import threading
from concurrent.futures import Future
from multiprocessing.connection import Connection
from typing import Any, Callable, Dict, List, Optional

from . import chaos as _chaos
from . import fastpath as _fastpath

# Tuple-frame opcodes.
OP_CALL = 1  # (1, req_id, task_id, function_id, method, args_blob, num_returns, actor_id)
OP_REPLY = 2  # (2, req_id, error_blob, results); results = [(inline, segment, size, children)]

_LAZY_MAX = 128  # flush the out-buffer at this depth regardless

# Native frame codec (native/fastpath.c): the hot tuple frames ride a
# typed binary wire format encoded in C; everything else (and every
# frame when no toolchain is present) stays pickle. The two are
# distinguished by the payload's first byte — pickle proto 2+ starts
# 0x80, fast frames 0xF1 — so mixed senders interoperate per message.
_fp = _fastpath.get()
_FAST_MAGIC = 0xF1


class ConnectionLost(Exception):
    pass


class PeerConn:
    """Bidirectional framed channel with request/reply correlation."""

    def __init__(
        self,
        conn: Connection,
        push_handler: Callable[[Any], None],
        on_close: Optional[Callable[[], None]] = None,
        name: str = "peer",
        autostart: bool = True,
        handshake: Optional[Callable[[Connection], None]] = None,
    ):
        self._conn = conn
        # Deferred auth: the listener accepted raw so its accept loop
        # never serializes HMAC challenges; the reader thread completes
        # the handshake before the first frame (a connect storm of N
        # workers then authenticates on N threads, not one).
        self._handshake = handshake
        # Remote process role (head|raylet|worker|driver) when known —
        # set by creators (client/raylet head conns) or stamped by the
        # GCS at hello/register_node. The chaos partition primitive
        # consults it on both the send and deliver sides; None (role
        # unknown) always passes.
        self.peer_role: Optional[str] = None
        self._send_lock = threading.Lock()
        self._out: List[Any] = []
        self._pending: Dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        self._req_counter = itertools.count()
        self._push_handler = push_handler
        self._on_close = on_close
        self._closed = threading.Event()
        self._reader = threading.Thread(
            target=self._read_loop, name=f"reader-{name}", daemon=True
        )
        if autostart:
            self._reader.start()

    def start(self) -> None:
        """Start the reader (for callers that must finish wiring first)."""
        if not self._reader.is_alive():
            self._reader.start()

    def set_on_close(self, cb: Optional[Callable[[], None]]) -> None:
        """Attach/replace the close handler after construction (probe
        connections promote to long-lived ones once registered)."""
        self._on_close = cb
        if self._closed.is_set() and cb is not None:
            cb()

    # ------------------------------------------------------------------ send

    def send(self, msg: Any) -> None:
        """Eager push: flushes anything buffered first (order preserved)."""
        with self._send_lock:
            self._out.append(msg)
            self._flush_locked()

    def send_lazy(self, msg: Any) -> None:
        """Buffered push: shipped on the next flush/eager send, or when
        the buffer hits the depth cap. Callers that buffer are
        responsible for flushing before they block on a reply."""
        with self._send_lock:
            self._out.append(msg)
            if len(self._out) >= _LAZY_MAX:
                self._flush_locked()

    def flush(self) -> None:
        if not self._out:
            return
        with self._send_lock:
            self._flush_locked()

    @property
    def has_buffered(self) -> bool:
        return bool(self._out)

    def _flush_locked(self) -> None:
        out = self._out
        if not out:
            return
        self._out = []
        if self.peer_role is not None:
            sched = _chaos._active
            if sched is not None and sched.partition_blocks(
                _chaos.current_role(), self.peer_role
            ):
                # Partitioned link: frames vanish in flight while the
                # TCP connection stays ESTABLISHED (the gray failure a
                # heartbeat sweeper must catch — no ConnectionLost, no
                # EOF, requests just time out).
                return
        msg = out[0] if len(out) == 1 else ("B", out)
        try:
            if self.peer_role is not None and _chaos.throttled(
                _chaos.current_role(), self.peer_role
            ):
                # Throttled link (chaos): materialize the frame to
                # learn its wire size, pace it through the modeled
                # slow link (the sleep lives in the chaos engine),
                # then ship the bytes we already encoded. The receive
                # boundary paces too, so a one-sided install still
                # degrades both directions.
                payload = _fp.encode(msg) if _fp is not None else None
                if payload is None:
                    payload = pickle.dumps(msg)
                _chaos.throttle_pace(
                    _chaos.current_role(), self.peer_role, len(payload)
                )
                self._conn.send_bytes(payload)
                return
            if _fp is not None:
                payload = _fp.encode(msg)
                if payload is not None:
                    self._conn.send_bytes(payload)
                    return
            self._conn.send(msg)
        except (OSError, EOFError, BrokenPipeError, ValueError) as e:
            raise ConnectionLost(str(e)) from e

    # -------------------------------------------------------------- request

    def next_req_id(self) -> int:
        return next(self._req_counter)

    def register_future(self, req_id: int) -> Future:
        """Register a reply future for a frame the caller sends itself
        (compact tuple frames carry the req_id in-band)."""
        fut: Future = Future()
        with self._pending_lock:
            self._pending[req_id] = fut
        return fut

    def drop_future(self, req_id: int) -> None:
        with self._pending_lock:
            self._pending.pop(req_id, None)

    def _check_open_for_request(self, req_id: int) -> None:
        """A reply future registered AFTER the reader's close cleanup
        ran would never be failed — and a send into a dying socket can
        still land in the kernel buffer without raising — so the caller
        would block forever. The reader sets ``_closed`` before failing
        its pending futures; checking it after registration closes the
        race window (found as a wedged lease_worker request issued in a
        head-failover kill window)."""
        if self._closed.is_set():
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise ConnectionLost("peer connection closed")

    def closed_after_push(self, req_id: int) -> bool:
        """``send_lazy`` twin of ``_check_open_for_request``: buffered
        pushes raise nothing, so a conn that closed between the route
        lookup and the push leaves the reply future registered AFTER
        the reader's close sweep — and ``flush_lazy`` skips closed
        conns, so the frame never ships and the future pends forever.
        Every send_lazy-with-reply call site must call this after the
        push (the reader sets ``_closed`` before sweeping, so a False
        here guarantees a later close WILL fail the already-registered
        future). On True the future is dropped; the caller resolves
        through its conn-lost path. Note the frame MAY still have
        flushed before the close landed — callers keep at-most-once
        semantics (delivered=True)."""
        if self._closed.is_set():
            self.drop_future(req_id)
            return True
        return False

    def request(self, msg: Dict[str, Any], timeout: Optional[float] = None) -> Any:
        """Send and block for the correlated reply; returns reply dict.

        The req_id is written into ``msg`` in place — callers pass a
        fresh dict per request (every call site builds a literal)."""
        req_id = next(self._req_counter)
        msg["req_id"] = req_id
        fut: Future = Future()
        with self._pending_lock:
            self._pending[req_id] = fut
        try:
            self._check_open_for_request(req_id)
            self.send(msg)
            return fut.result(timeout=timeout)
        finally:
            with self._pending_lock:
                self._pending.pop(req_id, None)

    def request_async(self, msg: Dict[str, Any]) -> Future:
        """Fire a request, return the reply Future (for pipelined
        direct actor calls — many in flight on one connection)."""
        req_id = next(self._req_counter)
        msg["req_id"] = req_id
        fut: Future = Future()
        with self._pending_lock:
            self._pending[req_id] = fut
        try:
            self._check_open_for_request(req_id)
            self.send(msg)
        except BaseException:
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise
        return fut

    def reply(self, req_msg: Dict[str, Any], **fields) -> None:
        self.send({"type": "reply", "req_id": req_msg["req_id"], **fields})

    # ---------------------------------------------------------------- receive

    # raylint: dispatch-only
    def _deliver(self, msg: Any) -> None:
        if type(msg) is tuple and msg[0] == "B":
            # Coalesced envelope: chaos (and delivery) act per inner
            # message, never on the envelope itself.
            for m in msg[1]:
                self._deliver(m)
            return
        sched = _chaos._active
        if sched is None:
            self._deliver_one(msg)
            return
        if self.peer_role is not None and sched.partition_blocks(
            self.peer_role, _chaos.current_role()
        ):
            # Incoming half of a cut link: frames already in flight (or
            # sent by a peer whose processes don't carry the partition
            # spec) are dropped on arrival — this is what makes a
            # one-sided install cut both directions.
            return
        # Chaos engine: the transport boundary — one message in may
        # deliver zero (drop/held), one, or several (dup/released
        # reorder hold) messages, in the schedule's order.
        mtype = _chaos.mtype_of(msg)
        if mtype is None:
            self._deliver_one(msg)
            return
        for m in sched.intercept(self, mtype, msg):
            self._deliver_one(m)

    # raylint: dispatch-only
    def _deliver_one(self, msg: Any) -> None:
        if type(msg) is tuple:
            op = msg[0]
            if op == OP_REPLY:
                with self._pending_lock:
                    fut = self._pending.pop(msg[1], None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
            else:
                self._push_handler(msg)
        elif msg.get("type") == "reply":
            with self._pending_lock:
                fut = self._pending.pop(msg["req_id"], None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
        else:
            self._push_handler(msg)

    def _read_loop(self) -> None:
        recv_bytes = self._conn.recv_bytes
        loads = pickle.loads
        decode = _fp.decode if _fp is not None else None
        try:
            if self._handshake is not None:
                try:
                    self._handshake(self._conn)
                except Exception:  # noqa: BLE001 - failed auth
                    try:
                        self._conn.close()
                    except OSError:
                        pass
                    return  # finally below runs the close bookkeeping
            while True:
                buf = recv_bytes()
                if self.peer_role is not None and _chaos.throttled(
                    self.peer_role, _chaos.current_role()
                ):
                    # Receive-side token bucket: pace inbound frames by
                    # wire size before delivery (head-of-line blocking,
                    # exactly what a saturated NIC does). The sleep
                    # lives inside the chaos engine — this reader is
                    # not a raylint dispatch root, _deliver is.
                    _chaos.throttle_pace(
                        self.peer_role, _chaos.current_role(), len(buf)
                    )
                if buf and buf[0] == _FAST_MAGIC and decode is not None:
                    msg = decode(buf)
                else:
                    msg = loads(buf)
                self._deliver(msg)
                # Replies generated inline while draining (worker-side
                # execution on this thread) ship the moment the input
                # goes quiet — batch-for-batch with the caller's bursts.
                if self._out and not self._conn.poll(0):
                    self.flush()
        except (EOFError, OSError, BrokenPipeError):
            pass
        except TypeError:
            # multiprocessing's read() gets a None handle when close()
            # races recv — at interpreter exit or on mid-session
            # connection close. Both are connection loss; a TypeError
            # with the handle still live is a real bug — re-raise.
            import sys

            if not (sys.is_finalizing() or self._conn.closed):
                raise
        finally:
            sched = _chaos._active
            if sched is not None:
                # A reorder hold must never silently become a drop:
                # deliver anything still held before close bookkeeping.
                for m in sched.drain_held(self):
                    try:
                        self._deliver_one(m)
                    except Exception:  # noqa: BLE001
                        pass
            self._closed.set()
            with self._pending_lock:
                pending = list(self._pending.values())
                self._pending.clear()
            for fut in pending:
                if not fut.done():
                    fut.set_exception(ConnectionLost("peer connection closed"))
            if self._on_close is not None:
                try:
                    self._on_close()
                except Exception:
                    pass

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def close(self) -> None:
        # shutdown(2) first: close() alone does not tear down the
        # socket while this conn's own reader thread sits blocked in
        # read() on the fd (the kernel holds the struct file), so the
        # remote end would never see EOF and blocked peers would hang.
        # A dup'd wrapper shares the underlying socket, so SHUT_RDWR
        # lands on it; the wrapper close only drops the dup.
        try:
            import os as _os
            import socket as _socket

            s = _socket.socket(fileno=_os.dup(self._conn.fileno()))
            try:
                s.shutdown(_socket.SHUT_RDWR)
            finally:
                s.close()
        except Exception:  # noqa: BLE001 - non-socket fd or already closed
            pass
        try:
            self._conn.close()
        except Exception:
            pass
