"""Ray Client equivalent: remote drivers over one TCP connection.

Reference: python/ray/util/client/worker.py:1 (thin client) +
util/client/server/proxier.py (per-client server processes). A driver
outside the cluster connects with ``ray_tpu_torch.init("ray_tpu_torch://host:port?
authkey")``; everything it creates is OWNED by a head-side session
process, which cleans up (drops object refs, kills non-detached actors)
when the connection closes — the reference's client-session semantics.

Shape: ``ClientProxyServer`` (in the head process) only listens and
redirects — each accepted client is handed a freshly spawned session
subprocess (mirroring proxier.py's SpecificServer-per-client), because
a ``CoreClient`` is one-per-process (the ref tracker and direct-call
routes are process-global). The session owns a real ``CoreClient``,
so proxied work rides the same lease/direct fast paths as a local
driver.

Values cross the proxy as PACKED bytes in both directions (the
serialization module's flat format): the session never unpickles user
data, so client-side classes (``__main__`` definitions included) never
need to import server-side — unlike the reference proxy, which
deserializes in the server. A torch tensor travels as a host tensor of
its dtype, so a client without a card gets what a GPU worker returned
as a CPU tensor, and a CUDA tensor it puts leaves its card first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import transport
from .ids import ObjectID, WorkerID
from .protocol import ConnectionLost, PeerConn
from ..exceptions import RayTpuError

SCHEME = "ray_tpu_torch://"


def parse_proxy_address(address: str) -> Optional[Tuple[str, bytes]]:
    """"ray_tpu_torch://host:port?authkey_hex" -> (host:port, authkey)."""
    if not address.startswith(SCHEME):
        return None
    rest = address[len(SCHEME):]
    hostport, _, key_hex = rest.rpartition("?")
    if not hostport:
        raise RayTpuError(
            f"client address must be {SCHEME}host:port?authkey, got {address!r}"
        )
    return hostport, bytes.fromhex(key_hex)


# --------------------------------------------------------------------------
# Head-side listener: accept, spawn a session process, redirect.
# --------------------------------------------------------------------------


class ClientProxyServer:
    """Accepts ``ray_tpu_torch://`` clients and redirects each to its own
    session subprocess (reference: proxier.py, one SpecificServer per
    client)."""

    def __init__(self, head_address: str, authkey: bytes, port: int = 0,
                 host: str = ""):
        self._head_address = head_address
        self._authkey = authkey
        bind_host = host or transport.node_ip()
        self._listener = transport.make_listener(
            f"{bind_host}:{port}", authkey
        )
        self.address = transport.listener_address(self._listener)
        self._sessions: List[subprocess.Popen] = []
        self._closed = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="client-proxy-accept", daemon=True
        )
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                return
            threading.Thread(
                target=self._handshake, args=(conn,), daemon=True
            ).start()

    def _handshake(self, conn) -> None:
        try:
            transport.server_handshake(conn, self._authkey, tcp=True)
            msg = conn.recv()
            if not (isinstance(msg, dict) and msg.get("type") == "proxy_hello"):
                conn.close()
                return
            port = self._spawn_session()
            conn.send({"ok": port is not None, "redirect_port": port})
        except (OSError, EOFError):
            pass
        finally:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass

    def _spawn_session(self) -> Optional[int]:
        """Start a session process; returns the port it listens on."""
        # Sessions run on the head host and share its object namespace
        # (pool or per-segment shm), so workers read session puts
        # directly and the head's transfer server serves them
        # cross-node.
        env = dict(os.environ)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.client_proxy"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=env,
        )
        cfg = {
            "head_address": self._head_address,
            "authkey": self._authkey.hex(),
        }
        try:
            proc.stdin.write((json.dumps(cfg) + "\n").encode())
            proc.stdin.flush()
            line = proc.stdout.readline().decode().strip()
            port = int(json.loads(line)["port"])
        except Exception:  # noqa: BLE001 - session died during boot
            proc.kill()
            return None
        self._sessions.append(proc)
        self._sessions = [p for p in self._sessions if p.poll() is None]
        return port

    def shutdown(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except Exception:  # noqa: BLE001
            pass
        for p in self._sessions:
            if p.poll() is None:
                p.terminate()


# --------------------------------------------------------------------------
# Session process: one client, one CoreClient, full cleanup on close.
# --------------------------------------------------------------------------


class _Session:
    """Serves exactly one remote driver; owns its objects and actors."""

    def __init__(self, head_address: str, authkey: bytes):
        from .client import CoreClient

        self.core = CoreClient(
            head_address, authkey, role="driver",
            push_handler=self._forward_push,
        )
        self.conn: Optional[PeerConn] = None
        # oid -> ObjectRef we hold on the client's behalf. Entries are
        # born at submit/put time and dropped when the client's ref
        # tracker reports the last local instance died (update_refs
        # remove) — removes only follow advertised adds, so a drop here
        # is always safe.
        self._held: Dict[bytes, Any] = {}
        self._held_lock = threading.Lock()
        # Actors this session created (non-detached die with it).
        self._actors: Dict[bytes, bool] = {}  # aid -> detached
        self._pool = None
        self._done = threading.Event()

    # ------------------------------------------------------------- serve

    def serve(self, conn) -> None:
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="proxy-session"
        )
        # autostart=False: the first client frame may already be in the
        # socket buffer (1-RTT connect), and the reader must not deliver
        # it before self.conn is assigned.
        self.conn = PeerConn(
            conn, push_handler=self._on_msg,
            on_close=self._on_close, name="proxy-session",
            autostart=False,
        )
        self.conn.start()
        self._done.wait()

    def _forward_push(self, msg: Dict[str, Any]) -> None:
        """Cluster pushes (log lines, wait-ready events, ...) flow down
        to the remote driver."""
        c = self.conn
        if c is not None and not c.closed:
            try:
                c.send(msg)
            except ConnectionLost:
                pass

    def _on_close(self) -> None:
        self.cleanup()
        self._done.set()

    def _on_msg(self, msg: Any) -> None:
        if not isinstance(msg, dict):
            return
        t = msg.get("type")
        if t in ("proxy_get", "proxy_wait", "proxy_req"):
            # Blocking calls leave the reader thread free.
            self._pool.submit(self._dispatch, msg)
        else:
            self._dispatch(msg)

    def _dispatch(self, msg: Dict[str, Any]) -> None:
        t = msg.get("type")
        try:
            handler = getattr(self, f"_h_{t}", None)
            if handler is None:
                self.conn.reply(msg, ok=False, error=f"unknown {t!r}")
                return
            handler(msg)
        except ConnectionLost:
            pass
        except BaseException as e:  # noqa: BLE001 - ship to client
            if "req_id" in msg:
                try:
                    from . import serialization

                    self.conn.reply(
                        msg, ok=False, exception=serialization.pack(e)
                    )
                except ConnectionLost:
                    pass

    # ----------------------------------------------------------- handlers

    def _h_proxy_attach(self, msg):
        self.conn.reply(
            msg, ok=True,
            worker_id=self.core.worker_id.binary(),
            session_dir=self.core.session_dir,
        )

    def _h_proxy_submit(self, msg):
        spec = msg["spec"]
        if spec.actor_creation:
            self._actors[spec.actor_id.binary()] = spec.lifetime == "detached"
        if spec.function_blob is not None:
            # The client shipped the blob in this spec; our CoreClient
            # must not re-embed it for later specs of the same function.
            self.core.register_function_once(
                spec.function_id, spec.function_blob
            )
        refs = None
        if spec.num_returns is not None and spec.num_returns < 0:
            refs = self.core.submit(spec)  # streaming: ordered GCS route
        if refs is None:
            refs = self.core.submit_task_leased(spec)
        if refs is None and spec.actor_id is not None \
                and not spec.actor_creation:
            refs = self.core.submit_actor_direct(spec)
        if refs is None:
            refs = self.core.submit(spec)
        with self._held_lock:
            for r in refs:
                self._held[r.id().binary()] = r
        self.conn.reply(
            msg, ok=True,
            refs=[(r.id().binary(), r._owner) for r in refs],
        )

    def _h_proxy_put(self, msg):
        from .config import RayConfig

        from .ids import fast_unique_bytes

        oid = ObjectID(fast_unique_bytes())
        blob = msg["blob"]
        ref_cls = _object_ref_cls()
        ref = ref_cls(oid, self.core.worker_id.binary())
        fields: Dict[str, Any] = {
            "object_id": oid.binary(), "size": len(blob),
        }
        if len(blob) <= RayConfig.max_inline_object_size:
            fields["inline"] = bytes(blob)
        else:
            fields["segment"] = self.core.store.put_packed(oid, blob)
        if msg.get("children"):
            fields["children"] = msg["children"]
        # request_reliable: a proxy put must survive a head failover
        # like a direct client's put does (raylint raw-send-on-gcs-path).
        reply = self.core.request_reliable({"type": "put_object", **fields})
        if not reply.get("ok"):
            raise RayTpuError(f"proxy put failed: {reply}")
        self.core._tracker.mark_advertised(oid.binary())
        with self._held_lock:
            self._held[oid.binary()] = ref
        self.conn.reply(msg, ok=True, object_id=oid.binary(),
                        owner=self.core.worker_id.binary())

    def _h_proxy_get(self, msg):
        refs = [self._ref_for(oid) for oid in msg["oids"]]
        results = []
        try:
            blobs = self.core.get(refs, timeout=msg.get("timeout"),
                                  packed=True)
        except BaseException as e:  # noqa: BLE001 - per-batch failure
            from . import serialization

            self.conn.reply(msg, ok=False, exception=serialization.pack(e))
            return
        for b in blobs:
            results.append(bytes(b) if not isinstance(b, bytes) else b)
        self.conn.reply(msg, ok=True, blobs=results)

    def _h_proxy_wait(self, msg):
        refs = [self._ref_for(oid) for oid in msg["oids"]]
        ready, pending = self.core.wait(
            refs, num_returns=msg["num_returns"], timeout=msg.get("timeout")
        )
        self.conn.reply(
            msg, ok=True,
            ready=[r.id().binary() for r in ready],
            pending=[r.id().binary() for r in pending],
        )

    def _h_proxy_free(self, msg):
        self.core.free([self._ref_for(oid) for oid in msg["oids"]])
        self.conn.reply(msg, ok=True)

    def _h_proxy_req(self, msg):
        inner = msg["inner"]
        reply = self.core.request(inner, timeout=msg.get("timeout"))
        out = {k: v for k, v in reply.items() if k not in ("type", "req_id")}
        self.conn.reply(msg, **out)

    def _h_proxy_send(self, msg):
        self.core.send(msg["inner"])

    def _h_update_refs(self, msg):
        """The remote driver's ref tracker: adds pin (borrowed refs the
        session didn't create), removes drop our hold."""
        ref_cls = _object_ref_cls()
        for oid in msg.get("add", ()):
            # Construct outside the lock (ObjectRef.__init__ touches the
            # core tracker); a redundant instance just dies.
            ref = ref_cls(ObjectID(oid), b"")
            with self._held_lock:
                self._held.setdefault(oid, ref)
        with self._held_lock:
            for oid in msg.get("remove", ()):
                self._held.pop(oid, None)

    def _ref_for(self, oid: bytes):
        with self._held_lock:
            ref = self._held.get(oid)
        if ref is not None:
            return ref
        return _object_ref_cls()(ObjectID(oid), b"")

    # ------------------------------------------------------------ cleanup

    def cleanup(self) -> None:
        """Client went away: kill its non-detached actors, drop its
        objects, close the core client (reference: client server
        cleanup on disconnect, proxier.py)."""
        for aid, detached in list(self._actors.items()):
            if detached:
                continue
            try:
                self.core.request(
                    {"type": "kill_actor", "actor_id": aid,
                     "reason": "client disconnected"},
                    timeout=5,
                )
            except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- the session is closing: an actor the head no longer knows is already gone
                pass
        with self._held_lock:
            self._held.clear()
        try:
            self.core._tracker.flush(self.core)
        except Exception:  # noqa: BLE001
            pass
        try:
            self.core.close()
        except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- teardown: the peer may already be gone, and what follows frees the rest
            pass


def _object_ref_cls():
    from ..object_ref import ObjectRef

    return ObjectRef


def _session_main() -> int:
    cfg = json.loads(sys.stdin.readline())
    session = _Session(cfg["head_address"], bytes.fromhex(cfg["authkey"]))
    listener = transport.make_listener(
        "0.0.0.0:0", bytes.fromhex(cfg["authkey"])
    )
    port = int(listener.address[1])
    sys.stdout.write(json.dumps({"port": port}) + "\n")
    sys.stdout.flush()
    attached = threading.Event()

    def _abandon_watchdog():
        # The client got our redirect but never dialed in (crashed,
        # network drop): don't linger as an orphan for the head's
        # lifetime.
        if not attached.wait(120):
            os._exit(0)

    threading.Thread(target=_abandon_watchdog, daemon=True).start()
    try:
        conn = listener.accept()
        transport.server_handshake(
            conn, bytes.fromhex(cfg["authkey"]), tcp=True
        )
        attached.set()
    finally:
        listener.close()
    session.serve(conn)  # returns when the client disconnects
    return 0


# --------------------------------------------------------------------------
# Client side: the thin driver.
# --------------------------------------------------------------------------


class ProxyClient:
    """CoreClient-shaped API over one TCP connection to a session
    process. The public API layer (worker.py / remote_function.py /
    actor.py) runs unchanged on top: the direct/lease fast paths report
    "no route" so every call falls back to ``submit()``, which this
    class forwards; ``request``/``send`` pass through, which carries
    the entire long tail (state API, placement groups, jobs, streaming
    stream_next, kv) without per-feature proxy code."""

    def __init__(self, hostport: str, authkey: bytes,
                 push_handler=None):
        self._push_handler = push_handler or (lambda msg: None)
        # Leg 1: the redirect handshake with the head's proxy listener.
        raw = transport.connect(hostport, authkey)
        raw.send({"type": "proxy_hello"})
        redirect = raw.recv()
        raw.close()
        if not redirect.get("ok"):
            raise RayTpuError("client proxy refused the connection")
        host = hostport.rpartition(":")[0]
        # Leg 2: the session connection.
        conn = transport.connect(
            f"{host}:{redirect['redirect_port']}", authkey
        )
        self.conn = PeerConn(
            conn, push_handler=self._on_push, name="proxy-client",
        )
        reply = self.conn.request({"type": "proxy_attach"}, timeout=30)
        if not reply.get("ok"):
            raise RayTpuError(f"proxy attach failed: {reply}")
        self.worker_id = WorkerID(reply["worker_id"])
        self.session_dir = reply["session_dir"]
        self.role = "driver"
        self._registered: set = set()
        self._fn_lock = threading.Lock()
        from .ref_tracker import LegacyRefTracker, set_current

        # The LEGACY (centralized) tracker on purpose: it sends
        # update_refs over ``client.conn`` — here that's the session
        # conn, and the session translates adds/removes into holds/
        # drops of the real (session-owned) refs. Owner-side counting
        # happens cluster-side in the session's own CoreClient.
        self._lineage: Dict[bytes, Any] = {}
        self._tracker = LegacyRefTracker(self)
        set_current(self._tracker)

    # ------------------------------------------------------ tracker hooks

    def _wait_prune(self, oids) -> None:  # tracker callback; no wait state
        pass

    # --------------------------------------------------------- transport

    def _on_push(self, msg: Any) -> None:
        if isinstance(msg, dict) and msg.get("type") == "log_lines":
            self._push_handler(msg)
            return
        self._push_handler(msg)

    def request(self, msg: Dict[str, Any],
                timeout: Optional[float] = None) -> Dict[str, Any]:
        return self.conn.request(
            {"type": "proxy_req", "inner": msg, "timeout": timeout},
            timeout=None if timeout is None else timeout + 10,
        )

    def send(self, msg: Dict[str, Any]) -> None:
        self.conn.send({"type": "proxy_send", "inner": msg})

    def flush_lazy(self) -> None:
        pass

    # ------------------------------------------------------- submissions

    def register_function_once(self, function_id: bytes,
                               blob: bytes) -> Optional[bytes]:
        """Same contract as CoreClient: the blob rides inside the first
        spec that names the function; the GCS registers it from there."""
        with self._fn_lock:
            if function_id in self._registered:
                return None
            self._registered.add(function_id)
            return blob

    def fetch_function(self, function_id: bytes) -> bytes:
        reply = self.request(
            {"type": "get_function", "function_id": function_id}
        )
        return reply["blob"]

    def submit(self, spec) -> List[Any]:
        from ..object_ref import ObjectRef

        reply = self.conn.request({"type": "proxy_submit", "spec": spec})
        self._raise_if_failed(reply)
        refs = [ObjectRef(ObjectID(oid), owner)
                for oid, owner in reply["refs"]]
        for r in refs:
            # The session holds these from birth; our eventual remove
            # must go out even if the ref dies within one flush window.
            self._tracker.mark_advertised(r.id().binary())
        return refs

    # The connection-level fast paths need in-cluster sockets the thin
    # client doesn't have; returning None routes everything through
    # submit() (the session applies the fast paths cluster-side).
    def submit_task_leased(self, spec):
        return None

    def submit_actor_direct(self, spec):
        return None

    def call_actor_fast(self, *a, **kw):
        return None

    # ------------------------------------------------------ objects

    def put(self, value: Any):
        from . import serialization
        from ..object_ref import ObjectRef, _CaptureRefs

        # A CUDA tensor anywhere in the value leaves its card in the
        # pickler (serialization._reduce_tensor): no prepare step.
        with _CaptureRefs() as cap:
            payload, buffers = serialization.dumps(value)
        size = serialization.serialized_size(payload, buffers)
        blob = bytearray(size)
        serialization.write_to(memoryview(blob), payload, buffers)
        reply = self.conn.request(
            {"type": "proxy_put", "blob": bytes(blob),
             "children": cap.seen or None}
        )
        self._raise_if_failed(reply)
        ref = ObjectRef(ObjectID(reply["object_id"]), reply["owner"])
        self._tracker.mark_advertised(ref.id().binary())
        return ref

    def put_with_id(self, oid, value):
        raise RayTpuError("put_with_id is not supported over ray_tpu_torch://")

    def get(self, refs: Sequence[Any],
            timeout: Optional[float] = None) -> List[Any]:
        from . import serialization

        if not refs:
            return []
        reply = self.conn.request(
            {
                "type": "proxy_get",
                "oids": [r.id().binary() for r in refs],
                "timeout": timeout,
            },
            timeout=None if timeout is None else timeout + 30,
        )
        self._raise_if_failed(reply)
        return [serialization.unpack(b) for b in reply["blobs"]]

    def wait(self, refs: Sequence[Any], num_returns: int = 1,
             timeout: Optional[float] = None):
        reply = self.conn.request(
            {
                "type": "proxy_wait",
                "oids": [r.id().binary() for r in refs],
                "num_returns": num_returns,
                "timeout": timeout,
            },
            timeout=None if timeout is None else timeout + 30,
        )
        self._raise_if_failed(reply)
        by_id = {r.id().binary(): r for r in refs}
        return (
            [by_id[o] for o in reply["ready"]],
            [by_id[o] for o in reply["pending"]],
        )

    def free(self, refs: Sequence[Any]) -> None:
        self.conn.request(
            {"type": "proxy_free",
             "oids": [r.id().binary() for r in refs]}
        )

    # ------------------------------------------------------------- kv

    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True,
               ns: str = "") -> bool:
        r = self.request({"type": "kv_put", "key": key, "value": value,
                          "overwrite": overwrite, "ns": ns})
        return bool(r.get("added"))

    def kv_get(self, key: bytes, ns: str = "") -> Optional[bytes]:
        return self.request({"type": "kv_get", "key": key, "ns": ns}).get(
            "value"
        )

    def kv_del(self, key: bytes, ns: str = "") -> bool:
        r = self.request({"type": "kv_del", "key": key, "ns": ns})
        return bool(r.get("deleted"))

    def kv_exists(self, key: bytes, ns: str = "") -> bool:
        return bool(
            self.request({"type": "kv_exists", "key": key, "ns": ns}).get(
                "exists"
            )
        )

    def kv_keys(self, prefix: bytes = b"", ns: str = "") -> List[bytes]:
        return self.request(
            {"type": "kv_keys", "prefix": prefix, "ns": ns}
        ).get("keys", [])

    def cluster_info(self) -> Dict[str, Any]:
        return self.request({"type": "cluster_info"})["info"]

    # ---------------------------------------------------------- lifecycle

    def _raise_if_failed(self, reply: Dict[str, Any]) -> None:
        if reply.get("ok"):
            return
        exc = reply.get("exception")
        if exc is not None:
            from . import serialization
            from ..exceptions import RayTaskError

            e = serialization.unpack(exc)
            if isinstance(e, RayTaskError):
                raise e.as_instanceof_cause()
            raise e
        raise RayTpuError(f"proxy call failed: {reply}")

    def close(self) -> None:
        from .ref_tracker import set_current

        try:
            self._tracker.stop()
        except Exception:  # noqa: BLE001
            pass
        set_current(None)
        try:
            self.conn.close()
        except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- teardown: the peer may already be gone, and what follows frees the rest
            pass


if __name__ == "__main__":
    sys.exit(_session_main())
