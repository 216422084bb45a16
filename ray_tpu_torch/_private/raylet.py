"""Per-node daemon: worker pool + local object store on a cluster node.

Reference: src/ray/raylet/ — the raylet is the per-node daemon that owns
the local worker pool (worker_pool.h:159), embeds the plasma store, and
serves object transfer (the ObjectManager lives inside it,
object_manager.h:117). Scheduling decisions stay central in this
rebuild (the GCS owns the cluster resource view and dispatches
directly), so the daemon's job is mechanics, not policy:

  - register the node (resources + transfer address) with the head GCS
    over TCP and heartbeat it
  - spawn/kill worker processes when the GCS asks; workers connect
    straight back to the GCS control plane themselves
  - own the node-local shm pool and serve chunked object pulls from it
    (the data plane — object_transfer.py)

Started by `python -m ray_tpu_torch._private.raylet --address=<head_host:port>
--authkey=<hex>` against a head started with `ray_tpu_torch.init(tcp_port=...)`.
"""
from __future__ import annotations

import argparse
import json
import os
import secrets
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from . import chaos as _chaos
from . import events as _events
from .accelerators import GPUAcceleratorManager
from .config import RayConfig, temp_root
from .ids import WorkerID
from .object_store import ObjectStore
from .object_transfer import ObjectTransferServer
from .protocol import ConnectionLost, PeerConn
from . import transport


class NodeDaemon:
    def __init__(
        self,
        gcs_address: str,
        authkey: bytes,
        resources: Dict[str, float],
        label: str = "",
        transfer_host: str = "127.0.0.1",
    ):
        self.gcs_address = gcs_address
        self.authkey = authkey
        self.resources = resources
        self.label = label
        self._workers: Dict[bytes, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._stopped = threading.Event()  # set once shutdown() has finished
        # Set once this constructor has finished. The head may push work
        # (a spawn for demand that was waiting for this node) the moment
        # it has registered the node, before the attributes those pushes
        # need exist; the reader thread holds them until then (the
        # reference's raises AttributeError there, and the lost conn
        # costs the node its first incarnation).
        self._ready = threading.Event()
        self._rejoining = False
        self._draining = False
        # Zombie self-fence in progress (membership protocol): suppresses
        # the normal rejoin path while this daemon drains its old
        # incarnation and re-registers as a fresh one.
        self._fencing = False
        # Fork-server spawning (spawn.py): the zygote starts lazily at
        # the first spawn, inheriting this daemon's env (node ns, pool,
        # local-raylet lease addr are all set before any worker exists).
        from .spawn import WorkerSpawner

        pythonpath = (
            os.getcwd() + os.pathsep + sys.path[0] + os.pathsep
            + os.environ.get("PYTHONPATH", "")
        )
        self._spawner_env = {
            "RAY_TPU_TORCH_SESSION_ADDR": gcs_address,
            "RAY_TPU_TORCH_AUTHKEY": authkey.hex(),
            "PYTHONPATH": pythonpath,
        }
        self._spawner = WorkerSpawner(dict(self._spawner_env))

        # Node-local object pool: our own namespace + pool, inherited by
        # the workers we spawn. Set BEFORE the store/transfer server are
        # created so they attach to this node's pool.
        self.node_ns = secrets.token_hex(4) + "_"
        os.environ["RAY_TPU_TORCH_NODE_NS"] = self.node_ns
        pool_name = f"/rtpt_pool_{secrets.token_hex(4)}"
        self._pool = None
        try:
            from .native_store import PoolStore, native_available

            if native_available():
                # Honor the session's configured store size (env-carried
                # RAY_TPU_TORCH_object_store_memory_bytes): a deliberately
                # constrained pool must constrain every node, not just
                # the head — the memory-pressure soaks depend on it.
                self._pool = PoolStore(
                    pool_name, create=True,
                    pool_bytes=RayConfig.object_store_memory_bytes or None,
                )
                os.environ["RAY_TPU_TORCH_POOL_NAME"] = pool_name
            else:
                os.environ.pop("RAY_TPU_TORCH_POOL_NAME", None)
        except Exception:  # noqa: BLE001 - per-object segment fallback
            self._pool = None
            os.environ.pop("RAY_TPU_TORCH_POOL_NAME", None)
        self.store = ObjectStore()
        self.transfer = ObjectTransferServer(
            self.store, f"{transfer_host}:0", authkey
        )

        # Initial head connect rides the one shared retry policy (full
        # jitter + budget): a daemon booted while the head restarts —
        # or pointed at a supervisor-managed head mid-failover — must
        # absorb refused connects instead of dying on the first one.
        raw = _chaos.retry_call(
            lambda: transport.connect(gcs_address, authkey),
            retry_on=(OSError,),
            backoff=_chaos.Backoff(
                base_s=0.25, cap_s=3.0,
                budget_s=RayConfig.worker_register_timeout_s,
            ),
        )
        self.conn = PeerConn(
            raw,
            push_handler=self._on_push,
            on_close=self._on_gcs_close,
            name="raylet",
        )
        # Partition-chaos role stamp: link cuts are expressed between
        # named roles, and this conn's far side is the head.
        self.conn.peer_role = "head"
        reply = self.conn.request(
            {
                "type": "register_node",
                "resources": resources,
                "transfer_addr": self.transfer.address,
                "label": label or os.uname().nodename,
                "pid": os.getpid(),
            },
            timeout=RayConfig.worker_register_timeout_s,
        )
        if not reply.get("ok"):
            raise RuntimeError(f"node registration failed: {reply}")
        self.node_id: bytes = reply["node_id"]
        self.session_dir: str = reply["session_dir"]
        # Head-assigned incarnation: stamped on every heartbeat so the
        # head can fence messages from a declared-dead (zombie) epoch.
        self.incarnation: int = reply.get("incarnation", 1)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="raylet-heartbeat", daemon=True
        )
        self._hb_thread.start()
        # This daemon's workers log into a raylet-owned local dir (NOT
        # the head's session dir — on a shared box the head's monitor
        # would double-ship every line; on a real remote machine the
        # head can't see the files at all). One monitor tails it and
        # ships batches over the control plane.
        from .log_monitor import LogMonitor

        self.logs_dir = os.path.join(
            temp_root(), "raylet_logs", self.node_ns.rstrip("_")
        )
        os.makedirs(self.logs_dir, exist_ok=True)
        self._log_monitor = LogMonitor(self.logs_dir, self._publish_logs)
        # Local dispatch authority (reference: the raylet owns local
        # scheduling — cluster_task_manager.cc:44, worker_pool.h:159):
        # a lease service on a node-local socket grants this daemon's
        # own worker pool to local clients without a head round-trip;
        # leased CPUs sync to the GCS resource view via heartbeats.
        self._local_workers: Dict[bytes, Dict] = {}
        # Leased-out counts by worker kind; feeds the heartbeat's
        # local_*_in_use resource-view sync.
        self._leased_count = {"cpu": 0, "gpu": 0}
        # GPU slots (each GPU worker, local or head-routed, gets its own
        # card ids; CUDA_VISIBLE_DEVICES pins the worker to them).
        # Grown on demand — cards are too valuable to prestart on.
        self._gpu_ids = GPUAcceleratorManager.node_device_ids(
            int(self.resources.get("GPU", 0))
        )
        self._gpu_slots_of: Dict[bytes, List[int]] = {}  # worker id -> slots
        # In /tmp for AF_UNIX's ~107-byte limit; unique per node.
        self._lease_addr = f"/tmp/rtpt-rl-{self.node_ns.rstrip('_')}.sock"
        try:
            os.unlink(self._lease_addr)
        except FileNotFoundError:
            pass
        from multiprocessing.connection import Listener as _Listener

        # Auth is the transport token handshake, run on each lease
        # conn's reader thread (never in the accept loop).
        self._lease_listener = _Listener(
            self._lease_addr, family="AF_UNIX", authkey=None
        )
        os.environ["RAY_TPU_TORCH_LOCAL_RAYLET"] = self._lease_addr
        threading.Thread(
            target=self._lease_accept_loop, name="raylet-lease", daemon=True
        ).start()
        for _ in range(min(2, int(self.resources.get("CPU", 0)))):
            self._spawn_local_worker()
        self._ready.set()

    def _publish_logs(self, entries):
        try:
            self.conn.send(
                {
                    "type": "log_batch",
                    "node": self.label or f"node-{self.node_id.hex()[:6]}",
                    "entries": entries,
                }
            )
        except ConnectionLost:
            pass

    # --------------------------------------------------------------- pushes

    # raylint: dispatch-only
    def _on_push(self, msg):
        self._ready.wait()
        mtype = msg.get("type")
        if mtype == "spawn_worker":
            self._spawn_worker(msg)
        elif mtype == "kill_worker":
            self._kill_worker(msg["worker_id"])
        elif mtype == "free_objects":
            oids = msg.get("object_ids", [])
            for oid in oids:
                from .ids import ObjectID

                try:
                    self.store.delete(ObjectID(oid))
                except Exception:  # noqa: BLE001
                    pass
            if oids and _events.enabled():
                # Object-plane visibility: replica reclaim on this node
                # (ships with the next heartbeat's event piggyback).
                _events.record(
                    _events.OBJECT, self.label or self.node_ns.rstrip("_"),
                    "FREED_BATCH", {"n": len(oids)},
                )
        elif mtype == "drain":
            # Graceful drain: stop granting local leases and growing the
            # pool; the head finalizes removal once we're quiet
            # (reference: raylet drain — node_manager.h:551).
            self._draining = True
        elif mtype == "set_events_recording":
            # Cluster-wide flight-recorder toggle (gcs broadcast).
            _events.get_recorder().enabled = bool(msg.get("enabled", True))
        elif mtype == "fenced":
            # The head declared this node dead (partition false-death):
            # we are a zombie. Drain off the push-dispatch thread — the
            # fence kills workers and re-registers, both slow.
            threading.Thread(
                target=self._self_fence, name="raylet-fence", daemon=True
            ).start()
        elif mtype == "shutdown":
            self.shutdown()

    def _spawn_worker(self, msg):
        wid = WorkerID(msg["worker_id"])
        env = {
            "RAY_TPU_TORCH_WORKER_ID": wid.hex(),
            "RAY_TPU_TORCH_NODE_NS": self.node_ns,
            "PYTHONUNBUFFERED": "1",  # prints reach the log tailer live
            "RAY_TPU_TORCH_NODE_ID": self.node_id.hex(),
            # Chaos rule scoping: workers must not inherit this
            # daemon's "raylet" role marker (?role=worker rules would
            # never fire in daemon-spawned workers).
            "RAY_TPU_TORCH_CHAOS_ROLE": "worker",
            # Current flight-recorder toggle (this daemon tracks the
            # cluster-wide broadcast): a worker spawned after
            # `events --record off` must not silently resume recording.
            "RAY_TPU_TORCH_events_enabled": (
                "1" if _events.get_recorder().enabled else "0"
            ),
        }
        if msg.get("local_only"):
            env["RAY_TPU_TORCH_LOCAL_ONLY"] = "1"
        slots = msg.get("gpu_slots")
        if slots is None and msg.get("gpus"):
            # Head-routed GPU spawn: this daemon owns card identity on
            # its node — assign cards no live worker holds, so
            # head-scheduled and locally-leased workers never share one
            # unless fractional requests force it.
            with self._lock:
                slots = self._assign_gpus_locked(
                    wid.binary(), int(msg["gpus"]), share=True
                )
        if slots:
            GPUAcceleratorManager.set_visible_accelerator_ids(
                env, [self._gpu_ids[i] for i in slots]
            )
            with self._lock:
                self._gpu_slots_of[wid.binary()] = list(slots)
        os.makedirs(self.logs_dir, exist_ok=True)
        log_path = os.path.join(self.logs_dir, f"worker-{wid.hex()[:8]}.out")
        try:
            proc = self._spawner.spawn(
                env,
                log_path,
                gpu=bool(slots),
                # Even the cold-path Popen failed: tell the head, or its
                # W_STARTING entry (proc=None for remote spawns) would
                # hold the startup-cap slot and the claimed task forever.
                on_fail=lambda w=wid: self._report_spawn_failure(w),
            )
        except Exception:
            self._free_gpus(wid.binary())  # no process will hold them
            raise
        with self._lock:
            self._workers[wid.binary()] = proc

    def _report_spawn_failure(self, wid) -> None:
        try:
            self.conn.send(
                {"type": "worker_spawn_failed", "worker_id": wid.binary()}
            )
        except ConnectionLost:
            pass

    def _assign_gpus_locked(self, wid: bytes, n: int,
                            share: bool) -> Optional[List[int]]:
        """`n` GPU slots for worker `wid`: those no live worker holds,
        lowest first. Without enough free ones, None — or with `share`
        (head-routed spawns, whose GPU the head already accounted; a
        fractional request shares a card) the least-held ones. Never an
        unrestricted worker. Caller holds self._lock."""
        held = [0] * len(self._gpu_ids)
        for owner, slots in list(self._gpu_slots_of.items()):
            if self._gpu_owner_dead(owner):
                del self._gpu_slots_of[owner]
                continue
            for i in slots:
                held[i] += 1
        order = sorted(range(len(held)), key=lambda i: (held[i], i))[:n]
        if len(order) < n or (not share and any(held[i] for i in order)):
            return None
        self._gpu_slots_of[wid] = sorted(order)
        return sorted(order)

    def _gpu_owner_dead(self, wid: bytes) -> bool:
        """A slot holder is dead once its process exited. One with no
        process yet (a local worker still starting, or a head-routed one
        between its slots and its spawn) holds its slots."""
        if wid in self._workers:
            return self._worker_dead(wid)
        rec = self._local_workers.get(wid)
        return rec is not None and rec["state"] == "dead"

    def _worker_dead(self, wid: bytes) -> bool:
        proc = self._workers.get(wid)
        return proc is None or proc.poll() is not None

    def _free_gpus(self, wid: bytes):
        with self._lock:
            self._gpu_slots_of.pop(wid, None)

    def _kill_worker(self, wid: bytes):
        with self._lock:
            proc = self._workers.pop(wid, None)
        self._free_gpus(wid)
        if proc is not None:
            proc.terminate()

    # ----------------------------------------------------- local dispatch

    def _spawn_local_worker(self, wid: Optional[WorkerID] = None):
        """A worker this daemon leases out itself. It registers with the
        GCS as local_only (directory bookkeeping, never head-scheduled)
        and reports its direct socket back here via worker_hello.
        Callers growing the pool reserve the 'starting' record under the
        lock BEFORE spawning so concurrent denials can't overshoot the
        CPU cap."""
        if wid is None:
            wid = WorkerID(os.urandom(16))
            with self._lock:
                self._local_workers[wid.binary()] = {
                    "state": "starting", "addr": None, "proc": None,
                    "gpu": False, "gpu_slot": None,
                }
        with self._lock:
            rec0 = self._local_workers.get(wid.binary(), {})
            slot = rec0.get("gpu_slot")
        self._spawn_worker(
            {
                "worker_id": wid.binary(),
                "local_only": True,
                "gpu_slots": None if slot is None else [slot],
            }
        )
        with self._lock:
            rec = self._local_workers.get(wid.binary())
            if rec is not None:
                rec["proc"] = self._workers.get(wid.binary())

    def _lease_accept_loop(self):
        while not self._shutdown.is_set():
            try:
                conn = self._lease_listener.accept()
            except (OSError, EOFError):
                return
            except Exception:  # noqa: BLE001 - auth failure
                continue
            holder = {"held": set()}
            peer = PeerConn(
                conn,
                push_handler=lambda m, h=holder: self._on_lease_msg(h, m),
                on_close=lambda h=holder: self._on_lease_peer_close(h),
                name="raylet-lease",
                autostart=False,
                handshake=lambda c: transport.server_handshake(
                    c, self.authkey
                ),
            )
            holder["peer"] = peer
            peer.start()

    def _on_lease_peer_close(self, holder):
        # A client died (or closed) with outstanding local leases: free
        # them or the workers stay leased forever and the heartbeat sync
        # permanently drains this node's CPU view (mirror of the GCS's
        # held_leases sweep on peer close).
        for wid in holder.pop("held", set()):
            self._return_local_lease(wid)

    def _on_lease_msg(self, holder, msg):
        peer: PeerConn = holder["peer"]
        mtype = msg.get("type")
        if mtype == "worker_hello":
            with self._lock:
                rec = self._local_workers.get(msg["worker_id"])
                if rec is not None:
                    rec["addr"] = msg["direct_addr"]
                    rec["state"] = "idle"
            return
        if mtype == "lease_worker":
            if self._draining:
                try:
                    peer.reply(msg, ok=False)
                except ConnectionLost:
                    pass
                return
            wants_gpu = (msg.get("resources") or {}).get("GPU", 0) > 0
            granted = None
            spawn_wid = None
            with self._lock:
                for wid, rec in self._local_workers.items():
                    if rec["state"] == "idle" and bool(
                        rec.get("gpu")
                    ) == wants_gpu:
                        rec["state"] = "leased"
                        self._leased_count[
                            "gpu" if wants_gpu else "cpu"
                        ] += 1
                        granted = (wid, rec["addr"])
                        holder["held"].add(wid)
                        break
                if granted is None:
                    live = sum(
                        1
                        for r in self._local_workers.values()
                        if r["state"] != "dead"
                        and bool(r.get("gpu")) == wants_gpu
                    )
                    cap = int(
                        len(self._gpu_ids)
                        if wants_gpu
                        else self.resources.get("CPU", 0)
                    )
                    if live < cap:
                        # Reserve the slot under the lock so concurrent
                        # denials can't overshoot the cap. GPU workers
                        # get a dedicated card (slot index) so local
                        # leases never share a device.
                        w = WorkerID(os.urandom(16))
                        slot = None
                        if wants_gpu:
                            slots = self._assign_gpus_locked(
                                w.binary(), 1, share=False
                            )
                            slot = None if slots is None else slots[0]
                            if slot is None:
                                # All cards owned (e.g. by head-routed
                                # workers): deny; the GCS route queues.
                                try:
                                    peer.reply(msg, ok=False)
                                except ConnectionLost:
                                    pass
                                return
                        self._local_workers[w.binary()] = {
                            "state": "starting", "addr": None, "proc": None,
                            "gpu": wants_gpu, "gpu_slot": slot,
                        }
                        spawn_wid = w
            if granted is not None:
                _events.record(
                    _events.LEASE, granted[0].hex(), "GRANTED",
                    {"local": True},
                )
            try:
                if granted is not None:
                    peer.reply(msg, ok=True, worker_id=granted[0],
                               addr=granted[1])
                else:
                    peer.reply(msg, ok=False)
            except ConnectionLost:
                if granted is not None:
                    holder["held"].discard(granted[0])
                    self._return_local_lease(granted[0])
            if spawn_wid is not None:
                # Grow for the NEXT burst, off the request path — the
                # denied client falls back to the GCS route now instead
                # of waiting out a process spawn.
                threading.Thread(
                    target=self._spawn_local_worker, args=(spawn_wid,),
                    daemon=True,
                ).start()
            return
        if mtype == "return_lease":
            holder["held"].discard(msg["worker_id"])
            self._return_local_lease(msg["worker_id"])

    def _return_local_lease(self, wid: bytes):
        with self._lock:
            rec = self._local_workers.get(wid)
            if rec is not None and rec["state"] == "leased":
                rec["state"] = "idle"
                self._leased_count[
                    "gpu" if rec.get("gpu") else "cpu"
                ] -= 1
                _events.record(
                    _events.LEASE, wid.hex(), "RETURNED", {"local": True}
                )
            proc = rec.get("proc") if rec else None
        if proc is not None and proc.poll() is not None:
            with self._lock:
                if rec["state"] != "dead":
                    if rec["state"] == "leased":
                        self._leased_count[
                            "gpu" if rec.get("gpu") else "cpu"
                        ] -= 1
                    rec["state"] = "dead"

    # ------------------------------------------------------------ lifecycle

    def _sweep_pool_clients(self):
        """Reclaim segment refcounts held by dead clients.

        A SIGKILLed worker can't drain its per-client ledger, so the
        raylet (segment owner) sweeps on its heartbeat cadence: each
        registered pid is liveness-probed (kill(pid, 0)) and a dead
        client's ledger is subtracted from the global refcounts, with
        its unsealed partials freed — never sealed.  Runs under the
        segment's robust mutex in C; any thread may call it.
        """
        if self._pool is None:
            return
        try:
            swept = self._pool.sweep()
        except Exception:  # noqa: BLE001 - segment destroyed mid-shutdown
            self._pool_sweep_errors = getattr(
                self, "_pool_sweep_errors", 0
            ) + 1
            return
        if swept.get("clients_swept") and _events.enabled():
            _events.record(
                _events.OBJECT, self.node_id, "SHM_SWEEP", swept
            )

    def _heartbeat_loop(self):
        interval = RayConfig.health_check_period_ms / 1000.0
        while not self._shutdown.wait(interval):
            # Chaos: node death at the heartbeat boundary — the head
            # sees silence and must declare the node dead on its own
            # timer (gcs health loop), never on a clean disconnect.
            _chaos.kill_point("raylet.heartbeat")
            self._sweep_pool_clients()
            try:
                msg = {
                    "type": "node_heartbeat",
                    "node_id": self.node_id,
                    "incarnation": self.incarnation,
                    "local_cpus_in_use": float(
                        self._leased_count["cpu"]
                    ),
                    "local_gpus_in_use": float(
                        self._leased_count["gpu"]
                    ),
                }
                # Flight-recorder piggyback: this daemon's ring (local
                # lease grants, fork lifecycle) rides the heartbeat
                # that already flows — no extra message or timer.
                rec = _events.get_recorder()
                ev_items, ev_dropped = rec.attach(msg)
                try:
                    self.conn.send(msg)
                except ConnectionLost:
                    rec.count_lost(ev_items, ev_dropped)
                    raise
            except ConnectionLost:
                # Head may be restarting. The conn's own on_close drives
                # the rejoin; calling it here too is safe (reentrancy
                # guard) and covers a conn that died before its handler
                # was attached.
                self._on_gcs_close()
                continue

    def _on_gcs_close(self):
        # Head died (restarting) or network partition. Keep the daemon
        # AND its workers alive: each worker's CoreClient rides the
        # failover itself (reconnect + re-registration + reconcile), so
        # a head blip must not become a full node restart — running
        # tasks keep executing and re-claim on the restarted head
        # (reference: raylets re-register after NotifyGCSRestart;
        # workers only die when no restart ever arrives).
        if self._shutdown.is_set():
            return
        with self._lock:
            # One rejoin loop at a time: every closed conn (including
            # failed probes) fires its on_close on its own reader
            # thread; re-entering would race re-registration or exit a
            # daemon that already rejoined. A self-fence in flight owns
            # re-registration outright.
            if self._rejoining or self._fencing:
                return
            self._rejoining = True
        fenced = False
        try:
            deadline = time.time() + max(
                RayConfig.worker_register_timeout_s,
                RayConfig.gcs_reconnect_budget_s,
            )
            # Exponential backoff + jitter (the one shared policy):
            # every daemon in a fleet lost its head at the same
            # instant, and N synchronized 0.5s probes against a
            # restarting head is a reconnect stampede.
            backoff = _chaos.Backoff(base_s=0.25, cap_s=3.0)
            while time.time() < deadline and not self._shutdown.is_set():
                time.sleep(backoff.next_delay())
                try:
                    raw = transport.connect(self.gcs_address, self.authkey)
                except OSError:
                    continue
                # Probe conns carry no on_close; only a conn we promote
                # to self.conn gets the reconnect handler.
                conn = PeerConn(
                    raw,
                    push_handler=self._on_push,
                    name="raylet",
                )
                conn.peer_role = "head"
                try:
                    reply = conn.request(
                        {
                            "type": "register_node",
                            "node_id": self.node_id,
                            "resources": self.resources,
                            "transfer_addr": self.transfer.address,
                            "label": self.label or os.uname().nodename,
                            "pid": os.getpid(),
                        },
                        timeout=RayConfig.worker_register_timeout_s,
                    )
                except (ConnectionLost, TimeoutError, OSError):
                    conn.close()
                    continue
                if reply.get("ok"):
                    self.conn = conn
                    conn.set_on_close(self._on_gcs_close)
                    sys.stderr.write(
                        f"raylet {self.node_id.hex()[:8]}: rejoined head\n"
                    )
                    return
                conn.close()
                if reply.get("fenced"):
                    # The head declared this node_id dead while we were
                    # partitioned: this identity is burned. Stop probing
                    # with it — drain and re-register as a fresh
                    # incarnation instead.
                    fenced = True
                    break
        finally:
            with self._lock:
                self._rejoining = False
        if fenced:
            self._self_fence()
            return
        if not self._shutdown.is_set():
            self.shutdown()
            os._exit(0)

    def _self_fence(self):
        """Zombie drain (membership protocol): the head declared this
        node dead — its leases were released, its actors restarted
        elsewhere, its owned objects freed or promoted. Nothing this
        incarnation holds may act again: kill the worker pool, fence
        the shm segment out of the locate handshake, then rejoin
        through the NORMAL node-join path as a brand-new incarnation
        (fresh node_id, fresh workers). The daemon process survives —
        a partitioned fleet heals without an external restarter."""
        if self._shutdown.is_set():
            return
        with self._lock:
            if self._fencing:
                return
            self._fencing = True
        old = self.node_id
        _events.record(
            _events.HEAD, f"node-{old.hex()[:12]}", "ZOMBIE_SELF_FENCE",
            {"incarnation": self.incarnation},
        )
        try:
            # 1. The old incarnation's workers must not produce further
            # side effects: their results would be fenced head-side
            # anyway, but a zombie actor could still mutate external
            # state (files, services) on its own.
            with self._lock:
                workers = list(self._workers.values())
                self._workers.clear()
                self._local_workers.clear()
                self._leased_count = {"cpu": 0, "gpu": 0}
                self._gpu_slots_of.clear()
            for proc in workers:
                proc.terminate()
            deadline = time.time() + 2.0
            for proc in workers:
                try:
                    proc.wait(timeout=max(0.0, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    proc.kill()
            # 2. Invalidate shm adverts: no NEW pull may map the dead
            # incarnation's segment (the fleet may already have freed
            # or reconstructed those objects elsewhere).
            self.transfer.fence_shm()
            self.store.detach_pool()
            if self._pool is not None:
                try:
                    self._pool.destroy()
                except Exception:  # noqa: BLE001 - counted, never silent
                    self._fence_errors = getattr(
                        self, "_fence_errors", 0
                    ) + 1
                self._pool = None
            os.environ.pop("RAY_TPU_TORCH_POOL_NAME", None)
            # The fork-server zygote inherited the dead pool's name at
            # its first spawn; restart it so fresh-incarnation workers
            # boot on the per-object segment fallback.
            try:
                self._spawner.shutdown()
            except Exception:  # noqa: BLE001 - counted, never silent
                self._fence_errors = getattr(
                    self, "_fence_errors", 0
                ) + 1
            from .spawn import WorkerSpawner

            self._spawner = WorkerSpawner(dict(self._spawner_env))
            try:
                self.conn.close()
            except Exception:  # noqa: BLE001 - counted, never silent
                self._fence_errors = getattr(
                    self, "_fence_errors", 0
                ) + 1
            # 3. Re-register WITHOUT a node_id: the head mints a fresh
            # identity + incarnation, exactly as a cold node join.
            backoff = _chaos.Backoff(base_s=0.25, cap_s=3.0)
            deadline = time.time() + max(
                RayConfig.worker_register_timeout_s,
                RayConfig.gcs_reconnect_budget_s,
            )
            while time.time() < deadline and not self._shutdown.is_set():
                time.sleep(backoff.next_delay())
                try:
                    raw = transport.connect(self.gcs_address, self.authkey)
                except OSError:
                    continue
                conn = PeerConn(
                    raw, push_handler=self._on_push, name="raylet"
                )
                conn.peer_role = "head"
                try:
                    reply = conn.request(
                        {
                            "type": "register_node",
                            "resources": self.resources,
                            "transfer_addr": self.transfer.address,
                            "label": self.label or os.uname().nodename,
                            "pid": os.getpid(),
                        },
                        timeout=RayConfig.worker_register_timeout_s,
                    )
                except (ConnectionLost, TimeoutError, OSError):
                    conn.close()
                    continue
                if not reply.get("ok"):
                    conn.close()
                    continue
                self.node_id = reply["node_id"]
                self.incarnation = reply.get("incarnation", 1)
                self.conn = conn
                conn.set_on_close(self._on_gcs_close)
                sys.stderr.write(
                    f"raylet: fenced; rejoined as "
                    f"{self.node_id.hex()[:8]} (incarnation "
                    f"{self.incarnation}, was {old.hex()[:8]})\n"
                )
                for _ in range(min(2, int(self.resources.get("CPU", 0)))):
                    self._spawn_local_worker()
                return
        finally:
            with self._lock:
                self._fencing = False
        if not self._shutdown.is_set():
            self.shutdown()
            os._exit(0)

    def shutdown(self):
        if self._shutdown.is_set():
            return
        self._shutdown.set()
        try:
            self._stop()
        finally:
            self._stopped.set()

    def _stop(self):
        if getattr(self, "_log_monitor", None) is not None:
            self._log_monitor.stop()
        with self._lock:
            workers = list(self._workers.values())
            self._workers.clear()
        for proc in workers:
            proc.terminate()
        deadline = time.time() + 2.0
        for proc in workers:
            try:
                proc.wait(timeout=max(0.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
        self._spawner.shutdown()
        self.transfer.shutdown()
        try:
            self.conn.close()
        except Exception:  # noqa: BLE001
            pass
        self.store.close()
        if self._pool is not None:
            try:
                self._pool.destroy()
            except Exception:  # noqa: BLE001
                pass

    def wait(self):
        """Block until shutdown (signal or GCS loss) has finished: a
        shutdown pushed by the head runs on a reader thread, and the
        process must not exit before it has destroyed the shm pool."""
        while not self._stopped.wait(0.5):
            pass


def main(argv=None):
    # Lock-order witness opt-in (env-inherited from the test driver):
    # install BEFORE the daemon builds its lock domains so raylet-side
    # orders (lease pool, heartbeat, transfer server) are witnessed.
    from . import lock_witness

    lock_witness.maybe_install()
    parser = argparse.ArgumentParser(description="ray_tpu_torch node daemon")
    parser.add_argument("--address", required=True, help="head GCS host:port")
    parser.add_argument("--authkey", default=None, help="cluster auth key (hex)")
    parser.add_argument("--resources", default="{}", help="JSON resource dict")
    parser.add_argument("--num-cpus", type=float, default=None)
    parser.add_argument("--num-gpus", type=int, default=None)
    parser.add_argument("--label", default="")
    parser.add_argument(
        "--transfer-host",
        default=None,
        help="host for the object transfer listener (default: node IP)",
    )
    args = parser.parse_args(argv)

    # Chaos rule scoping (?role=raylet) + rebuild the schedule now that
    # the role marker is set (the import-time install saw "driver").
    os.environ["RAY_TPU_TORCH_CHAOS_ROLE"] = "raylet"
    _chaos.refresh()

    authkey = bytes.fromhex(
        args.authkey or os.environ.get("RAY_TPU_TORCH_AUTHKEY", "")
    )
    resources = json.loads(args.resources)
    if "CPU" not in resources:
        from .node import default_resources

        resources = {
            **default_resources(
                num_cpus=args.num_cpus,
                num_gpus=args.num_gpus,
            ),
            **resources,
        }
    daemon = NodeDaemon(
        args.address,
        authkey,
        resources,
        label=args.label,
        transfer_host=args.transfer_host or transport.node_ip(),
    )

    def on_signal(signum, frame):
        # A shutdown the head pushed may already be running on a reader
        # thread, and then this call returns at once: the process exits
        # only once that one has destroyed the shm pool, so wait for it
        # before leaving (the reference exits here at once and leaves
        # the pool behind).
        daemon.shutdown()
        daemon.wait()
        sys.exit(0)

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    sys.stderr.write(
        f"ray_tpu_torch node daemon up: node_id={daemon.node_id.hex()[:8]} "
        f"transfer={daemon.transfer.address}\n"
    )
    daemon.wait()


if __name__ == "__main__":
    main()
