"""Node-to-node object transfer: chunked pull over the data plane.

Reference: src/ray/object_manager/object_manager.h:63,117 — the object
manager transfers objects between nodes in 5 MiB chunks over gRPC, with
a pull manager deduplicating concurrent requests. Here each node daemon
(and the head) runs an ObjectTransferServer over its local store;
consumers pull missing objects chunk-by-chunk and seal them into their
own node pool. Objects are immutable once sealed, so a pulled replica
is always coherent; dedup of concurrent pulls of the same object is
done consumer-side in ObjectFetcher.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from . import chaos as _chaos
from . import events as _events
from . import transport
from .config import RayConfig
from .ids import ObjectID
from .object_store import ObjectStore
from .protocol import ConnectionLost, PeerConn

CHUNK_BYTES = 4 << 20  # reference: object_manager_default_chunk_size (5 MiB)
#: Per-attempt ceiling on one chunk request: a dropped request surfaces
#: as a timeout this fast and the pull retries with backoff instead of
#: burning the whole pull deadline waiting on one lost frame.
ATTEMPT_TIMEOUT_S = 10.0

#: Chaos role of the data plane: transfer-server conns (both ends) tag
#: their peer with this so a `throttle:raylet<->transfer=...` rule slows
#: chunk traffic without touching the control plane — a gray failure
#: (heartbeats keep flowing), not a partition.
TRANSFER_ROLE = "transfer"


class SlowProviderError(Exception):
    """One pull attempt measured below the hedged-pull throughput floor
    (pull_relead_floor_bytes_s) past the grace window: the consumer
    should re-lead onto a re-resolved holder instead of waiting out the
    straggler."""

    def __init__(self, size: int, bytes_per_s: float):
        super().__init__(f"pull below floor: {bytes_per_s:.0f} B/s")
        self.size = size
        self.bytes_per_s = bytes_per_s


def _host_id() -> str:
    """Identity of this physical host, stable across processes.

    boot_id distinguishes machines sharing an IP namespace; two
    containers on one kernel share it but not /dev/shm, which is fine —
    the shm attach just fails and the pull falls back to chunked TCP.
    """
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        import socket

        return socket.gethostname()


class ObjectTransferServer:
    """Serves raw object bytes from the node-local store.

    One listener per node; any peer (another node's worker, the driver,
    a daemon) connects and issues pull_chunk requests:

        {"type": "pull_chunk", "object_id": bytes, "offset": int}
          -> {"ok": True, "data": bytes, "size": total_size}
    """

    def __init__(self, store: ObjectStore, address: str, authkey: bytes):
        self._store = store
        self._authkey = authkey
        self._listener = transport.make_listener(address, authkey)
        self.address = transport.listener_address(self._listener)
        self._peers = []
        self._shutdown = False
        # Zombie fence (membership protocol): once the owning raylet
        # learns it was declared dead, its segment adverts are stale —
        # shm_locate must stop naming the pool so no NEW pull can map
        # a segment the fleet already considers gone. Chunk pulls keep
        # working: they copy bytes, they never hand out the mapping.
        self.shm_fenced = False
        # Spill files already checksum-verified by this server, keyed
        # (path, size, mtime_ns): spill files are immutable once
        # renamed into place, so one streaming CRC pass covers every
        # subsequent puller/retry instead of re-reading the whole file
        # per offset-0 request. Bounded FIFO.
        self._verified_spills: "Dict[Tuple[str, int, int], bool]" = {}
        self._thread = threading.Thread(
            target=self._accept_loop, name="obj-transfer-accept", daemon=True
        )
        self._thread.start()

    def _accept_loop(self):
        while not self._shutdown:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                break
            holder = {}
            peer = PeerConn(
                conn,
                push_handler=lambda msg, h=holder: self._handle(h["peer"], msg),
                name="obj-transfer",
                autostart=False,
                handshake=lambda c: transport.server_handshake(
                    c, self._authkey,
                    tcp=transport.is_tcp_address(self.address),
                ),
            )
            holder["peer"] = peer
            peer.peer_role = TRANSFER_ROLE
            self._peers.append(peer)
            peer.start()

    def _handle(self, peer: PeerConn, msg):
        if msg.get("type") == "shm_locate":
            # Same-host shortcut handshake: name the node segment that
            # holds the object so a consumer on THIS host can map it and
            # copy once — zero bytes over the socket. A consumer on
            # another host sees the host-id mismatch and pulls chunks.
            if self.shm_fenced:
                peer.reply(msg, ok=False, fenced=True,
                           error="provider fenced", host=_host_id())
                return
            src = self._store.shm_source(ObjectID(msg["object_id"]))
            if src is None:
                peer.reply(msg, ok=False, error="no shm source",
                           host=_host_id())
            else:
                peer.reply(msg, ok=True, host=_host_id(),
                           pool=src[0], size=src[1])
            return
        if msg.get("type") != "pull_chunk":
            if "req_id" in msg:
                peer.reply(msg, ok=False, error="unknown message")
            return
        oid = ObjectID(msg["object_id"])
        offset = msg.get("offset", 0)
        try:
            raw = self._store.get_raw(oid)
        except Exception as e:  # noqa: BLE001
            peer.reply(msg, ok=False, error=f"{type(e).__name__}: {e}")
            return
        if raw is None:
            # Restore rung: the object may have been spilled to disk on
            # this node; serve the file so cross-node pulls of spilled
            # objects still work (reference: spilled-object restore,
            # local_object_manager.h:100-110). The header is validated
            # before a single byte leaves — a truncated or corrupt spill
            # file answers "not found" (the consumer's get resolves
            # through lineage reconstruction), never garbage.
            import os

            from .object_store import (
                SPILL_HEADER_BYTES, SpillCorruptionError, spill_file_meta,
                spill_path, verify_spill_file,
            )

            spill_dir = os.environ.get("RAY_TPU_TORCH_SPILL_DIR", "")
            path = spill_path(spill_dir, oid) if spill_dir else ""
            try:
                if offset == 0:
                    # Full streaming checksum once per FILE (no
                    # payload-sized allocation): immutable spill files
                    # verify on their first offset-0 request and later
                    # pulls/retries hit the verified cache; non-zero
                    # offsets re-check only the cheap size header.
                    st = os.stat(path)
                    ck = (path, st.st_size, st.st_mtime_ns)
                    if ck in self._verified_spills:
                        size, _crc = spill_file_meta(path)
                    else:
                        size = verify_spill_file(path)
                        if len(self._verified_spills) >= 1024:
                            self._verified_spills.pop(
                                next(iter(self._verified_spills))
                            )
                        self._verified_spills[ck] = True
                else:
                    size, _crc = spill_file_meta(path)
                with open(path, "rb") as f:
                    f.seek(SPILL_HEADER_BYTES + offset)
                    data = f.read(CHUNK_BYTES)
                peer.reply(msg, ok=True, data=data, size=size)
            except SpillCorruptionError as e:
                peer.reply(msg, ok=False, error=f"spill corrupt: {e}")
            except OSError:
                peer.reply(msg, ok=False, error="object not found")
            return
        try:
            size = len(raw)
            data = bytes(raw[offset : offset + CHUNK_BYTES])
            peer.reply(msg, ok=True, data=data, size=size)
        finally:
            self._store.release_raw(oid)

    def fence_shm(self):
        """Permanently stop answering shm_locate with this node's pool
        (zombie self-fence). Not reversible: the re-registered
        incarnation runs on per-object segments (or a fresh daemon)."""
        self.shm_fenced = True

    def shutdown(self):
        self._shutdown = True
        try:
            self._listener.close()
        except Exception:  # noqa: BLE001
            pass
        for p in self._peers:
            p.close()


class ObjectFetcher:
    """Pulls remote objects into the local store (consumer side).

    Connections to remote transfer servers are cached per address;
    concurrent pulls of the same object are deduplicated so the chunks
    cross the wire once (reference: PullManager dedup, pull_manager.h:52).
    """

    def __init__(self, store: ObjectStore, authkey: bytes):
        self._store = store
        self._authkey = authkey
        self._conns: Dict[str, PeerConn] = {}
        self._lock = threading.Lock()
        self._inflight: Dict[bytes, threading.Event] = {}
        # Same-host shortcut state: provider address -> its host id
        # (learned on the first shm_locate; remote hosts are never asked
        # again), and provider pool name -> our read-only attachment.
        self._peer_hosts: Dict[str, str] = {}
        self._peer_pools: Dict[str, object] = {}
        # Counted-never-silent shortcut faults (attach/copy/teardown
        # races degrade to the TCP pull, but the count must exist).
        self._shm_pull_failed = 0

    def _conn_for(self, address: str) -> PeerConn:
        with self._lock:
            peer = self._conns.get(address)
            if peer is not None and not peer.closed:
                return peer
        raw = transport.connect(address, self._authkey)
        peer = PeerConn(raw, push_handler=lambda m: None, name="obj-fetch")
        peer.peer_role = TRANSFER_ROLE
        with self._lock:
            existing = self._conns.get(address)
            if existing is not None and not existing.closed:
                peer.close()
                return existing
            self._conns[address] = peer
        return peer

    def _drop_conn(self, address: str) -> None:
        """Forget a cached transfer conn (failed attempt: reconnect)."""
        with self._lock:
            peer = self._conns.pop(address, None)
        if peer is not None:
            peer.close()

    def pull(self, oid: ObjectID, address: str, timeout: Optional[float] = 60.0,
             resolve=None) -> bool:
        """Fetch the object from `address` into the local store.

        Transient failures (lost/timed-out chunk request, dropped conn)
        retry with exponential backoff + jitter until ``timeout``
        (reference: PullManager retries pulls on a timer,
        pull_manager.h); a definitive "object not found" fails fast so
        directory re-lookup/reconstruction can run instead.

        ``resolve``, when given, is called with the current (slow)
        provider address after an attempt falls below the hedged-pull
        throughput floor; it returns a fresh address to re-lead onto
        (or None to stay). The re-lead happens INSIDE this one call, so
        an admission-controlled caller charges its byte budget once.

        Returns True when the object is locally readable afterwards."""
        key = oid.binary()
        with self._lock:
            ev = self._inflight.get(key)
            if ev is None:
                self._inflight[key] = ev = threading.Event()
                leader = True
            else:
                leader = False
        if not leader:
            ev.wait(timeout)
            return self._store.contains(oid)
        try:
            if self._store.contains(oid):
                return True
            _rec = _events.get_recorder()
            t0 = time.time()
            deadline = time.monotonic() + (timeout or 60.0)
            backoff = _chaos.Backoff(base_s=0.05, cap_s=2.0)
            ok, size, attempts = False, 0, 0
            # Providers already flagged slow: when the re-lead resolves
            # back to the same (sole) holder, the next attempt runs
            # with the floor DISABLED — a slow pull beats a livelock of
            # aborted attempts.
            slow_addrs: set = set()
            while True:
                attempts += 1
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    ok, size = self._try_shm_pull(
                        oid, address, min(remaining, ATTEMPT_TIMEOUT_S)
                    )
                    if ok:
                        break
                    ok, size, transient = self._pull_chunks(
                        oid, address, min(remaining, ATTEMPT_TIMEOUT_S),
                        floor_enabled=address not in slow_addrs,
                    )
                except SlowProviderError as slow:
                    slow_addrs.add(address)
                    # Hedged pull: this holder is a straggler, not dead.
                    # Re-lead onto a re-resolved holder immediately (no
                    # backoff — the bytes so far were arriving, just too
                    # slowly to wait out).
                    self._drop_conn(address)
                    if _rec.enabled:
                        _rec.record(
                            _events.REFS, oid.hex(), "PULL_RELEAD",
                            {
                                "addr": address,
                                "bytes_s": round(slow.bytes_per_s),
                                "attempt": attempts,
                            },
                        )
                    if resolve is not None:
                        fresh = resolve(address)
                        if fresh:
                            address = fresh
                    continue
                except (ConnectionLost, OSError):
                    ok, size, transient = False, 0, True
                if ok or not transient:
                    break
                # Reconnect next attempt: the conn may be the casualty.
                self._drop_conn(address)
                if _rec.enabled:
                    _rec.record(
                        _events.TRANSFER, oid.hex(), "PULL_RETRY",
                        {"attempt": attempts, "from": address},
                    )
                delay = min(
                    backoff.next_delay(),
                    max(0.0, deadline - time.monotonic()),
                )
                if delay > 0:
                    time.sleep(delay)
            if _rec.enabled:
                _rec.record(
                    _events.TRANSFER, oid.hex(), "PULL",
                    {
                        "ok": ok, "seconds": time.time() - t0,
                        "from": address, "bytes": size,
                        "attempts": attempts,
                    },
                )
            return ok
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()

    def _try_shm_pull(self, oid: ObjectID, address: str, timeout) -> Tuple[bool, int]:
        """Same-host pull through the provider's node segment: map its
        pool by name and copy the payload once — zero socket bytes for
        the data plane, so an n-worker same-host broadcast is one copy
        per node instead of n socket round-trips of the full payload.
        Returns (pulled, size); any miss (remote host, pool-less
        provider, attach failure, raced eviction) falls back to the
        chunked TCP pull. Never raises."""
        import concurrent.futures

        if RayConfig.transfer_force_tcp:
            # Testing hook: the straggler soak throttles the chunked
            # data plane at the PeerConn boundary; the shm shortcut
            # moves zero socket bytes and would bypass it.
            return False, 0
        known = self._peer_hosts.get(address)
        me = _host_id()
        if known is not None and known != me:
            return False, 0  # provider is on another machine: TCP
        try:
            peer = self._conn_for(address)
            reply = peer.request(
                {"type": "shm_locate", "object_id": oid.binary()},
                timeout=timeout,
            )
        except (ConnectionLost, OSError, TimeoutError,
                concurrent.futures.TimeoutError):
            return False, 0
        host = reply.get("host")
        if host:
            self._peer_hosts[address] = host
        if host != me or not reply.get("ok"):
            return False, 0
        pool_name, size = reply["pool"], reply["size"]
        key = oid.binary()
        try:
            pool = self._peer_pools.get(pool_name)
            if pool is None:
                from .native_store import PoolStore, native_available

                if not native_available():
                    return False, 0
                pool = PoolStore(pool_name, create=False)
                self._peer_pools[pool_name] = pool
            src = pool.get(key)  # pins against provider-side delete
        except Exception:  # noqa: BLE001 - foreign /dev/shm namespace
            self._shm_pull_failed += 1
            self._peer_pools.pop(pool_name, None)
            self._peer_hosts[address] = f"!{host}"  # never retry attach
            return False, 0
        if src is None:
            return False, 0  # raced eviction/spill: TCP path re-resolves
        try:
            view = self._store.create_raw(oid, size)
            if view is None:
                return self._store.contains(oid), size
            try:
                view[:size] = src[:size]
                del view
            except Exception:  # noqa: BLE001 - reclaim the partial
                self._shm_pull_failed += 1
                del view
                self._store.abort_raw(oid)
                return False, 0
            self._store.seal_raw(oid)
        finally:
            del src
            try:
                pool.release(key)
            except Exception:  # noqa: BLE001 - pool torn down mid-copy
                self._shm_pull_failed += 1
                self._peer_pools.pop(pool_name, None)
        rec = _events.get_recorder()
        if rec.enabled:
            rec.record(
                _events.TRANSFER, oid.hex(), "SHM_PULL",
                {"from": address, "bytes": size, "pool": pool_name},
            )
        return True, size

    def _pull_chunks(
        self, oid: ObjectID, address: str, timeout, floor_enabled: bool = True
    ) -> Tuple[bool, int, bool]:
        """One pull attempt. Returns (locally readable, size,
        transient) — transient=True means a retry may succeed (timeout,
        lost conn); False is definitive (object not found). Raises
        SlowProviderError when ``floor_enabled`` and measured
        throughput stays under pull_relead_floor_bytes_s past the
        grace window."""
        import concurrent.futures

        peer = self._conn_for(address)
        # The attempt clock starts BEFORE the first chunk request: on a
        # starved link the first chunk is where the pacing time goes,
        # and anchoring after it would let a two-chunk object finish
        # the loop inside the grace window without ever measuring.
        t_attempt = time.monotonic()
        try:
            first = peer.request(
                {"type": "pull_chunk", "object_id": oid.binary(), "offset": 0},
                timeout=timeout,
            )
        except (TimeoutError, concurrent.futures.TimeoutError):
            return False, 0, True
        if not first.get("ok"):
            return False, 0, False
        size = first["size"]
        view = self._store.create_raw(oid, size)
        if view is None:
            # Local store can't hold it (exists already counts as success).
            return self._store.contains(oid), size, False
        floor = RayConfig.pull_relead_floor_bytes_s if floor_enabled else 0
        grace = RayConfig.pull_relead_grace_s
        try:
            data = first["data"]
            view[: len(data)] = data
            offset = len(data)
            while offset < size:
                elapsed = time.monotonic() - t_attempt
                if floor and elapsed > grace:
                    rate = offset / elapsed
                    if rate < floor:
                        # Straggling provider: abandon this attempt's
                        # partial bytes (reclaimed) and let the caller
                        # re-lead onto another holder.
                        self._store.abort_raw(oid)
                        raise SlowProviderError(size, rate)
                # Chaos: "kill node mid-pull" — a consumer dying with a
                # half-written unsealed replica (the abort path must
                # reclaim it, and the producer side must shrug).
                _chaos.kill_point("transfer.mid_pull")
                reply = peer.request(
                    {
                        "type": "pull_chunk",
                        "object_id": oid.binary(),
                        "offset": offset,
                    },
                    timeout=timeout,
                )
                if not reply.get("ok"):
                    self._store.abort_raw(oid)
                    return False, size, False
                chunk = reply["data"]
                view[offset : offset + len(chunk)] = chunk
                offset += len(chunk)
        except (ConnectionLost, TimeoutError,
                concurrent.futures.TimeoutError):
            self._store.abort_raw(oid)
            return False, size, True
        finally:
            del view
        self._store.seal_raw(oid)
        return True, size, False

    def close(self):
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
            pools = list(self._peer_pools.values())
            self._peer_pools.clear()
        for c in conns:
            c.close()
        for p in pools:
            try:
                p.close()  # detach only — the provider owns the segment
            except Exception:  # noqa: BLE001 - already destroyed
                self._shm_pull_failed += 1
