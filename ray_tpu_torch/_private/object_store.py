"""Shared-memory object store (plasma equivalent).

The reference embeds a plasma store in the raylet: mmap arenas + dlmalloc,
a unix-socket flatbuffers protocol, and fd passing (reference:
src/ray/object_manager/plasma/store.h, plasma_allocator.h, fling.cc).
On one host we get the same zero-copy property directly from POSIX shared
memory: each sealed object is one named shm segment; any process on the
node maps it read-only and deserializes with zero-copy memoryviews over
the mapping. Naming is content-addressed by ObjectID so there is no fd
passing or allocation protocol to speak — the control plane only carries
(object_id, segment_name, size) metadata.

Objects are immutable once sealed, matching plasma semantics.
"""
from __future__ import annotations

import errno
import os
import struct
import threading
import time
import zlib
from multiprocessing import shared_memory, resource_tracker
from typing import Any, Dict, Optional, Tuple

from . import events as _events
from . import serialization
from .ids import ObjectID


def _untrack(shm: shared_memory.SharedMemory) -> None:
    # The per-process resource tracker would unlink segments when *any*
    # process exits and warn about "leaks"; lifetime is owned by the
    # session (GCS frees segments on ref-count zero / shutdown) instead.
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception:
        pass


def spill_path(spill_dir: str, object_id: ObjectID) -> str:
    """Canonical on-disk location of a spilled object — shared by the
    GCS spiller and the transfer plane's restore fallback."""
    return os.path.join(spill_dir, object_id.hex() + ".bin")


# ------------------------------------------------------------ spill files
#
# Spill files carry a validated header so a truncated or bit-flipped
# file can never restore as silently wrong bytes (reference: the
# external storage layer checksums spilled URLs,
# local_object_manager.h:100). Writes are crash-atomic: temp file +
# fsync + rename, so a daemon dying mid-spill leaves either no file or
# a complete one — never a half-written path the directory points at.

SPILL_MAGIC = b"RTPUSPL1"
_SPILL_HDR = struct.Struct("<8sQI")  # magic, payload size, crc32
SPILL_HEADER_BYTES = _SPILL_HDR.size


class SpillCorruptionError(Exception):
    """A spill file failed header/size/checksum validation. The object
    is treated as LOST (reconstruct from lineage), never served."""


def write_spill_file(spill_dir: str, object_id: ObjectID, raw) -> str:
    """Atomically persist one sealed object's serialized bytes.

    Chaos fault points (io_error:spill_write, disk_full:spill,
    truncate:spill_file) inject the storage failures the degradation
    ladder must absorb; the truncate fires AFTER the rename — the write
    "succeeds" but the file is short, exactly what a torn disk leaves."""
    from . import chaos as _chaos

    if _chaos.fault_point("io_error:spill_write"):
        raise OSError(errno.EIO, "chaos: injected spill write error")
    if _chaos.fault_point("disk_full:spill"):
        raise OSError(errno.ENOSPC, "chaos: injected disk full")
    os.makedirs(spill_dir, exist_ok=True)
    path = spill_path(spill_dir, object_id)
    # Unique per writer: two threads spilling one object must not
    # truncate each other's temp file mid-fsync (the rename would
    # publish a short file as the only copy).
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    # No intermediate copy: crc32 and write() take the buffer directly
    # (a 1 GiB spill must not allocate a second gigabyte).
    view = raw if isinstance(raw, (bytes, bytearray, memoryview)) \
        else memoryview(raw)
    size = len(view)
    header = _SPILL_HDR.pack(
        SPILL_MAGIC, size, zlib.crc32(view) & 0xFFFFFFFF
    )
    try:
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(view)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if _chaos.fault_point("truncate:spill_file"):
        with open(path, "r+b") as f:
            f.truncate(SPILL_HEADER_BYTES + size // 2)
    return path


def spill_file_meta(path: str) -> Tuple[int, int]:
    """(payload_size, crc32) from a spill file's header, validating the
    magic and that the file length matches the recorded size — the
    cheap check every restore makes before serving a single byte."""
    with open(path, "rb") as f:
        header = f.read(SPILL_HEADER_BYTES)
    if len(header) < SPILL_HEADER_BYTES:
        raise SpillCorruptionError(f"spill file truncated in header: {path}")
    magic, size, crc = _SPILL_HDR.unpack(header)
    if magic != SPILL_MAGIC:
        raise SpillCorruptionError(f"spill file bad magic: {path}")
    actual = os.path.getsize(path) - SPILL_HEADER_BYTES
    if actual != size:
        raise SpillCorruptionError(
            f"spill file truncated: {path} ({actual} != {size} bytes)"
        )
    return size, crc


def verify_spill_file(path: str) -> int:
    """Validate a spill file's header, size, and checksum WITHOUT
    materializing the payload (the crc streams in 1 MiB blocks) —
    for servers validating files they are about to serve by chunk.
    Returns the payload size; raises :class:`SpillCorruptionError`."""
    size, crc = spill_file_meta(path)
    running = 0
    remaining = size
    with open(path, "rb") as f:
        f.seek(SPILL_HEADER_BYTES)
        while remaining > 0:
            block = f.read(min(1 << 20, remaining))
            if not block:
                raise SpillCorruptionError(f"spill file short read: {path}")
            running = zlib.crc32(block, running)
            remaining -= len(block)
    if running & 0xFFFFFFFF != crc:
        raise SpillCorruptionError(f"spill file checksum mismatch: {path}")
    return size


def read_spill_file(path: str) -> bytes:
    """The validated payload of a spill file; raises
    :class:`SpillCorruptionError` on any header/size/checksum mismatch
    (and plain OSError when the file is gone)."""
    size, crc = spill_file_meta(path)
    with open(path, "rb") as f:
        f.seek(SPILL_HEADER_BYTES)
        payload = f.read(size)
    if len(payload) != size:
        raise SpillCorruptionError(f"spill file short read: {path}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise SpillCorruptionError(f"spill file checksum mismatch: {path}")
    return payload


def segment_name(object_id: ObjectID) -> str:
    # Namespaced per node so two node daemons colocated on one machine
    # (tests, multi-daemon hosts) don't see each other's segments through
    # the shared /dev/shm namespace — cross-node reads must go through
    # the object transfer plane, as on a real multi-host cluster.
    ns = os.environ.get("RAY_TPU_TORCH_NODE_NS", "")
    return f"rtpt_{ns}{object_id.hex()}"


class ObjectStore:
    """Node-local store of sealed objects; one instance per process.

    Fast path: the C++ pool store (native/store.cpp — one shm pool,
    boundary-tag allocator, shared refcounts, LRU eviction) attached by
    every process on the node via $RAY_TPU_TORCH_POOL_NAME. Fallback (no
    toolchain / pool full / oversized object): one shm segment per
    object, as before. Values returned by ``get`` hold zero-copy views
    into the mapping; mappings/refcounts are retained until ``release``.
    """

    def __init__(self):
        self._segments: Dict[str, shared_memory.SharedMemory] = {}
        self._lock = threading.Lock()
        self._pool = None
        self._pool_refs: Dict[bytes, int] = {}  # oid -> get() refcount held
        self._raw_creates: set = set()  # oids mid-transfer in the pool
        pool_name = os.environ.get("RAY_TPU_TORCH_POOL_NAME")
        if pool_name:
            try:
                from .native_store import PoolStore, native_available

                if native_available():
                    self._pool = PoolStore(pool_name, create=False)
            except Exception:  # noqa: BLE001 - fall back to segments
                self._pool = None

    def put(self, object_id: ObjectID, value: Any) -> Tuple[str, int]:
        """Serialize and seal a value; returns (location, size)."""
        payload, buffers = serialization.dumps(value)
        size = serialization.serialized_size(payload, buffers)
        return self.put_serialized(object_id, payload, buffers, size), size

    def _pool_create_backpressured(self, key: bytes, size: int):
        """pool.create with the degradation ladder: a full pool blocks
        the put (bounded by ``put_backpressure_timeout_s``) so the spill
        rung can free space, instead of falling straight off to an
        unbounded per-object segment (reference: plasma creates queue
        under pressure rather than failing immediately). Returns the
        writable view, or None when the object already exists, can never
        fit, or the deadline passed (callers then take the segment
        fallback — and only ITS failure surfaces OutOfMemoryError)."""
        from . import chaos as _chaos
        from .config import RayConfig

        view = self._pool.create(key, max(size, 1))
        if view is not None or self._pool.contains(key):
            return view
        # Full pool: before blocking, reclaim refcounts (and partials)
        # left by SIGKILLed clients — a dead reader may be the only
        # thing pinning evictable space.
        try:
            if self._pool.sweep().get("clients_swept"):
                view = self._pool.create(key, max(size, 1))
                if view is not None or self._pool.contains(key):
                    return view
        except Exception:  # noqa: BLE001 - store mid-close
            self._sweep_errors = getattr(self, "_sweep_errors", 0) + 1
        try:
            st = self._pool.stats()
            cap = st.get("pool_size") or st.get("arena_size") or 0
        except Exception:  # noqa: BLE001 - store mid-close
            return None
        if not cap or size >= cap:
            return None  # can never fit: segment fallback immediately
        deadline = time.monotonic() + float(
            RayConfig.put_backpressure_timeout_s
        )
        backoff = _chaos.Backoff(base_s=0.01, cap_s=0.25)
        waited = False
        t0 = time.monotonic()
        last_in_use = st.get("bytes_in_use", 0)
        stalls = 0
        while time.monotonic() < deadline:
            time.sleep(min(backoff.next_delay(),
                           max(0.0, deadline - time.monotonic())))
            waited = True
            view = self._pool.create(key, max(size, 1))
            if view is not None or self._pool.contains(key):
                break
            # Blocking only helps if someone is actually freeing pool
            # space (the head's spill rung; a releasing reader). Daemon
            # nodes run no spiller, and a pool full of live objects
            # never drains — detect the stall (in-use bytes not
            # falling) and take the segment fallback early instead of
            # sleeping out the whole deadline.
            try:
                in_use = self._pool.stats().get("bytes_in_use", 0)
            except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- store mid-close: the put takes the segment fallback at once
                break
            stalls = stalls + 1 if in_use >= last_in_use else 0
            last_in_use = min(last_in_use, in_use)
            if stalls >= 4 and time.monotonic() - t0 > 0.6:
                break
        if waited and _events.enabled():
            _events.record(
                _events.OBJECT, ObjectID(key).hex()[:12], "PUT_BACKPRESSURE",
                {"bytes": size, "admitted": view is not None},
            )
        return view

    def put_serialized(self, object_id: ObjectID, payload, buffers, size) -> str:
        """Write an already-serialized value; returns its location name."""
        _rec = _events.get_recorder()
        if self._pool is not None:
            view = self._pool_create_backpressured(object_id.binary(), size)
            if view is not None:
                serialization.write_to(view, payload, buffers)
                del view
                self._pool.seal(object_id.binary())
                if _rec.enabled:
                    _rec.record(
                        _events.OBJECT, object_id.hex(), "SEALED",
                        {"size": size, "loc": "pool"},
                    )
                return "pool"
        name = segment_name(object_id)
        shm = self._create_segment(name, size)
        serialization.write_to(shm.buf, payload, buffers)
        with self._lock:
            self._segments[name] = shm
        if _rec.enabled:
            _rec.record(
                _events.OBJECT, object_id.hex(), "SEALED",
                {"size": size, "loc": "segment"},
            )
        return name

    @property
    def has_pool(self) -> bool:
        """True when this process is attached to the node's shm pool."""
        return self._pool is not None

    def shm_source(self, object_id: ObjectID):
        """(pool_name, size) when the sealed object lives in the node
        pool — the name another process on this host maps to read the
        payload without a socket. None for segment/spilled holders
        (rare: pool-full fallbacks), which serve chunked TCP instead."""
        if self._pool is None:
            return None
        key = object_id.binary()
        try:
            view = self._pool.get(key)
            if view is None:
                return None
            size = len(view)
            del view
            self._pool.release(key)
        except Exception:  # noqa: BLE001 - pool mid-close
            self._sweep_errors = getattr(self, "_sweep_errors", 0) + 1
            return None
        return (self._pool.name, size)

    def try_pool_put_packed(self, object_id: ObjectID, blob) -> Optional[str]:
        """Best-effort pool write of already-flat serialized bytes: no
        backpressure, no segment fallback. Used for small puts whose
        advert would otherwise inline-only through the head — the pool
        copy is the local bearer of truth a head failover reconciles
        from, and what same-host readers hit with zero RPCs. Returns
        "pool" or None (caller keeps the inline-only path)."""
        if self._pool is None:
            return None
        key = object_id.binary()
        view = self._pool.create(key, max(len(blob), 1))
        if view is None:
            # Duplicate put of the same id: already sealed with these
            # bytes (ids are unique per value). Full pool: None.
            return "pool" if self._pool.contains(key) else None
        view[: len(blob)] = blob
        del view
        self._pool.seal(key)
        return "pool"

    def put_packed(self, object_id: ObjectID, blob) -> str:
        """Write already-flat serialized bytes (the wire/store format)
        verbatim; returns the location name. Lets a proxy store a
        remote driver's value without deserializing it."""
        size = max(len(blob), 1)
        if self._pool is not None:
            view = self._pool_create_backpressured(object_id.binary(), size)
            if view is not None:
                view[: len(blob)] = blob
                del view
                self._pool.seal(object_id.binary())
                return "pool"
        name = segment_name(object_id)
        shm = self._create_segment(name, size)
        shm.buf[: len(blob)] = blob
        with self._lock:
            self._segments[name] = shm
        return name

    def _create_segment(self, name: str, size: int) -> shared_memory.SharedMemory:
        """Segment-fallback create. This is the LAST rung of the put
        ladder (pool admission + backpressure already had their turn):
        an ENOSPC here means the node genuinely cannot hold the object,
        which surfaces as OutOfMemoryError — never a raw OSError killing
        the caller's control loop."""
        try:
            shm = shared_memory.SharedMemory(
                name=name, create=True, size=max(size, 1)
            )
        except OSError as e:
            if e.errno in (errno.ENOSPC, errno.ENOMEM):
                from ..exceptions import OutOfMemoryError

                raise OutOfMemoryError(
                    f"object store full: cannot allocate {size} bytes "
                    "(pool backpressured and /dev/shm exhausted)"
                ) from e
            raise
        _untrack(shm)
        return shm

    def get(self, object_id: ObjectID) -> Any:
        """Map and deserialize a sealed object (zero-copy buffers)."""
        if self._pool is not None:
            view = self._pool.get(object_id.binary())
            if view is not None:
                with self._lock:
                    self._pool_refs[object_id.binary()] = (
                        self._pool_refs.get(object_id.binary(), 0) + 1
                    )
                return serialization.unpack(view)
        name = segment_name(object_id)
        with self._lock:
            shm = self._segments.get(name)
            if shm is None:
                shm = shared_memory.SharedMemory(name=name)
                _untrack(shm)
                self._segments[name] = shm
        return serialization.unpack(shm.buf)

    def contains(self, object_id: ObjectID) -> bool:
        if self._pool is not None and self._pool.contains(object_id.binary()):
            return True
        name = segment_name(object_id)
        with self._lock:
            if name in self._segments:
                return True
        try:
            shm = shared_memory.SharedMemory(name=name)
            _untrack(shm)
            with self._lock:
                self._segments[name] = shm
            return True
        except FileNotFoundError:
            return False

    def location_of(self, object_id: ObjectID) -> Optional[str]:
        """Directory location name for a sealed object this process can
        see ("pool" or the shm segment name), or None when absent.
        Used by head-failover reconciliation: a reconnecting owner
        re-advertises where its objects live so a restarted head can
        rebuild the (non-durable) location table from bearers of
        truth."""
        if self._pool is not None and self._pool.contains(object_id.binary()):
            return "pool"
        name = segment_name(object_id)
        with self._lock:
            if name in self._segments:
                return name
        try:
            shm = shared_memory.SharedMemory(name=name)
            _untrack(shm)
            with self._lock:
                self._segments[name] = shm
            return name
        except FileNotFoundError:
            return None

    # ------------------------------------------------------ raw byte access
    # The transfer plane (object_transfer.py) moves objects between nodes
    # as raw serialized bytes; these methods expose the stored
    # representation without deserializing.

    def get_raw(self, object_id: ObjectID) -> Optional[memoryview]:
        """A view of the exact serialized bytes, or None if absent.
        Pin released with release_raw()."""
        if self._pool is not None:
            view = self._pool.get(object_id.binary())
            if view is not None:
                with self._lock:
                    self._pool_refs[object_id.binary()] = (
                        self._pool_refs.get(object_id.binary(), 0) + 1
                    )
                return view
        name = segment_name(object_id)
        with self._lock:
            shm = self._segments.get(name)
        if shm is None:
            try:
                shm = shared_memory.SharedMemory(name=name)
            except FileNotFoundError:
                return None
            _untrack(shm)
            with self._lock:
                self._segments[name] = shm
        try:
            return shm.buf[: serialization.total_size(shm.buf)]
        except ValueError:
            return None  # unsealed/corrupt

    def release_raw(self, object_id: ObjectID) -> None:
        if self._pool is not None:
            with self._lock:
                n = self._pool_refs.get(object_id.binary(), 0)
                if n > 0:
                    self._pool_refs[object_id.binary()] = n - 1
                    if n == 1:
                        del self._pool_refs[object_id.binary()]
            if n > 0:
                self._pool.release(object_id.binary())

    def create_raw(self, object_id: ObjectID, size: int) -> Optional[memoryview]:
        """Writable view for an incoming transfer; seal_raw() when full.
        Returns None if the object already exists locally."""
        if self._pool is not None:
            view = self._pool.create(object_id.binary(), max(size, 1))
            if view is not None:
                with self._lock:
                    self._raw_creates.add(object_id.binary())
                return view
            if self._pool.contains(object_id.binary()):
                return None
        name = segment_name(object_id)
        with self._lock:
            if name in self._segments:
                return None
        try:
            shm = shared_memory.SharedMemory(name=name, create=True, size=max(size, 1))
        except FileExistsError:
            return None
        _untrack(shm)
        with self._lock:
            self._segments[name] = shm
        return shm.buf[:size]

    def seal_raw(self, object_id: ObjectID) -> None:
        if self._pool is not None:
            with self._lock:
                was_pool = object_id.binary() in self._raw_creates
                self._raw_creates.discard(object_id.binary())
            if was_pool:
                self._pool.seal(object_id.binary())
        # Segment path: visible by name once created; nothing to do.

    def abort_raw(self, object_id: ObjectID) -> None:
        """Drop a partially-transferred object."""
        if self._pool is not None:
            with self._lock:
                was_pool = object_id.binary() in self._raw_creates
                self._raw_creates.discard(object_id.binary())
            if was_pool:
                # Seal then delete: delete only works on table entries and
                # the creator's ref is dropped by seal.
                self._pool.seal(object_id.binary())
                self._pool.delete(object_id.binary())
                return
        name = segment_name(object_id)
        with self._lock:
            shm = self._segments.pop(name, None)
        if shm is not None:
            try:
                resource_tracker.register(shm._name, "shared_memory")  # noqa: SLF001
                shm.unlink()
                shm.close()
            except Exception:  # noqa: BLE001
                pass

    def release(self, object_id: ObjectID) -> None:
        """Drop this process's mapping/refcount (does not delete)."""
        if self._pool is not None:
            with self._lock:
                n = self._pool_refs.pop(object_id.binary(), 0)
            for _ in range(n):
                self._pool.release(object_id.binary())
            if n:
                return
        with self._lock:
            shm = self._segments.pop(segment_name(object_id), None)
        if shm is not None:
            try:
                shm.close()
            except BufferError:
                # Zero-copy views into the mapping are still alive somewhere;
                # keep the mapping rather than invalidate them.
                with self._lock:
                    self._segments[segment_name(object_id)] = shm

    def delete(self, object_id: ObjectID) -> None:
        """Unlink the object from the node (owner/GCS-driven).

        Refcounts this process holds (zero-copy views returned by get())
        are NOT dropped here: the C++ store defers the free until the
        last release, so live views stay valid until release()/close().
        """
        if self._pool is not None:
            self._pool.delete(object_id.binary())
        name = segment_name(object_id)
        with self._lock:
            shm = self._segments.pop(name, None)
        if shm is None:
            try:
                shm = shared_memory.SharedMemory(name=name)
                _untrack(shm)
            except FileNotFoundError:
                return
        try:
            # unlink() also unregisters with the resource tracker; re-register
            # first so the pair balances (we unregistered at create/attach).
            resource_tracker.register(shm._name, "shared_memory")  # noqa: SLF001
            shm.unlink()
        except FileNotFoundError:
            pass
        except Exception:
            pass
        try:
            shm.close()
        except BufferError:
            pass

    def detach_pool(self) -> None:
        """Drop the node-pool attachment, keeping the store usable on
        the per-object segment fallback. Used by the raylet's zombie
        self-fence: a declared-dead node's segment must stop backing
        new puts and shm adverts, but the daemon itself lives on as a
        fresh incarnation."""
        if self._pool is None:
            return
        with self._lock:
            refs = dict(self._pool_refs)
            self._pool_refs.clear()
        for oid, n in refs.items():
            for _ in range(n):
                try:
                    self._pool.release(oid)
                except Exception:  # noqa: BLE001 - counted, never silent
                    self._detach_errors = getattr(
                        self, "_detach_errors", 0
                    ) + 1
                    break
        try:
            self._pool.close()
        except Exception:  # noqa: BLE001 - counted, never silent
            self._detach_errors = getattr(self, "_detach_errors", 0) + 1
        self._pool = None

    def close(self) -> None:
        if self._pool is not None:
            # Drain held refcounts or the shared pool pins these objects
            # forever (refcounts live in shm, not this process).
            with self._lock:
                refs = dict(self._pool_refs)
                self._pool_refs.clear()
            for oid, n in refs.items():
                for _ in range(n):
                    try:
                        self._pool.release(oid)
                    except Exception:  # noqa: BLE001  # raylint: disable=swallowed-fault -- the pool is closing: its pins go with it
                        break
            try:
                self._pool.close()
            except Exception:  # noqa: BLE001
                pass
            self._pool = None
        with self._lock:
            segs = list(self._segments.values())
            self._segments.clear()
        for shm in segs:
            try:
                shm.close()
            except BufferError:
                # Zero-copy views still alive; leave the mapping to die with
                # the process and silence __del__'s close() retry.
                shm.close = lambda: None
            except Exception:
                pass
