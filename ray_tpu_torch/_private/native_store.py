"""ctypes bindings + pool-backed store over the C++ core.

The C++ library (the port's own `csrc/store.cpp`, built at first use
into `_native/`) owns allocation, the object table, refcounts, and LRU
eviction inside one shm pool; Python reads/writes payloads through a
zero-copy memoryview of the same mapping. Falls back to the pure-Python
store (native_available() False) if the library can't build;
`build_error` then holds the compiler's complaint.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "_native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libray_tpu_store.so")
_SRC = os.path.join(os.path.dirname(__file__), "csrc", "store.cpp")

_lib = None
_lib_lock = threading.Lock()
#: Why the last build failed (the compiler's stderr), or None.
build_error: Optional[str] = None


def _build() -> bool:
    global build_error
    os.makedirs(_NATIVE_DIR, exist_ok=True)
    # Build to a private name, then atomically publish (same pattern as
    # fastpath._build): a concurrent build in another cluster process
    # must never dlopen a half-written .so.
    tmp = f"{_LIB_PATH}.tmp.{os.getpid()}"
    try:
        subprocess.run(
            [
                "g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-Wall",
                "-o", tmp, _SRC, "-lpthread", "-lrt",
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        build_error = None
        return True
    except Exception as e:  # noqa: BLE001 - no toolchain → fallback store
        build_error = (getattr(e, "stderr", None) or b"").decode(errors="replace") or repr(e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)
        ):
            if not _build() and not os.path.exists(_LIB_PATH):
                return None
        lib = ctypes.CDLL(_LIB_PATH)
        lib.store_create.restype = ctypes.c_uint64
        lib.store_create.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_int32,
        ]
        lib.store_attach.restype = ctypes.c_uint64
        lib.store_attach.argtypes = [ctypes.c_char_p]
        lib.store_create_object.restype = ctypes.c_uint64
        lib.store_create_object.argtypes = [
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.store_seal.restype = ctypes.c_int32
        lib.store_seal.argtypes = [ctypes.c_uint64, ctypes.c_char_p]
        lib.store_get.restype = ctypes.c_int32
        lib.store_get.argtypes = [
            ctypes.c_uint64, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.store_contains.restype = ctypes.c_int32
        lib.store_contains.argtypes = [ctypes.c_uint64, ctypes.c_char_p]
        lib.store_release.restype = ctypes.c_int32
        lib.store_release.argtypes = [ctypes.c_uint64, ctypes.c_char_p]
        lib.store_delete.restype = ctypes.c_int32
        lib.store_delete.argtypes = [ctypes.c_uint64, ctypes.c_char_p]
        lib.store_register.restype = ctypes.c_int32
        lib.store_register.argtypes = [ctypes.c_uint64, ctypes.c_int32]
        lib.store_sweep.restype = ctypes.c_int32
        lib.store_sweep.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)
        ]
        lib.store_stats.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)
        ]
        lib.store_sweep_stats.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)
        ]
        lib.store_detach.argtypes = [ctypes.c_uint64]
        lib.store_destroy.restype = ctypes.c_int32
        lib.store_destroy.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    if os.environ.get("RAY_TPU_TORCH_NATIVE_STORE", "1") == "0":
        return False
    return get_lib() is not None


def default_pool_bytes() -> int:
    env = os.environ.get("RAY_TPU_TORCH_POOL_SIZE")
    if env:
        return int(env)
    try:
        st = os.statvfs("/dev/shm")
        avail = st.f_bavail * st.f_frsize
    except OSError:
        avail = 2 << 30
    return max(64 << 20, min(4 << 30, int(avail * 0.3)))


class PoolStore:
    """One process's view of the node pool."""

    def __init__(self, name: str, create: bool, pool_bytes: Optional[int] = None,
                 max_objects: int = 65536, evict: bool = False):
        """evict=False (default): a full pool fails creates and callers
        fall back to per-object segments — nothing pins
        client-referenced objects across processes yet, so LRU eviction
        could free data a live ObjectRef still names."""
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native store library unavailable")
        self.name = name
        self._lib = lib
        self._lock = threading.Lock()
        if create:
            self._h = lib.store_create(
                name.encode(), pool_bytes or default_pool_bytes(), max_objects,
                1 if evict else 0,
            )
        else:
            self._h = lib.store_attach(name.encode())
        if not self._h:
            raise RuntimeError(
                f"store_{'create' if create else 'attach'}({name}) failed"
            )
        self._owner = create
        # Register in the pool's client registry so this process's refs
        # are sweepable if it dies uncleanly (SIGKILL). -1 (registry
        # full) degrades to unregistered: refcounts still correct while
        # alive, just not crash-sweepable.
        self.client_slot = lib.store_register(self._h, os.getpid())
        # Map the pool in Python for zero-copy payload access.
        from multiprocessing import resource_tracker, shared_memory

        self._shm = shared_memory.SharedMemory(name=name)
        try:
            resource_tracker.unregister(self._shm._name, "shared_memory")  # noqa: SLF001
        except Exception:  # noqa: BLE001
            pass
        self.buf = self._shm.buf

    # ------------------------------------------------------------ objects
    # Every call into the library holds self._lock, as close() does to
    # detach: a call that checked the handle could otherwise run on a
    # store that close() had already freed (the reference checks without
    # a lock). Payloads are copied through the returned views, outside it.
    def create(self, object_id: bytes, size: int) -> Optional[memoryview]:
        """Returns a writable view of the payload, or None (full/exists/closed)."""
        err = ctypes.c_int32(0)
        with self._lock:
            if not self._h:
                return None
            off = self._lib.store_create_object(
                self._h, object_id, size, ctypes.byref(err)
            )
            if off == 0:
                return None
            return self.buf[off : off + size]

    def seal(self, object_id: bytes) -> bool:
        with self._lock:
            return bool(self._h) and self._lib.store_seal(self._h, object_id) == 0

    def get(self, object_id: bytes) -> Optional[memoryview]:
        """Read-side view; caller must release() when done with it."""
        off = ctypes.c_uint64(0)
        size = ctypes.c_uint64(0)
        with self._lock:
            if not self._h:
                return None
            rc = self._lib.store_get(
                self._h, object_id, ctypes.byref(off), ctypes.byref(size)
            )
            if rc != 0:
                return None
            return self.buf[off.value : off.value + size.value]

    def contains(self, object_id: bytes) -> bool:
        with self._lock:
            return bool(self._h) and self._lib.store_contains(self._h, object_id) == 1

    def release(self, object_id: bytes) -> None:
        with self._lock:
            if self._h:
                self._lib.store_release(self._h, object_id)

    def delete(self, object_id: bytes) -> None:
        with self._lock:
            if self._h:
                self._lib.store_delete(self._h, object_id)

    def _call(self, fn, n: int):
        """`fn(handle, out)` into n uint64s; after close() it raises, as
        a monitor thread racing shutdown must see an exception, not a
        native crash."""
        out = (ctypes.c_uint64 * n)()
        with self._lock:
            if not self._h:
                raise RuntimeError("store closed")
            fn(self._h, out)
        return out

    def stats(self) -> dict:
        out = self._call(self._lib.store_stats, 8)
        return {
            "arena_size": out[0],
            "bytes_in_use": out[1],
            "num_objects": out[2],
            "num_evictions": out[3],
            "bytes_evicted": out[4],
            "pool_size": out[5],
            "max_objects": out[6],
            "ledger_overflows": out[7],
        }

    def sweep(self) -> dict:
        """Drop dead clients' refs (disconnect sweep). Reclaims a
        SIGKILLed creator's unsealed partials — they never seal — and
        completes deferred deletes its refs were pinning."""
        out = self._call(self._lib.store_sweep, 4)
        return {
            "clients_swept": out[0],
            "refs_dropped": out[1],
            "partials_reclaimed": out[2],
            "ledger_overflows": out[3],
        }

    def sweep_stats(self) -> dict:
        out = self._call(self._lib.store_sweep_stats, 4)
        return {
            "num_sweeps": out[0],
            "refs_swept": out[1],
            "partials_reclaimed": out[2],
            "active_clients": out[3],
        }

    def close(self) -> None:
        with self._lock:
            if self._h:
                try:
                    self._shm.close()
                except BufferError:
                    self._shm.close = lambda: None  # views still alive
                self._lib.store_detach(self._h)
                self._h = 0

    def destroy(self) -> None:
        name = self.name
        self.close()
        if self._owner:
            try:
                self._lib.store_destroy(name.encode())
            except Exception:  # noqa: BLE001
                pass
