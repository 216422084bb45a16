"""Shared-memory SPSC channels for compiled graphs.

Reference: the mutable-object channels behind accelerated DAGs
(src/ray/core_worker/experimental_mutable_object_manager.cc and
python/ray/experimental/channel/shared_memory_channel.py): a
single-slot shared buffer a writer and reader rendezvous on, avoiding
per-message RPC entirely.

Layout: [8B write_seq][8B read_seq][8B payload_len][8B closed]
[payload...].
Single-producer single-consumer; a pair of POSIX named semaphores
("items" posted by the writer, "space" posted by the reader) gives
true blocking rendezvous — no polling, microsecond wakeups.

Values are pickled as the reference pickles them (plain pickle,
protocol 5, in-band), but a torch tensor is reduced by the object
store's reducer (`serialization._reduce_tensor`): it leaves its card on
the way and the reader gets a host tensor of its dtype, shape and grad
flag, so a reader without a card can load it. The segment is
``/dev/shm/rtpt_ch_<hex>`` and its semaphores ``rtpt_ch_<hex>.i`` and
``.s``.
"""
from __future__ import annotations

import io
import pickle
import secrets
import struct
import sys
from multiprocessing import shared_memory
from typing import Any, Optional

from .posix_sem import NamedSemaphore
from .serialization import _reduce_tensor

PREFIX = "rtpt_ch_"

_HEADER = 32
_CLOSED_LEN = 0xFFFFFFFFFFFFFFFF


class ChannelClosed(Exception):
    pass


class _Pickler(pickle.Pickler):
    """The C pickler with torch tensors reduced to host copies. Exact
    builtins (ints, strs, tuples, ...) skip `reducer_override`, so a
    small message costs about what the reference's `pickle.dumps` does."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")  # no torch loaded: no tensors
        if torch is not None and type(obj) in (torch.Tensor, torch.nn.Parameter):
            reduced = _reduce_tensor(torch, obj)
            if reduced is not None:
                return reduced
        return NotImplemented


def _dumps(value: Any) -> bytes:
    with io.BytesIO() as f:
        _Pickler(f, protocol=5).dump(value)
        return f.getvalue()


class Channel:
    def __init__(self, name: Optional[str] = None, capacity: int = 1 << 20):
        if name is None:
            self._shm = shared_memory.SharedMemory(
                name=PREFIX + secrets.token_hex(8), create=True,
                size=_HEADER + capacity,
            )
            self._owner = True
            struct.pack_into("<QQQQ", self._shm.buf, 0, 0, 0, 0, 0)
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            self._owner = False
        self.capacity = self._shm.size - _HEADER
        sem_base = self._shm.name.strip("/").replace("/", "_")
        self._items = NamedSemaphore(
            f"{sem_base}.i", create=self._owner, initial=0
        )
        self._space = NamedSemaphore(
            f"{sem_base}.s", create=self._owner, initial=1
        )
        # Unregister from the resource tracker in attach-mode so a
        # reader process exiting doesn't unlink the segment.
        if not self._owner:
            try:
                from multiprocessing import resource_tracker

                resource_tracker.unregister(self._shm._name, "shared_memory")
            except Exception:  # noqa: BLE001
                pass

    @property
    def name(self) -> str:
        return self._shm.name

    # ------------------------------------------------------------ seqs
    def _seqs(self):
        w, r = struct.unpack_from("<QQ", self._shm.buf, 0)
        return w, r

    def _closed(self) -> int:
        (c,) = struct.unpack_from("<Q", self._shm.buf, 24)
        return c

    # ----------------------------------------------------------- write
    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        payload = _dumps(value)
        if len(payload) > self.capacity:
            raise ValueError(
                f"payload {len(payload)}B exceeds channel capacity "
                f"{self.capacity}B"
            )
        if self._closed():
            raise ChannelClosed
        if not self._space.wait(timeout):
            raise TimeoutError("channel write timed out")
        if self._closed():
            raise ChannelClosed
        w, r = self._seqs()
        struct.pack_into("<Q", self._shm.buf, 16, len(payload))
        self._shm.buf[_HEADER : _HEADER + len(payload)] = payload
        struct.pack_into("<Q", self._shm.buf, 0, w + 1)
        self._items.post()

    # ------------------------------------------------------------ read
    def read(self, timeout: Optional[float] = None) -> Any:
        if not self._items.wait(timeout):
            raise TimeoutError("channel read timed out")
        w, r = self._seqs()
        if w == r:
            # Woken by close, not by data: EOF after draining everything
            # (an in-flight payload written before close is still
            # delivered — close never discards messages).
            raise ChannelClosed
        (n,) = struct.unpack_from("<Q", self._shm.buf, 16)
        value = pickle.loads(bytes(self._shm.buf[_HEADER : _HEADER + n]))
        struct.pack_into("<Q", self._shm.buf, 8, r + 1)
        self._space.post()
        return value

    # ----------------------------------------------------------- close
    def close_writer(self) -> None:
        """Signal EOF to the reader (wakes a blocked read). Messages
        already written remain readable before EOF is raised."""
        struct.pack_into("<Q", self._shm.buf, 24, 1)
        self._items.post()

    def close_reader(self) -> None:
        struct.pack_into("<Q", self._shm.buf, 24, 1)
        self._space.post()

    def destroy(self) -> None:
        self._shm.close()
        self._items.close()
        self._space.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
            try:
                self._items.unlink()
                self._space.unlink()
            except OSError:
                pass

    def __reduce__(self):
        return (Channel, (self.name,))
