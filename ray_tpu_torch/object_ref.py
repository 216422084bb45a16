"""ObjectRef: a first-class future naming an immutable object.

Reference: the C++ ObjectID + Python ObjectRef (python/ray/includes/
object_ref.pxi). Refs are picklable; passing a ref inside a task arg or
return value keeps naming the same object (the reference calls this
borrowing — reference_count.h:61). Lifetime: every live instance counts
toward the process's local refcount (ref_tracker.py); when the last
instance across all clients dies, the GCS directory frees the object.
"""
from __future__ import annotations

import threading

from ._private import ref_tracker
from ._private.ids import ObjectID

# Active capture lists (serialization.dumps collects the refs nested in
# a value being stored, so the directory can pin them as children —
# the borrowing protocol's "refs inside objects" case).
_capture = threading.local()


class _CaptureRefs:
    """Context manager collecting ObjectRefs pickled within its scope."""

    def __enter__(self):
        self.seen = []
        stack = getattr(_capture, "stack", None)
        if stack is None:
            stack = _capture.stack = []
        stack.append(self.seen)
        return self

    def __exit__(self, *exc):
        _capture.stack.pop()
        return False


class ObjectRef:
    __slots__ = ("_id", "_owner", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: bytes = b""):
        self._id = object_id
        self._owner = owner
        # The owner rides into the tracker: instances of objects this
        # process owns count locally with zero wire traffic; borrowed
        # refs report borrow edges to their owner (object_plane).
        ref_tracker.track(object_id.binary(), owner)

    def __del__(self):
        try:
            ref_tracker.untrack(self._id.binary())
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        stack = getattr(_capture, "stack", None)
        if stack:
            stack[-1].append(self._id.binary())
        return (ObjectRef, (self._id, self._owner))

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        from . import get as _get
        import concurrent.futures
        import threading

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _resolve():
            try:
                fut.set_result(_get(self))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()


_STREAM_END = object()


class ObjectRefGenerator:
    """Iterator of ObjectRefs produced by a ``num_returns="streaming"``
    task (reference: StreamingObjectRefGenerator, _raylet.pyx:1289).

    Each ``next()`` blocks until the executor has sealed the next yield
    as its own object (reported incrementally through the control
    plane), then returns its ref — the consumer observes outputs while
    the task is still running. A generator that raises mid-stream
    delivers the error on the next() after its last yield. Not
    picklable (consume where created); lineage reconstruction does not
    cover streamed outputs.
    """

    def __init__(self, task_id: bytes, client, owner: bytes):
        self._task_id = task_id
        self._client = client
        self._owner = owner
        self._index = 0

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        nxt = self._next_or_end()
        if nxt is _STREAM_END:
            raise StopIteration
        return nxt

    def _next_or_end(self):
        reply = self._client.request(
            {
                "type": "stream_next",
                "task_id": self._task_id,
                "index": self._index,
            }
        )
        if reply.get("available"):
            oid = ObjectID(ObjectID.bytes_for_return(self._task_id, self._index))
            self._index += 1
            # Ownerless on purpose: stream items are sealed head-side by
            # the executor (owner None in the directory) and lineage
            # never covers streamed outputs — head-fallback holder
            # semantics free them on drop. Owner classification would
            # mean an owned-but-never-advertised ref whose drop sends
            # nothing, leaking every consumed item.
            ref = ObjectRef(oid, b"")
            # Advertised from birth: stream_next just confirmed the
            # head entry exists, so the eventual drop must send its
            # remove even when the item is consumed and dropped within
            # one flush window (otherwise fast drain loops leak every
            # item — the entry has no other holder).
            tracker = getattr(self._client, "_tracker", None)
            if tracker is not None:
                tracker.mark_advertised(oid.binary())
            return ref
        err = reply.get("error")
        if err is not None:
            from ._private import serialization
            from .exceptions import RayTaskError

            e = serialization.unpack(err)
            if isinstance(e, RayTaskError):
                raise e.as_instanceof_cause()
            raise e
        return _STREAM_END

    def __aiter__(self):
        return self

    async def __anext__(self) -> "ObjectRef":
        import asyncio

        loop = asyncio.get_running_loop()
        nxt = await loop.run_in_executor(None, self._next_or_end)
        if nxt is _STREAM_END:
            raise StopAsyncIteration
        return nxt

    def completed(self) -> int:
        """Items yielded so far (refs this generator has handed out)."""
        return self._index

    def __repr__(self):
        return f"ObjectRefGenerator(task={self._task_id.hex()}, next={self._index})"
