"""Actor-backed distributed queue (reference: python/ray/util/queue.py:20)."""
from __future__ import annotations

import time
from typing import Any, List, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        import collections

        self._maxsize = maxsize
        self._items = collections.deque()

    def qsize(self) -> int:
        return len(self._items)

    def put_nowait(self, item) -> bool:
        if self._maxsize > 0 and len(self._items) >= self._maxsize:
            return False
        self._items.append(item)
        return True

    def get_nowait(self):
        if not self._items:
            return False, None
        return True, self._items.popleft()

    def put_nowait_batch(self, items: List[Any]) -> bool:
        if self._maxsize > 0 and len(self._items) + len(items) > self._maxsize:
            return False
        self._items.extend(items)
        return True

    def get_nowait_batch(self, num: int):
        taken = []
        while self._items and len(taken) < num:
            taken.append(self._items.popleft())
        return taken


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        from .. import remote

        cls = remote(_QueueActor)
        if actor_options:
            cls = cls.options(**actor_options)
        self.actor = cls.remote(maxsize)

    def qsize(self) -> int:
        from .. import get

        return get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None):
        from .. import get

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if get(self.actor.put_nowait.remote(item)):
                return
            if not block or (deadline and time.monotonic() > deadline):
                raise Full()
            time.sleep(0.01)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        from .. import get as ray_get

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_get(self.actor.get_nowait.remote())
            if ok:
                return item
            if not block or (deadline and time.monotonic() > deadline):
                raise Empty()
            time.sleep(0.01)

    def put_nowait(self, item: Any):
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def shutdown(self):
        from .. import kill

        kill(self.actor)
