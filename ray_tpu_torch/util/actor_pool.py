"""ActorPool (reference: python/ray/util/actor_pool.py:13)."""
from __future__ import annotations

from typing import Any, Callable, Iterable, List


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0

    def submit(self, fn: Callable, value: Any):
        if not self._idle:
            raise RuntimeError("No idle actors; call get_next() first")
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def has_next(self) -> bool:
        return self._next_return_index < self._next_task_index

    def get_next(self, timeout: float | None = None) -> Any:
        from .. import get

        if not self.has_next():
            raise StopIteration("No pending results")
        ref = self._index_to_future[self._next_return_index]
        # Resolve before mutating bookkeeping so a GetTimeoutError leaves the
        # pool consistent and the result retrievable on retry.
        value = get(ref, timeout=timeout)
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._idle.append(self._future_to_actor.pop(ref))
        return value

    def has_free(self) -> bool:
        return bool(self._idle)

    def map(self, fn: Callable, values: Iterable[Any]):
        values = list(values)
        results = []
        it = iter(values)
        submitted = 0
        for v in it:
            if not self.has_free():
                break
            self.submit(fn, v)
            submitted += 1
        for v in list(values[submitted:]):
            results.append(self.get_next())
            self.submit(fn, v)
        while self.has_next():
            results.append(self.get_next())
        return results
