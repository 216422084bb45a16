"""@serve.batch: transparent request batching.

Reference: python/ray/serve/batching.py. Calls are queued; a background
task drains up to ``max_batch_size`` (or whatever arrived within
``batch_wait_timeout_s``) and invokes the wrapped function once with a
list of requests. On the card this is the lever that keeps the tensor
cores busy: a replica's model sees one padded batch instead of many
size-1 calls.
"""
from __future__ import annotations

import asyncio
import functools
import inspect
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, func, max_batch_size: int, batch_wait_timeout_s: float):
        self._func = func
        self._max = max_batch_size
        self._timeout = batch_wait_timeout_s
        self._queue: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None

    def _ensure(self):
        if self._queue is None:
            self._queue = asyncio.Queue()
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def submit(self, item: Any) -> Any:
        self._ensure()
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put((item, fut))
        return await fut

    async def _loop(self):
        while True:
            batch = [await self._queue.get()]
            deadline = asyncio.get_running_loop().time() + self._timeout
            while len(batch) < self._max:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                try:
                    batch.append(
                        await asyncio.wait_for(self._queue.get(), timeout=remaining)
                    )
                except asyncio.TimeoutError:
                    break
            items = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            try:
                results = self._func(items)
                if inspect.isawaitable(results):
                    results = await results
                if len(results) != len(items):
                    raise ValueError(
                        f"@serve.batch function returned {len(results)} results "
                        f"for {len(items)} inputs"
                    )
                for fut, res in zip(futs, results):
                    if not fut.done():
                        fut.set_result(res)
            except Exception as e:  # noqa: BLE001
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)


def batch(
    _func: Optional[Callable] = None,
    *,
    max_batch_size: int = 10,
    batch_wait_timeout_s: float = 0.01,
):
    """Decorate an async method taking ``List[T] -> List[R]``; callers
    invoke it with a single ``T`` and get a single ``R``."""

    def wrap(func):
        queues = {}  # per-instance (methods) or single (functions)

        if _first_arg_is_self(func):

            @functools.wraps(func)
            async def method_wrapper(self, item):
                q = queues.get(id(self))
                if q is None:
                    q = _BatchQueue(
                        functools.partial(func, self), max_batch_size,
                        batch_wait_timeout_s,
                    )
                    queues[id(self)] = q
                return await q.submit(item)

            return method_wrapper

        q = _BatchQueue(func, max_batch_size, batch_wait_timeout_s)

        @functools.wraps(func)
        async def func_wrapper(item):
            return await q.submit(item)

        return func_wrapper

    if _func is not None:
        return wrap(_func)
    return wrap


def _first_arg_is_self(func) -> bool:
    params = list(inspect.signature(func).parameters)
    return bool(params) and params[0] == "self"
