"""Drop-in ``multiprocessing.Pool`` over ray_tpu_torch actors.

Reference: python/ray/util/multiprocessing/pool.py — the same idea
rebuilt small: a Pool of sub-core actors (they co-host on shared
worker processes — gcs._packable — so ``Pool(32)`` does not boot 32
interpreters), chunked dispatch, and the familiar map/imap/apply
surface. Library code written against multiprocessing parallelizes
across the cluster by changing one import.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch

__all__ = ["Pool", "TimeoutError"]

TimeoutError = TimeoutError  # multiprocessing.TimeoutError parity


@ray_tpu_torch.remote(num_cpus=0.2)
class _PoolWorker:
    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run_chunk(self, fn, chunk, star: bool):
        if star:
            return [fn(*args) for args in chunk]
        return [fn(x) for x in chunk]

    def run_one(self, fn, args, kwargs):
        return fn(*args, **kwargs)


class AsyncResult:
    def __init__(self, refs: List[Any], flatten: bool):
        self._refs = refs
        self._flatten = flatten

    def get(self, timeout: Optional[float] = None):
        chunks = ray_tpu_torch.get(self._refs, timeout=timeout)
        if not self._flatten:
            return chunks[0]
        return list(itertools.chain.from_iterable(chunks))

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(
            list(self._refs), num_returns=len(self._refs), timeout=timeout
        )

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(
            list(self._refs), num_returns=len(self._refs), timeout=0
        )
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0.001)
            return True
        except Exception:  # noqa: BLE001 - multiprocessing semantics
            return False


class Pool:
    """multiprocessing.Pool surface over an actor fleet."""

    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=()):
        if processes is None:
            total = ray_tpu_torch.cluster_resources().get("CPU", 1)
            processes = max(1, int(total))
        self._n = processes
        self._actors = [
            _PoolWorker.remote(initializer, tuple(initargs))
            for _ in range(processes)
        ]
        self._closed = False
        self._rr = 0
        # Every ref ever issued: join() waits on these so the standard
        # close()+join() shutdown both drains in-flight work AND tears
        # the actor fleet down (multiprocessing semantics — actors left
        # alive would leak their sub-core CPU reservations).
        self._issued: List[Any] = []

    # ------------------------------------------------------------ dispatch
    def _check(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _chunks(self, values: List[Any], chunksize: Optional[int]):
        if chunksize is None:
            chunksize = max(1, len(values) // (self._n * 4) or 1)
        for i in range(0, len(values), chunksize):
            yield values[i : i + chunksize]

    def _spread(self, fn, chunks: Iterable[List[Any]], star: bool):
        refs = []
        for chunk in chunks:
            actor = self._actors[self._rr % self._n]
            self._rr += 1
            refs.append(actor.run_chunk.remote(fn, chunk, star))
        self._issued.extend(refs)
        return refs

    # ----------------------------------------------------------------- api
    def map(self, fn: Callable, values: Iterable[Any],
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, values, chunksize).get()

    def map_async(self, fn, values, chunksize=None) -> AsyncResult:
        self._check()
        refs = self._spread(fn, self._chunks(list(values), chunksize), False)
        return AsyncResult(refs, flatten=True)

    def starmap(self, fn: Callable, values: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        return self.starmap_async(fn, values, chunksize).get()

    def starmap_async(self, fn, values, chunksize=None) -> AsyncResult:
        self._check()
        refs = self._spread(fn, self._chunks(list(values), chunksize), True)
        return AsyncResult(refs, flatten=True)

    def apply(self, fn: Callable, args=(), kwds=None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args=(), kwds=None, callback=None,
                    error_callback=None) -> AsyncResult:
        """Callbacks fire from a waiter thread on completion — the
        contract joblib's PoolManagerMixin drives batches through."""
        self._check()
        actor = self._actors[self._rr % self._n]
        self._rr += 1
        ref = actor.run_one.remote(fn, tuple(args), kwds or {})
        self._issued.append(ref)
        result = AsyncResult([ref], flatten=False)
        if callback is not None or error_callback is not None:
            import threading

            def waiter():
                try:
                    value = result.get()
                except Exception as e:  # noqa: BLE001 - mp semantics
                    if error_callback is not None:
                        error_callback(e)
                    return
                if callback is not None:
                    callback(value)

            threading.Thread(target=waiter, daemon=True).start()
        return result

    def imap(self, fn: Callable, values: Iterable[Any],
             chunksize: Optional[int] = None):
        """Lazy ordered iterator: results stream as chunks finish."""
        self._check()
        refs = self._spread(fn, self._chunks(list(values), chunksize), False)
        for ref in refs:
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn: Callable, values: Iterable[Any],
                       chunksize: Optional[int] = None):
        self._check()
        refs = self._spread(fn, self._chunks(list(values), chunksize), False)
        pending = list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield from ray_tpu_torch.get(ready[0])

    # ------------------------------------------------------------ lifecycle
    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for a in self._actors:
            ray_tpu_torch.kill(a)
        self._actors = []

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")
        if self._issued:
            ray_tpu_torch.wait(
                list(self._issued), num_returns=len(self._issued)
            )
            self._issued = []
        for a in self._actors:
            ray_tpu_torch.kill(a)
        self._actors = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
