"""Streaming executor: runs an optimized plan as pipelined remote tasks.

Reference: python/ray/data/_internal/execution/streaming_executor.py —
a pull-based loop over a topology of operators with bounded in-flight
tasks (backpressure via ConcurrencyCapBackpressurePolicy) and ordered
output. Here each fused MapSegment streams: the launcher keeps at most
``max_in_flight`` tasks outstanding, emits bundles in input order, and
stops scheduling once a pushed-down limit is satisfied. AllToAll ops are
barriers (as in the reference), consuming the whole upstream stream.

The port's copy of ray_tpu/data/_executor.py: its tasks run on
``ray_tpu_torch.remote`` and pass numpy blocks (``block.py``) where the
reference passes arrow tables.
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from .block import Block, BlockAccessor, BlockMetadata, build_block, concat_blocks
from .datasource import ReadTask
from ._plan import AllToAll, InputData, MapSegment, MapSpec, Read
from ._resource_manager import ResourceManager

# A bundle is (block_ref, metadata). Metadata rides the control plane so
# the caller never fetches payloads it does not need (reference: RefBundle).
Bundle = Tuple[Any, BlockMetadata]


# ------------------------------------------------------------ remote fns

@ray_tpu_torch.remote(num_returns=2)
def _read_map_task(read_task: ReadTask, spec: MapSpec, task_index: int):
    blocks = [build_block(b) for b in read_task()]
    block = concat_blocks(blocks)
    block = spec.apply(block, task_index)
    meta = BlockAccessor.for_block(block).metadata(
        input_files=read_task.metadata.input_files
    )
    return block, meta


@ray_tpu_torch.remote(num_returns=2)
def _map_task(block: Block, spec: MapSpec, task_index: int):
    block = spec.apply(block, task_index)
    meta = BlockAccessor.for_block(block).metadata()
    return block, meta


@ray_tpu_torch.remote(num_returns=2)
def _slice_task(block: Block, start: int, end: int):
    out = BlockAccessor.for_block(block).slice(start, end)
    return out, BlockAccessor.for_block(out).metadata()


@ray_tpu_torch.remote(num_returns=2)
def _concat_task(*blocks: Block):
    out = concat_blocks([build_block(b) for b in blocks])
    return out, BlockAccessor.for_block(out).metadata()


@ray_tpu_torch.remote
def _split_random(block: Block, n: int, seed: Optional[int], salt: int):
    """Shuffle-map: scatter rows of one block into n shards. Called with
    options(num_returns=n) so shards stay in the object store and merge
    tasks fetch them peer-to-peer (no round-trip through the caller)."""
    acc = BlockAccessor.for_block(block)
    rng = np.random.RandomState(None if seed is None else seed + salt)
    assign = rng.randint(0, n, size=acc.num_rows())
    shards = [acc.take_indices(np.nonzero(assign == i)[0]) for i in range(n)]
    return shards[0] if n == 1 else shards


@ray_tpu_torch.remote(num_returns=2)
def _merge_shuffled(seed: Optional[int], salt: int, *shards: Block):
    out = concat_blocks([build_block(s) for s in shards])
    acc = BlockAccessor.for_block(out)
    rng = np.random.RandomState(None if seed is None else seed + salt)
    out = acc.take_indices(rng.permutation(acc.num_rows()))
    return out, BlockAccessor.for_block(out).metadata()


@ray_tpu_torch.remote
def _sample_sort_keys(block: Block, key: str, n: int, seed: int):
    acc = BlockAccessor.for_block(block)
    return BlockAccessor.for_block(acc.sample_rows(n, seed)).to_numpy_batch().get(key)


@ray_tpu_torch.remote
def _range_partition(block: Block, key: str, boundaries: List[Any], desc: bool):
    """Sort-map: split one block into len(boundaries)+1 key ranges."""
    acc = BlockAccessor.for_block(block)
    n = len(boundaries) + 1
    if acc.num_rows() == 0:
        empty = acc.slice(0, 0)
        return empty if n == 1 else [empty] * n
    keys = acc.to_numpy_batch()[key]
    idx = np.searchsorted(np.asarray(boundaries), keys, side="right")
    parts = [acc.take_indices(np.nonzero(idx == i)[0]) for i in range(n)]
    if desc:
        parts = parts[::-1]
    return parts[0] if n == 1 else parts


@ray_tpu_torch.remote(num_returns=2)
def _merge_sorted(key: str, desc: bool, *shards: Block):
    out = concat_blocks([build_block(s) for s in shards])
    acc = BlockAccessor.for_block(out)
    if acc.num_rows() == 0:
        return out, acc.metadata()
    keys = acc.to_numpy_batch()[key]
    order = np.argsort(keys, kind="stable")
    if desc:
        order = order[::-1]
    out = acc.take_indices(order)
    return out, BlockAccessor.for_block(out).metadata()


def _stable_hash(v) -> int:
    """Deterministic across processes (Python's hash() of str/bytes is
    salted per process, which would scatter equal keys to different
    partitions)."""
    import zlib

    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, bytes):
        return zlib.crc32(v)
    return zlib.crc32(str(v).encode())


@ray_tpu_torch.remote
def _hash_partition(block: Block, key, n: int):
    acc = BlockAccessor.for_block(block)
    cols = acc.to_numpy_batch()
    keys = cols[key]
    hashes = np.asarray([_stable_hash(k) % n for k in keys.tolist()])
    parts = [acc.take_indices(np.nonzero(hashes == i)[0]) for i in range(n)]
    return parts[0] if n == 1 else parts


@ray_tpu_torch.remote(num_returns=2)
def _zip_task(left: Block, right: Block):
    cols = dict(build_block(left))
    for name, col in build_block(right).items():
        out_name = name if name not in cols else name + "_1"
        cols[out_name] = col
    out = cols
    return out, BlockAccessor.for_block(out).metadata()


# -------------------------------------------------------------- executor

class StreamingExecutor:
    """Runs the optimized segment list, yielding output bundles in order."""

    def __init__(self, max_in_flight: Optional[int] = None,
                 memory_budget_bytes: Optional[int] = None):
        if max_in_flight is None:
            try:
                max_in_flight = max(
                    2, int(ray_tpu_torch.cluster_resources().get("CPU", 4))
                )
            except Exception:
                max_in_flight = 4
        self.max_in_flight = max_in_flight
        if memory_budget_bytes is None:
            import os

            env = os.environ.get("RAY_TPU_TORCH_DATA_MEMORY_BUDGET")
            memory_budget_bytes = int(env) if env else None
        self.memory_budget_bytes = memory_budget_bytes
        # Bound on OUTSTANDING BYTES across operators (reference:
        # ReservationOpResourceAllocator); assigned per-execute once the
        # operator count is known.
        self.resource_manager: Optional[ResourceManager] = None

    # --- map segments (streaming) ---

    def _run_map_segment(
        self, seg: MapSegment, upstream: Optional[Iterator[Bundle]],
        op_id: int = 0,
    ) -> Iterator[Bundle]:
        rm = self.resource_manager or ResourceManager(None, 1)
        if isinstance(seg.source, InputData):
            inputs: Iterator[Any] = iter(seg.source.bundles)
            mode = "bundle"
            if not seg.spec.transforms:
                yield from seg.source.bundles
                return
        elif isinstance(seg.source, Read):
            parallelism = seg.source.parallelism
            if parallelism in (-1, None):
                parallelism = self.max_in_flight * 2
            inputs = iter(seg.source.datasource.get_read_tasks(parallelism))
            mode = "read"
        else:
            assert upstream is not None
            inputs = upstream
            mode = "bundle"
            if not seg.spec.transforms:
                yield from upstream
                return

        # meta_ref -> (idx, block_ref, est_bytes)
        pending: Dict[Any, Tuple[int, Any, float]] = {}
        done: List[Tuple[int, Bundle]] = []  # heap by idx
        next_emit = 0
        next_idx = 0
        rows_emitted = 0
        exhausted = False
        stop = seg.stop_after_rows
        staged: Optional[Tuple[Any, float]] = None  # pulled, awaiting budget

        def trim(bundle: Bundle) -> Bundle:
            """Slice the final bundle so limit(n) is exact, not
            block-granular."""
            if stop is None or rows_emitted + bundle[1].num_rows <= stop:
                return bundle
            take = stop - rows_emitted
            b_ref, m_ref = _slice_task.remote(bundle[0], 0, take)
            return (b_ref, ray_tpu_torch.get(m_ref))

        def launch_one() -> bool:
            """Pull (or resume) one input and launch it if the memory
            budget allows; False = stop trying this round."""
            nonlocal next_idx, exhausted, staged
            if staged is not None:
                item, est = staged
            else:
                try:
                    item = next(inputs)
                except StopIteration:
                    exhausted = True
                    return False
                hint = (
                    item.metadata.size_bytes
                    if mode == "read"
                    else item[1].size_bytes
                )
                est = rm.estimate_output(op_id, float(hint or 0))
            if not rm.can_launch(op_id, est):
                # Hold the pulled item; upstream stays paused too (the
                # pull chain is how backpressure propagates).
                staged = (item, est)
                return False
            staged = None
            if mode == "read":
                block_ref, meta_ref = _read_map_task.remote(
                    item, seg.spec, next_idx
                )
            else:
                in_ref = item[0]
                block_ref, meta_ref = _map_task.remote(in_ref, seg.spec, next_idx)
            rm.on_launch(op_id, est)
            pending[meta_ref] = (next_idx, block_ref, est)
            next_idx += 1
            return True

        while True:
            # Backpressure: bounded outstanding tasks AND bytes.
            while (
                not exhausted
                and len(pending) < self.max_in_flight
                and (stop is None or rows_emitted < stop)
            ):
                if not launch_one():
                    break
            if not pending and (exhausted or (stop is not None and rows_emitted >= stop)):
                # Drain ordered buffer.
                while done and (stop is None or rows_emitted < stop):
                    _, bundle = heapq.heappop(done)
                    bundle = trim(bundle)
                    rows_emitted += bundle[1].num_rows
                    rm.on_consumed(op_id, float(bundle[1].size_bytes))
                    yield bundle
                return
            if not pending:
                return
            ready, _ = ray_tpu_torch.wait(list(pending.keys()), num_returns=1)
            for meta_ref in ready:
                idx, block_ref, est = pending.pop(meta_ref)
                meta: BlockMetadata = ray_tpu_torch.get(meta_ref)
                rm.on_task_done(op_id, est, float(meta.size_bytes))
                heapq.heappush(done, (idx, (block_ref, meta)))
            while done and done[0][0] == next_emit:
                _, bundle = heapq.heappop(done)
                next_emit += 1
                bundle = trim(bundle)
                rows_emitted += bundle[1].num_rows
                rm.on_consumed(op_id, float(bundle[1].size_bytes))
                yield bundle
                if stop is not None and rows_emitted >= stop:
                    # Drop remaining work (reference: operators are
                    # interrupted once the limit is reached).
                    for _i, _b, est in pending.values():
                        rm.on_task_dropped(op_id, est)
                    pending.clear()
                    return

    # --- all-to-all barriers ---

    def _run_all_to_all(self, op: AllToAll, bundles: List[Bundle]) -> List[Bundle]:
        kind, kw = op.kind, op.kwargs
        if kind == "repartition":
            return self._repartition(bundles, kw["num_blocks"])
        if kind == "random_shuffle":
            return self._random_shuffle(bundles, kw.get("seed"))
        if kind == "sort":
            return self._sort(bundles, kw["key"], kw.get("descending", False))
        if kind == "union":
            out = list(bundles)
            for other in kw["others"]:
                out.extend(other)
            return out
        if kind == "zip":
            return self._zip(bundles, kw["other"])
        if kind == "hash_partition":
            return self._hash_partition(bundles, kw["key"], kw["num_partitions"])
        raise ValueError(f"unknown all-to-all {kind}")

    def _repartition(self, bundles: List[Bundle], n: int) -> List[Bundle]:
        total = sum(b[1].num_rows for b in bundles)
        per = [total // n + (1 if i < total % n else 0) for i in range(n)]
        # Global row ranges -> per-input slices -> merge.
        slices: List[List[Any]] = [[] for _ in range(n)]
        out_i, filled = 0, 0
        for block_ref, meta in bundles:
            consumed = 0
            while consumed < meta.num_rows and out_i < n:
                take = min(per[out_i] - filled, meta.num_rows - consumed)
                if take > 0:
                    s_ref, _ = _slice_task.remote(block_ref, consumed, consumed + take)
                    slices[out_i].append(s_ref)
                    consumed += take
                    filled += take
                if filled == per[out_i]:
                    out_i += 1
                    filled = 0
                elif consumed == meta.num_rows:
                    break
        out: List[Bundle] = []
        for parts in slices:
            b_ref, m_ref = _concat_task.remote(*parts) if parts else _concat_task.remote()
            out.append((b_ref, ray_tpu_torch.get(m_ref)))
        return out

    def _random_shuffle(self, bundles: List[Bundle], seed) -> List[Bundle]:
        n = max(1, len(bundles))
        # Map side: shard refs stay in the object store; merge tasks fetch
        # them directly (reference: push-based shuffle, no staging in the caller).
        shard_refs = [
            _split_random.options(num_returns=n).remote(ref, n, seed, salt)
            for salt, (ref, _) in enumerate(bundles)
        ]
        if n == 1:
            shard_refs = [[r] if not isinstance(r, list) else r for r in shard_refs]
        out: List[Bundle] = []
        for i in range(n):
            col = [s[i] for s in shard_refs]
            b_ref, m_ref = _merge_shuffled.remote(seed, 10_000 + i, *col)
            out.append((b_ref, ray_tpu_torch.get(m_ref)))
        return out

    def _sort(self, bundles: List[Bundle], key: str, desc: bool) -> List[Bundle]:
        n = max(1, len(bundles))
        samples = ray_tpu_torch.get(
            [_sample_sort_keys.remote(ref, key, 20, i) for i, (ref, _) in enumerate(bundles)]
        )
        nonempty = [np.atleast_1d(np.asarray(s)) for s in samples if s is not None]
        keys = np.concatenate(nonempty) if nonempty else np.array([])
        keys.sort()
        boundaries = [
            keys[min(int(len(keys) * (i + 1) / n), len(keys) - 1)]
            for i in range(n - 1)
        ] if len(keys) else []
        # partition count follows the boundaries (all-empty data -> 1)
        n_out = len(boundaries) + 1
        parts = [
            _range_partition.options(num_returns=n_out).remote(
                ref, key, boundaries, desc
            )
            for ref, _ in bundles
        ]
        if n_out == 1:
            parts = [[p] if not isinstance(p, list) else p for p in parts]
        out: List[Bundle] = []
        for i in range(n_out):
            col = [p[i] for p in parts]
            b_ref, m_ref = _merge_sorted.remote(key, desc, *col)
            out.append((b_ref, ray_tpu_torch.get(m_ref)))
        return out

    def _hash_partition(self, bundles: List[Bundle], key, n: int) -> List[Bundle]:
        parts = [
            _hash_partition.options(num_returns=n).remote(ref, key, n)
            for ref, _ in bundles
        ]
        if n == 1:
            parts = [[p] if not isinstance(p, list) else p for p in parts]
        out: List[Bundle] = []
        for i in range(n):
            col = [p[i] for p in parts]
            b_ref, m_ref = _concat_task.remote(*col)
            out.append((b_ref, ray_tpu_torch.get(m_ref)))
        return out

    def _zip(self, left: List[Bundle], right: List[Bundle]) -> List[Bundle]:
        # Align the right side to the left side's block row layout.
        right = self._repartition(right, max(1, len(left)))
        l_rows = [b[1].num_rows for b in left]
        r_rows = [b[1].num_rows for b in right]
        if l_rows != r_rows:
            total = sum(l_rows)
            if total != sum(r_rows):
                raise ValueError(
                    f"zip requires equal row counts: {sum(l_rows)} vs {sum(r_rows)}"
                )
            # Fall back to a single block on both sides.
            left = self._repartition(left, 1)
            right = self._repartition(right, 1)
        out: List[Bundle] = []
        for (lb, _), (rb, _) in zip(left, right):
            b_ref, m_ref = _zip_task.remote(lb, rb)
            out.append((b_ref, ray_tpu_torch.get(m_ref)))
        return out

    # --- the plan ---

    def execute(self, segments: List[Any]) -> Iterator[Bundle]:
        n_maps = sum(1 for s in segments if isinstance(s, MapSegment))
        self.resource_manager = ResourceManager(
            self.memory_budget_bytes, n_maps
        )
        stream: Optional[Iterator[Bundle]] = None
        op_id = 0
        for seg in segments:
            if isinstance(seg, MapSegment):
                stream = self._run_map_segment(seg, stream, op_id)
                op_id += 1
            elif isinstance(seg, AllToAll):
                # Barriers consume the whole upstream by design
                # (reference: AllToAll operators are not streaming).
                upstream = list(stream) if stream is not None else []
                stream = iter(self._run_all_to_all(seg, upstream))
            else:
                raise TypeError(f"bad segment {seg}")
        assert stream is not None
        return stream
