"""Reservation-based per-operator memory budgets for the executor.

Reference: python/ray/data/_internal/execution/resource_manager.py:26
(ResourceManager) and :247 (ReservationOpResourceAllocator) — the
streaming executor bounds OUTSTANDING BYTES, not just task counts: a
flat in-flight cap lets a pipeline of large blocks balloon the object
store to cap x block_size regardless of memory.

Model (the reference's split): half the budget is RESERVED, divided
equally among the pipeline's map operators so no op can starve another;
the other half is a SHARED pool any op may borrow from. An operator's
usage is its estimated in-flight task output plus completed-but-not-
yet-consumed output bytes. Every op may always run at least one task
when it has nothing outstanding (the reference's progress guarantee —
backpressure must never deadlock the pipeline).

Output-size estimates start from the input metadata (file bytes for
reads, block bytes for maps) and converge to the running mean of
actual completed outputs. Until an op's first task has finished, its
estimate is only that guess, so it runs one task at a time (the
reference launches on the guess: a map that grows its blocks then
overshoots the budget by as many blocks as complete out of order).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

DEFAULT_TASK_OUTPUT_EST = 4 * 1024 * 1024


class OpUsage:
    __slots__ = ("inflight_est", "buffered", "completed", "total_out")

    def __init__(self):
        self.inflight_est = 0.0  # estimated bytes of launched tasks
        self.buffered = 0.0  # actual bytes produced, not yet consumed
        self.completed = 0  # tasks finished (for the running mean)
        self.total_out = 0.0

    @property
    def used(self) -> float:
        return self.inflight_est + self.buffered


class ResourceManager:
    """Tracks per-op outstanding bytes against a global budget."""

    def __init__(self, budget_bytes: Optional[int], num_ops: int):
        self.budget = budget_bytes
        self.num_ops = max(1, num_ops)
        self._ops: Dict[int, OpUsage] = {}
        self._lock = threading.Lock()
        self.peak_bytes = 0.0
        if budget_bytes is not None:
            self.reserved_per_op = 0.5 * budget_bytes / self.num_ops
            self.shared_cap = 0.5 * budget_bytes
        else:
            self.reserved_per_op = self.shared_cap = float("inf")

    def _op(self, op_id: int) -> OpUsage:
        return self._ops.setdefault(op_id, OpUsage())

    # ----------------------------------------------------------- queries
    def estimate_output(self, op_id: int, input_hint: float) -> float:
        """Expected bytes a new task will produce."""
        u = self._op(op_id)
        if u.completed:
            return u.total_out / u.completed
        return input_hint if input_hint > 0 else DEFAULT_TASK_OUTPUT_EST

    def _shared_in_use(self) -> float:
        return sum(
            max(0.0, u.used - self.reserved_per_op)
            for u in self._ops.values()
        )

    def can_launch(self, op_id: int, est: float) -> bool:
        if self.budget is None:
            return True
        with self._lock:
            u = self._op(op_id)
            if u.used <= 0:
                return True  # progress guarantee: >=1 task per op
            if not u.completed:
                return False  # no output size seen yet
            if u.used + est <= self.reserved_per_op:
                return True
            # Borrow from the shared pool.
            overflow = max(0.0, u.used - self.reserved_per_op) + est
            others = self._shared_in_use() - max(
                0.0, u.used - self.reserved_per_op
            )
            return others + overflow <= self.shared_cap

    # ----------------------------------------------------------- updates
    def on_launch(self, op_id: int, est: float) -> None:
        with self._lock:
            self._op(op_id).inflight_est += est
            self._note_peak()

    def on_task_done(self, op_id: int, est: float, actual: float) -> None:
        with self._lock:
            u = self._op(op_id)
            u.inflight_est = max(0.0, u.inflight_est - est)
            u.buffered += actual
            u.completed += 1
            u.total_out += actual
            self._note_peak()

    def on_consumed(self, op_id: int, actual: float) -> None:
        """A produced bundle was handed downstream (or to the caller)."""
        with self._lock:
            u = self._op(op_id)
            u.buffered = max(0.0, u.buffered - actual)

    def on_task_dropped(self, op_id: int, est: float) -> None:
        """A launched task was cancelled (limit reached)."""
        with self._lock:
            u = self._op(op_id)
            u.inflight_est = max(0.0, u.inflight_est - est)

    def _note_peak(self) -> None:
        total = sum(u.used for u in self._ops.values())
        if total > self.peak_bytes:
            self.peak_bytes = total
