"""Spans of a rank's own step: where its compute stream waits for an
exchange, and where a pipeline stage computes.

Off by default, and then each `span(name)` is a `nullcontext`. Inside
`recording(device)` every span records a pair of CUDA events on the
current stream (on the CPU, the host clock), so a span around an
exchange's wait measures how long the rank's kernels stood still for it
(zero when the transfer finished behind the kernels queued before it),
and a span around a stage's tick measures that tick's compute on the
device. The names the layouts record:

- `shift_wait`: `parallel.ring.Shift.wait` (the ring's k/v and gradient
  shifts, the pipeline's activation shifts);
- `pipeline` and `stage`: `parallel.pipeline`'s whole forward and
  backward schedules, and each tick's stage compute (forward) or VJP
  (backward) within them;
- `moe_all_reduce`: the MoE layer's sums over the expert (and tensor)
  group (`parallel.collectives`' three autograd functions);
- `grad_all_reduce`: `parallel.step`'s gradient and loss reductions.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch


class Spans:
    """Recorded spans; `totals()` sums them by name."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._records: List[Tuple[str, object, object]] = []

    def reset(self) -> None:
        self._records.clear()

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self._records.append((name, start, end))

    def totals(self) -> Dict[str, Dict[str, float]]:
        """{name: {"count", "ms"}} over the spans recorded since the last
        `reset`; waits for the device first."""
        if self.cuda:
            torch.cuda.synchronize()
        out: Dict[str, Dict[str, float]] = {}
        for name, start, end in self._records:
            ms = start.elapsed_time(end) if self.cuda else (end - start) * 1e3
            entry = out.setdefault(name, {"count": 0, "ms": 0.0})
            entry["count"] += 1
            entry["ms"] += ms
        return out


_ACTIVE: Optional[Spans] = None


def span(name: str):
    """A span of `name` while `recording`, else nothing."""
    return _ACTIVE.span(name) if _ACTIVE is not None else contextlib.nullcontext()


@contextlib.contextmanager
def recording(device: torch.device) -> Iterator[Spans]:
    """Records every `span` of this process until the block ends."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, Spans(device)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = previous
