"""Per-node log monitor: tail worker log files, publish to the driver.

Reference: python/ray/_private/log_monitor.py (per-node tailer shipping
worker stdout/stderr to drivers) + ray_logging/__init__.py:259-294
(dedup of identical lines flooding from many workers). Each node — the
head and every raylet — runs one LogMonitor over its session logs dir;
new lines batch into control-plane messages, the GCS keeps a bounded
ring of recent lines, and drivers that subscribed
get them pushed and printed with a ``(worker=... node=...)`` prefix.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Tuple

SCAN_INTERVAL_S = 0.25
# Dedup window: identical lines from different workers within this many
# seconds collapse into one line + a repeat counter.
DEDUP_WINDOW_S = 5.0
MAX_BATCH_LINES = 500

# Task-context marker a worker's _TaggedStream (worker_main.py) frames
# into its stdout: "\x1et=<task_id_hex>\x1e<line>". Lifted out of the
# line and into the worker tag here, so the dashboard log viewer can
# correlate a log line to its flight-recorder timeline row while the
# visible line stays untouched.
_TASK_MARK = "\x1et="


def _tag_line(tag: str, line: str):
    """(worker_tag, line) with any task marker folded into the tag."""
    if line.startswith(_TASK_MARK):
        end = line.find("\x1e", len(_TASK_MARK))
        if end > 0:
            tid = line[len(_TASK_MARK):end]
            return (f"{tag} task={tid[:12]}", line[end + 1:])
    return (tag, line)


class LogMonitor:
    def __init__(
        self,
        logs_dir: str,
        publish: Callable[[List[Tuple[str, str]]], None],
    ):
        self._dir = logs_dir
        self._publish = publish
        self._offsets: Dict[str, int] = {}
        self._partial: Dict[str, bytes] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="log-monitor", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(SCAN_INTERVAL_S):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - keep tailing
                pass

    def poll_once(self):
        """One scan pass (exposed for tests and final flushes)."""
        if not os.path.isdir(self._dir):
            return
        entries: List[Tuple[str, str]] = []  # (worker_tag, line)
        for fname in sorted(os.listdir(self._dir)):
            if not (fname.startswith("worker-") and fname.endswith(".out")):
                continue
            path = os.path.join(self._dir, fname)
            tag = fname[len("worker-"):-len(".out")]
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = self._offsets.get(fname, 0)
            if size <= off:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    data = f.read(min(size - off, 1 << 20))
            except OSError:
                continue
            self._offsets[fname] = off + len(data)
            data = self._partial.pop(fname, b"") + data
            *lines, tail = data.split(b"\n")
            if tail:
                self._partial[fname] = tail
            for raw in lines:
                line = raw.decode(errors="replace").rstrip("\r")
                if line:
                    entries.append(_tag_line(tag, line))
            if len(entries) >= MAX_BATCH_LINES:
                # Bound message size without losing lines (offsets only
                # cover bytes actually read): flush and keep scanning.
                self._publish(entries)
                entries = []
        if entries:
            self._publish(entries)


class LogDeduplicator:
    """Collapse identical lines arriving from many workers in a short
    window (reference: ray_logging dedup — '[repeated Nx across
    cluster]')."""

    def __init__(self, window_s: float = DEDUP_WINDOW_S):
        self._window = window_s
        self._seen: Dict[str, Tuple[float, int]] = {}

    def filter(self, entries: List[Tuple[str, str, str]]):
        """entries: (node, worker, line) -> entries to emit now."""
        now = time.time()
        out = []
        for node, worker, line in entries:
            first, count = self._seen.get(line, (0.0, 0))
            if now - first > self._window:
                if count > 1:
                    # Window expired with suppressed repeats: summarize
                    # them before emitting the fresh occurrence.
                    out.append(
                        (node, worker,
                         f"[repeated {count - 1}x across cluster] {line}")
                    )
                self._seen[line] = (now, 1)
                out.append((node, worker, line))
            else:
                self._seen[line] = (first, count + 1)
        # Opportunistic GC of old window entries.
        if len(self._seen) > 4096:
            cutoff = now - self._window
            self._seen = {
                k: v for k, v in self._seen.items() if v[0] >= cutoff
            }
        return out

    def flush_repeats(self):
        """Emit summaries for lines suppressed inside the window."""
        now = time.time()
        out = []
        for line, (first, count) in list(self._seen.items()):
            if count > 1 and now - first > self._window:
                out.append(("", "", f"[repeated {count - 1}x] {line}"))
                self._seen[line] = (first, 1)
        return out
