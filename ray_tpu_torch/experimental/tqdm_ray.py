"""Distributed-safe progress bars (reference:
python/ray/experimental/tqdm_ray.py).

Plain tqdm inside a worker writes control characters into a log file
nobody watches, and N workers each drawing their own bar corrupt the
driver terminal. Here a worker-side ``tqdm`` emits one structured
line per update with a magic prefix into its stdout; the existing log
pipeline ships worker stdout to the driver (gcs log_batch push), whose
log printer routes magic lines to a renderer instead of echoing them —
bars from any number of workers multiplex onto the driver terminal,
throttled, one line per bar.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, Iterable, Optional

MAGIC = "__rtpt_tqdm__:"

_lock = threading.Lock()
_instance_counter = 0

# Driver-side bar registry: uid -> state dict (desc, n, total, done).
_bars: Dict[str, Dict[str, Any]] = {}
_last_render = 0.0


class tqdm:
    """Worker- (or driver-) side progress emitter, tqdm-call-compatible
    for the common surface: iterable wrapping, update(), set_description,
    close()."""

    def __init__(self, iterable: Optional[Iterable] = None, desc: str = "",
                 total: Optional[int] = None, position: Optional[int] = None,
                 **_ignored):
        global _instance_counter
        with _lock:
            _instance_counter += 1
            self._uid = f"{os.getpid()}-{_instance_counter}"
        self._iterable = iterable
        self.desc = desc
        if total is None and iterable is not None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        self.total = total
        self.n = 0
        self._emit()

    # ------------------------------------------------------------- protocol
    def __iter__(self):
        for x in self._iterable:
            yield x
            self.update(1)
        self.close()

    def update(self, n: int = 1) -> None:
        self.n += n
        self._emit()

    def set_description(self, desc: str) -> None:
        self.desc = desc
        self._emit()

    def close(self) -> None:
        self._emit(done=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------------- wire
    def _emit(self, done: bool = False) -> None:
        line = MAGIC + json.dumps(
            {
                "uid": self._uid,
                "desc": self.desc,
                "n": self.n,
                "total": self.total,
                "done": done,
            }
        )
        # stdout: the log monitor tails it and the driver's log printer
        # de-multiplexes the magic prefix. On the driver itself the
        # printer is called directly below.
        if _is_driver():
            handle_magic_line(line)
        else:
            print(line, flush=True)


def _is_driver() -> bool:
    from ray_tpu_torch._private.worker import _global

    return getattr(_global, "mode", None) != "worker"


def handle_magic_line(line: str) -> bool:
    """Driver-side: if `line` is a tqdm control line, absorb it into the
    bar registry (rendering throttled) and return True; else False."""
    if not line.startswith(MAGIC):
        return False
    try:
        st = json.loads(line[len(MAGIC):])
    except ValueError:
        return False
    with _lock:
        if st.get("done"):
            _bars.pop(st["uid"], None)
        else:
            _bars[st["uid"]] = st
    _render()
    return True


def _render(force: bool = False) -> None:
    global _last_render
    now = time.monotonic()
    with _lock:
        if not force and now - _last_render < 0.5:
            return
        _last_render = now
        snapshot = list(_bars.values())
    out = sys.stderr
    for st in snapshot:
        total = st.get("total")
        frac = f"{st['n']}/{total}" if total else str(st["n"])
        desc = st.get("desc") or "progress"
        out.write(f"[{desc}] {frac}\n")
    out.flush()


def bars() -> Dict[str, Dict[str, Any]]:
    """Driver-side snapshot of live bars (observability/tests)."""
    with _lock:
        return {k: dict(v) for k, v in _bars.items()}
