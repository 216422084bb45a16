"""LockWitness: a runtime lock-order witness (Python TSan-lite).

Static analysis proves thread-domain and blocking invariants, but the
lock-order deadlocks that killed real Ray clusters (GCS lock vs shard
lock vs store lock) are a *dynamic* property: the dangerous interleaving
never deadlocks in a test run, it just establishes A->B in one thread
and B->A in another and waits for production traffic to align them.
The witness makes that ordering error loud on ANY run that merely
*executes* both orders, deadlock or not — the same trick TSan's
deadlock detector and FreeBSD's WITNESS(4) use.

Mechanics: with the witness installed, ``threading.Lock``/``RLock``
construct wrapper locks tagged with their creation site (the first
stack frame outside threading/this module). Each thread keeps a stack
of held locks; acquiring B while holding A inserts the edge A->B into
a process-global held-before graph keyed by creation site. An edge
whose reverse path already exists is a lock-order violation: it is
recorded (with both acquisition stacks), counted, emitted as a CHAOS
``LOCK_ORDER`` flight-recorder event, and printed once per edge pair
— never silent, never a hang.

Grouping by creation *site* (not instance) is what lets one run
witness orders across different lock instances — the whole point.
The cost: N same-site sibling locks (the directory's per-shard locks)
would self-cycle if two siblings ever nested, so same-site edges are
ignored; a sibling-order inversion is invisible here (the sharded
directory never nests shard locks by construction).

Scope: locks created AFTER install() are witnessed; reentrant RLock
re-acquisition adds no edge (no false positive); ``Condition`` /
``Event`` / ``Queue`` built on witnessed locks work unchanged via the
``_release_save``/``_acquire_restore``/``_is_owned`` protocol.

Opt-in: set ``RAY_TPU_TORCH_lock_witness=1`` (tests/debug; ``python -m
ray_tpu_torch._lint --race`` runs the port's object-plane, chaos, actors
and lock-witness test files under it and fails on any inversion that any
process appends to its sidecar file) — the env var is
inherited, so DaemonCluster heads/raylets/workers self-install via
``maybe_install()`` at their entry points. Never enabled in
production paths by default.
"""
from __future__ import annotations

import os
import sys
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

import _thread

__all__ = [
    "install", "uninstall", "installed", "maybe_install", "enabled",
    "violations", "clear", "assert_clean", "witness_report",
    "LockOrderViolation",
]

ENV_VAR = "RAY_TPU_TORCH_lock_witness"
#: Optional sidecar file (inherited env): every process appends its
#: rendered violations here, so a race-smoke driver can fail the run
#: on an inversion witnessed inside a spawned head/raylet/worker —
#: in-memory violations() only ever sees THIS process.
FILE_ENV = "RAY_TPU_TORCH_lock_witness_file"

#: Original factories, captured at import (before any install).
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

_installed = False

#: Raw (never-witnessed) lock guarding the graph + violation list.
_graph_lock = _thread.allocate_lock()
#: site -> {successor site: (sample stack summary)}. "A held before B".
_edges: Dict[str, Dict[str, str]] = {}
#: (src, dst) pairs already reported — one report per ordered pair.
_reported: Set[Tuple[str, str]] = set()
_violations: List["LockOrderViolation"] = []
#: tid -> sites released ON THE HOLDER'S BEHALF by another thread
#: (Lock handoff patterns). Each thread's held stack is mutated only
#: by that thread, so a cross-thread release queues here and the
#: holder purges lazily at its next witness op — otherwise the
#: phantom entry would seed false held-before edges from a lock the
#: thread no longer holds. Guarded by _graph_lock.
_pending_release: Dict[int, List[str]] = {}
#: Unguarded membership probe (GIL-atomic reads) so the hot path pays
#: one set lookup, not a lock acquisition; mutated under _graph_lock.
_pending_tids: Set[int] = set()

_tls = threading.local()


class LockOrderViolation:
    """One observed lock-order inversion."""

    __slots__ = ("first", "second", "path", "stack", "prior_stack")

    def __init__(self, first: str, second: str, path: List[str],
                 stack: str, prior_stack: str):
        self.first = first      # site acquired first (held)
        self.second = second    # site acquired while holding `first`
        self.path = path        # existing second->...->first chain
        self.stack = stack      # this acquisition's stack
        self.prior_stack = prior_stack  # sample stack of reverse edge

    def render(self) -> str:
        chain = " -> ".join(self.path)
        return (
            f"lock-order inversion: acquiring {self.second} while "
            f"holding {self.first}, but the reverse order "
            f"({chain}) was already witnessed\n"
            f"--- this acquisition ---\n{self.stack}"
            f"--- prior reverse-order acquisition ---\n"
            f"{self.prior_stack}"
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<LockOrderViolation {self.first} <-> {self.second}>"


def _held_stack() -> List[str]:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def _creation_site() -> str:
    """file:line of the frame that created the lock — first frame
    outside threading.py and this module, so an Event's internal lock
    is attributed to the Event() call site, not threading.py. The path
    is repo-relative (full path outside the repo), never a bare
    basename: two x.py:N in different directories must not merge into
    one graph node (a merge can fabricate an inversion between locks
    that never interact, or mask a real one)."""
    skip = (_WITNESS_FILE, threading.__file__)
    for frame in reversed(traceback.extract_stack()):
        if frame.filename not in skip:
            rel = os.path.relpath(frame.filename, _SITE_ROOT)
            if rel.startswith(".."):
                rel = frame.filename
            return f"{rel}:{frame.lineno}"
    return "<unknown>"


_WITNESS_FILE = os.path.abspath(__file__)
#: Repo root (…/ray_tpu_torch/_private/lock_witness.py -> three up).
_SITE_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(_WITNESS_FILE))
)


def _brief_stack(limit: int = 12) -> str:
    frames = traceback.extract_stack()
    # Drop witness-internal frames from the tail.
    while frames and frames[-1].filename == _WITNESS_FILE:
        frames.pop()
    return "".join(traceback.format_list(frames[-limit:]))


def _note_acquired(site: str) -> None:
    held = _held_stack()
    tid = threading.get_ident()
    if tid in _pending_tids:
        _drain_pending(tid, held)
    if held:
        _add_edge(held[-1], site)
    held.append(site)


def _note_released(site: str) -> None:
    held = _held_stack()
    tid = threading.get_ident()
    if tid in _pending_tids:
        _drain_pending(tid, held)
    # Remove the LAST occurrence: releases may come out of order.
    # A release by a thread that never acquired (Lock handoff) never
    # reaches here — WitnessLock.release routes it to _pending_release
    # for the holder to purge.
    for i in range(len(held) - 1, -1, -1):
        if held[i] == site:
            del held[i]
            return


def _drain_pending(tid: int, held: List[str]) -> None:
    """Purge sites a cross-thread release queued for this thread."""
    with _graph_lock:
        sites = _pending_release.pop(tid, None)
        _pending_tids.discard(tid)
    for site in sites or ():
        for i in range(len(held) - 1, -1, -1):
            if held[i] == site:
                del held[i]
                break


def _add_edge(src: str, dst: str) -> None:
    if src == dst:
        # Same creation site (sibling locks, e.g. per-shard): order
        # between siblings is not witnessable at site granularity.
        return
    with _graph_lock:
        succ = _edges.setdefault(src, {})
        if dst in succ:
            return  # known edge: O(1) on the hot path
        # New edge: does the reverse path dst ->* src already exist?
        path = _find_path(dst, src)
        succ[dst] = _brief_stack()
        if path is None:
            return
        if (src, dst) in _reported or (dst, src) in _reported:
            return
        _reported.add((src, dst))
        prior = _edges.get(path[0], {}).get(path[1], "") if len(
            path
        ) > 1 else ""
        v = LockOrderViolation(
            first=src, second=dst, path=path,
            stack=_brief_stack(), prior_stack=prior,
        )
        _violations.append(v)
    # Outside the graph lock: report. Loud but non-fatal — raising in
    # an arbitrary runtime thread would wedge the victim process worse
    # than the potential deadlock being reported.
    sys.stderr.write(f"[lock-witness] {v.render()}\n")
    side = os.environ.get(FILE_ENV)
    if side:
        try:
            with open(side, "a", encoding="utf-8") as f:
                f.write(f"[pid {os.getpid()}] {v.render()}\n")
        except OSError:
            pass  # reporting channel, never a crash source
    try:
        from . import events as _events

        _events.record(
            _events.CHAOS, "lock-witness", "LOCK_ORDER",
            {"first": v.first, "second": v.second,
             "path": list(v.path)},
        )
    except Exception:  # raylint: disable=swallowed-fault -- the violation was already reported to stderr above; the recorder event is best-effort garnish
        pass


def _find_path(start: str, goal: str) -> Optional[List[str]]:
    """DFS over the held-before graph; caller holds _graph_lock."""
    stack = [(start, [start])]
    seen = {start}
    while stack:
        node, path = stack.pop()
        if node == goal:
            return path
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


# ----------------------------------------------------------- lock wrappers


class WitnessLock:
    """Drop-in ``threading.Lock`` that feeds the witness graph."""

    __slots__ = ("_inner", "_site", "_holder")

    def __init__(self):
        self._inner = _thread.allocate_lock()
        self._site = _creation_site()
        self._holder: Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._holder = threading.get_ident()
            _note_acquired(self._site)
        return ok

    def release(self) -> None:
        holder, me = self._holder, threading.get_ident()
        self._holder = None
        if holder is not None and holder != me:
            # Handoff: acquired by another thread. Queue the phantom
            # for the holder to purge BEFORE releasing the inner lock,
            # so the holder's next witness op can't build an edge from
            # a lock it no longer holds.
            with _graph_lock:
                _pending_release.setdefault(holder, []).append(
                    self._site
                )
                _pending_tids.add(holder)
            self._inner.release()
            return
        self._inner.release()
        _note_released(self._site)

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # CPython's os.register_at_fork handlers (threading internals,
        # concurrent.futures, logging) reinit locks in the child
        # INSTEAD of releasing them. Mirror the release for the
        # witness bookkeeping too: the before-fork hooks acquired this
        # lock on the forking thread, so without the pop the child
        # keeps a phantom held entry that fabricates inversions (seen
        # live: logging._lock "held" at interpreter shutdown while
        # _python_exit takes futures' _global_shutdown_lock).
        self._inner._at_fork_reinit()
        self._holder = None
        _note_released(self._site)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover
        return f"<WitnessLock {self._site} {self._inner!r}>"


class WitnessRLock:
    """Drop-in ``threading.RLock``: reentrant re-acquisition adds no
    edge; implements the Condition protocol (_release_save etc.) so
    ``threading.Condition(WitnessRLock())`` works unchanged."""

    __slots__ = ("_inner", "_site", "_owner", "_count")

    def __init__(self):
        self._inner = _REAL_RLOCK()
        self._site = _creation_site()
        self._owner: Optional[int] = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        me = threading.get_ident()
        if self._owner == me:
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                self._count += 1
            return ok
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._owner = me
            self._count = 1
            _note_acquired(self._site)
        return ok

    __enter__ = acquire

    def release(self) -> None:
        if self._owner != threading.get_ident():
            raise RuntimeError("cannot release un-acquired lock")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            _note_released(self._site)
        self._inner.release()

    def __exit__(self, *exc) -> None:
        self.release()

    def _at_fork_reinit(self) -> None:
        # See WitnessLock._at_fork_reinit: reinit-in-child stands in
        # for a release, so drop the witness held entry as well
        # (logging._lock is an RLock and reinits through here).
        self._inner._at_fork_reinit()
        self._owner = None
        self._count = 0
        _note_released(self._site)

    # Condition protocol -------------------------------------------------

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _recursion_count(self) -> int:
        # The RLock API multiprocessing's resource tracker reads (Python
        # 3.12) before it starts its process: the calling thread's depth.
        return self._count if self._owner == threading.get_ident() else 0

    def _release_save(self):
        count = self._count
        self._count = 0
        self._owner = None
        _note_released(self._site)
        state = self._inner._release_save()
        return (count, state)

    def _acquire_restore(self, saved) -> None:
        count, state = saved
        self._inner._acquire_restore(state)
        self._owner = threading.get_ident()
        self._count = count
        _note_acquired(self._site)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<WitnessRLock {self._site} count={self._count}>"


# ------------------------------------------------------------ install API


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") not in ("", "0", "false")


def installed() -> bool:
    return _installed


def install() -> None:
    """Patch threading.Lock/RLock to witnessed factories. Locks
    created before this call stay raw (un-witnessed)."""
    global _installed
    if _installed:
        return
    threading.Lock = WitnessLock
    threading.RLock = WitnessRLock
    _installed = True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    _installed = False


def maybe_install() -> bool:
    """Entry-point hook (conftest, head_main, worker_main, node
    daemons): install iff the env opt-in is set, so one env var arms
    the witness across every process of a test cluster."""
    if enabled():
        install()
    return _installed


def violations() -> List[LockOrderViolation]:
    with _graph_lock:
        return list(_violations)


def clear() -> None:
    """Reset graph + findings (test isolation)."""
    with _graph_lock:
        _edges.clear()
        _reported.clear()
        del _violations[:]
        _pending_release.clear()
        _pending_tids.clear()


def assert_clean() -> None:
    vs = violations()
    if vs:
        raise AssertionError(
            f"{len(vs)} lock-order violation(s):\n\n"
            + "\n\n".join(v.render() for v in vs)
        )


def witness_report() -> Dict[str, object]:
    """Graph stats for debugging/CI logs."""
    with _graph_lock:
        return {
            "sites": len(_edges),
            "edges": sum(len(s) for s in _edges.values()),
            "violations": len(_violations),
        }
