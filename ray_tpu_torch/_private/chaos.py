"""Deterministic chaos engine + shared resilience primitives.

Reference: the reference ships a real chaos model
(python/ray/tests/test_chaos.py — get_and_run_resource_killer over
nodes/workers/EC2 instances) and a one-knob delay injector
(RAY_testing_asio_delay_us, ray_config_def.h:832). This module
generalizes both into one seed-driven :class:`FaultSchedule` woven into
the transport boundary (protocol.PeerConn deliver), the connect path
(transport.connect), and named process phase boundaries (kill points at
flight-recorder event sites), plus the resilience primitives the
runtime's retry paths share:

- :class:`Backoff` / :func:`retry_call` — ONE exponential-backoff
  implementation (full jitter, cap, optional budget) replacing the
  scattered fixed sleeps in pulls, lease growth, and head reconnects,
  so brief head unavailability degrades gracefully instead of
  stampeding (reference: exponential backoff on GCS reconnect,
  gcs_rpc_client.h).

- :class:`InOrderSequencer` — per-connection sequence-number reorder
  buffer with bounded gap skip; the GCS runs one per client conn so
  ``ref_flush`` batches apply in submission order even when the chaos
  engine (or a future lossy transport) duplicates, drops, or reorders
  them.

Fault spec grammar (config ``chaos_spec`` / env ``RAY_TPU_TORCH_chaos_spec``,
comma-separated entries):

    <mtype>=<action>:<p>[:<a>[:<b>]][@<limit>][?role=<role>]
        action ∈ delay (a..b microseconds) | drop | dup | reorder
        p       firing probability per message (seeded stream)
        @limit  fire at most <limit> times (deterministic windows)
        ?role   only in processes of that role (driver|worker|raylet)

    kill:<point>=<nth>[?role=<role>]        kill on the nth hit
    kill:<point>=p:<prob>[?role=<role>]     probabilistic kill

    <fault>:<point>=<nth> | p:<prob>        storage-plane fault points
        fault ∈ io_error | disk_full | truncate — consulted by the
        spill pipeline via :func:`fault_point` (io_error:spill_write,
        disk_full:spill, truncate:spill_file): instead of killing the
        process, the hook site injects the named failure (EIO, ENOSPC,
        a truncated file) and the degradation ladder must absorb it.

    throttle:<roleA><-><roleB>=<bytes_per_s>[:<start_s>[:<heal_after_s>]][?dir=...]
        Sustained bandwidth degradation between two process roles: a
        token bucket at BOTH PeerConn boundaries (sender paces before
        the write, receiver paces after the read) limits the link to
        ``bytes_per_s`` from ``start_s`` until ``start_s +
        heal_after_s`` (no heal term = degraded forever). This is the
        gray failure a binary partition cannot model: every frame
        still arrives, heartbeats keep landing, but 10-100x late —
        the straggler substrate the health scorer and hedging layer
        must catch. Windows share the partition epoch
        (``RAY_TPU_TORCH_chaos_epoch``); pacing is a pure function of bytes
        seen, so a seeded run replays. Transitions record
        THROTTLE_BEGIN / THROTTLE_HEAL chaos events.

    slowexec:<task_glob>=<factor>[:<start_s>[:<heal_after_s>]]
        Execution-time stretch: a task whose name matches
        ``task_glob`` (fnmatch) runs ``factor``x slower — the worker
        sleeps (factor-1) x elapsed after user code returns. Models a
        cpu-starved/thermally-throttled worker without touching user
        code; epoch-windowed like throttle. First stretched task
        records a SLOWEXEC chaos event.

    partition:<roleA><-><roleB>=<start_s>[:<heal_after_s>][?dir=both|a2b|b2a]
        Sustained link cut between two process roles: every PeerConn
        frame flowing a blocked direction is blackholed (the TCP
        connection stays ESTABLISHED — the gray failure a heartbeat
        sweeper must catch) from ``start_s`` until
        ``start_s + heal_after_s`` (no heal term = cut forever).
        ``dir=a2b`` cuts only roleA→roleB traffic (asymmetric
        partition); ``b2a`` the reverse; default both. Windows are
        measured from a shared epoch (env ``RAY_TPU_TORCH_chaos_epoch``,
        else this schedule's install time) so every process in the
        fleet agrees on when the cut begins and heals. Because the
        sender's AND the receiver's schedule both enforce the cut,
        installing the spec in only one side's processes still cuts
        both directions of its links. Transitions record
        PARTITION_BEGIN / PARTITION_HEAL chaos events.

Determinism: every rule draws from its own ``random.Random`` seeded by
sha256(seed, rule-text) — the nth decision of a rule is a pure function
of (seed, rule, n), so a failed run replays with one env var
(``RAY_TPU_TORCH_chaos_seed``). Every injected fault records a CHAOS
flight-recorder event so a red run is attributable from the timeline.
"""
from __future__ import annotations

import hashlib
import os
import random
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import events as _events

__all__ = [
    "Backoff",
    "retry_call",
    "FaultSchedule",
    "InOrderSequencer",
    "install",
    "refresh",
    "active",
    "kill_point",
    "fault_point",
    "partition_blocks",
    "throttled",
    "throttle_pace",
    "slowexec_stretch",
    "mtype_of",
]

#: Rule-name prefixes parsed as storage fault points (vs message rules).
_FAULT_PREFIXES = ("io_error:", "disk_full:", "truncate:")


# ------------------------------------------------------------------ backoff


class Backoff:
    """Exponential backoff with full jitter and an optional budget.

    The single retry-delay policy for the runtime (pulls, lease growth,
    raylet head-reconnect, bench backend probes). Full jitter
    (delay ~ U[0, current]) de-correlates a fleet of retriers so a head
    blip doesn't turn into a reconnect stampede; pass a seeded ``rng``
    for deterministic schedules in tests.
    """

    def __init__(
        self,
        base_s: float = 0.1,
        cap_s: float = 5.0,
        multiplier: float = 2.0,
        budget_s: Optional[float] = None,
        rng: Optional[random.Random] = None,
    ):
        self.base_s = base_s
        self.cap_s = cap_s
        self.multiplier = multiplier
        self.budget_s = budget_s
        self._rng = rng or random
        self._current = base_s
        self._spent = 0.0
        self.attempts = 0

    def next_delay(self) -> float:
        """The next sleep (full jitter in (0, current]); grows the
        window toward the cap."""
        cur = self._current
        self._current = min(self.cap_s, cur * self.multiplier)
        self.attempts += 1
        # Floor at base/4 so jitter never collapses to a busy-loop.
        d = max(self.base_s / 4.0, self._rng.uniform(0.0, cur))
        if self.budget_s is not None:
            d = min(d, max(0.0, self.budget_s - self._spent))
        self._spent += d
        return d

    def exhausted(self) -> bool:
        return self.budget_s is not None and self._spent >= self.budget_s

    def sleep(self) -> bool:
        """Sleep the next delay. False once the budget is spent."""
        if self.exhausted():
            return False
        d = self.next_delay()
        if d > 0:
            time.sleep(d)
        return not self.exhausted()

    def reset(self) -> None:
        self._current = self.base_s
        self._spent = 0.0
        self.attempts = 0


def retry_call(
    fn: Callable[[], Any],
    retry_on: Tuple[type, ...] = (OSError, TimeoutError),
    backoff: Optional[Backoff] = None,
    deadline_s: Optional[float] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> Any:
    """Call ``fn`` until it succeeds, an unlisted exception escapes, the
    backoff budget runs out, or ``deadline_s`` passes. The last caught
    exception re-raises on exhaustion."""
    bo = backoff or Backoff()
    deadline = None if deadline_s is None else time.monotonic() + deadline_s
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 - retry loop by design
            attempt += 1
            if deadline is not None and time.monotonic() >= deadline:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if not bo.sleep():
                raise


# --------------------------------------------------------------- sequencer


class InOrderSequencer:
    """Reorder/dedup buffer for sequence-numbered message batches.

    ``offer(seq, msg)`` returns the batches now deliverable in order.
    ``start_seq`` fixes the expected first sequence number; senders
    whose numbering restarts with their connection (the ref_flush
    tracker always starts at 1 on a fresh conn) MUST pass it —
    otherwise a dropped first batch would make its later retransmit
    look below-baseline and be discarded as a duplicate, losing edges
    the at-least-once protocol exists to deliver. With ``start_seq``
    None the first seq seen is the baseline (mid-stream attach).
    Duplicates (seq already applied) return nothing. A gap that
    neither fills within ``gap_timeout_s`` nor stays under
    ``max_buffered`` is SKIPPED — buffered batches flush in order and
    the skip is counted, never silent (the pre-sequencer behavior was
    to apply everything immediately, so a bounded skip is strictly no
    worse)."""

    def __init__(self, gap_timeout_s: float = 5.0, max_buffered: int = 64,
                 start_seq: Optional[int] = None):
        self.gap_timeout_s = gap_timeout_s
        self.max_buffered = max_buffered
        self._next: Optional[int] = start_seq
        self._buf: Dict[int, Any] = {}
        self._gap_since: Optional[float] = None
        self.skipped_gaps = 0
        self.duplicates = 0

    def offer(self, seq: int, msg: Any,
              now: Optional[float] = None) -> List[Any]:
        now = time.monotonic() if now is None else now
        if self._next is None:
            self._next = seq
        if seq < self._next:
            self.duplicates += 1
            return []
        self._buf[seq] = msg
        out: List[Any] = []
        while self._next in self._buf:
            out.append(self._buf.pop(self._next))
            self._next += 1
        if not self._buf:
            self._gap_since = None
            return out
        if self._gap_since is None:
            self._gap_since = now
        if (
            now - self._gap_since > self.gap_timeout_s
            or len(self._buf) > self.max_buffered
        ):
            # Give up on the gap: the missing batch is lost for good
            # (sender died un-retransmitted). Flush in order.
            self.skipped_gaps += 1
            for s in sorted(self._buf):
                out.append(self._buf.pop(s))
                self._next = s + 1
            self._gap_since = None
        return out


# ------------------------------------------------------------- fault rules


def _derive_rng(seed: int, key: str) -> random.Random:
    # sha256, not hash(): builtin hash is salted per process and would
    # break same-seed-same-sequence across processes/runs.
    digest = hashlib.sha256(f"{seed}:{key}".encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


class _MsgRule:
    __slots__ = (
        "mtype", "action", "p", "lo_us", "hi_us", "limit", "role",
        "key", "rng", "fired", "hits",
    )

    def __init__(self, mtype, action, p, lo_us, hi_us, limit, role, key, rng):
        self.mtype = mtype
        self.action = action
        self.p = p
        self.lo_us = lo_us
        self.hi_us = hi_us
        self.limit = limit
        self.role = role
        self.key = key
        self.rng = rng
        self.fired = 0
        self.hits = 0


class _KillRule:
    __slots__ = ("point", "nth", "p", "role", "key", "rng", "hits", "fired")

    def __init__(self, point, nth, p, role, key, rng):
        self.point = point
        self.nth = nth
        self.p = p
        self.role = role
        self.key = key
        self.rng = rng
        self.hits = 0
        self.fired = 0


class _PartitionRule:
    __slots__ = (
        "role_a", "role_b", "start_s", "heal_s", "direction", "key",
        "began", "healed",
    )

    def __init__(self, role_a, role_b, start_s, heal_s, direction, key):
        self.role_a = role_a
        self.role_b = role_b
        self.start_s = start_s
        # Absolute offset from the epoch at which the link heals
        # (None = never).
        self.heal_s = heal_s
        self.direction = direction  # both | a2b | b2a
        self.key = key
        self.began = False
        self.healed = False

    def covers(self, src: str, dst: str) -> bool:
        if self.direction in ("both", "a2b") and (
            src == self.role_a and dst == self.role_b
        ):
            return True
        return self.direction in ("both", "b2a") and (
            src == self.role_b and dst == self.role_a
        )


class _ThrottleRule:
    """Token-bucket link degradation between two roles.

    ``next_free`` is the virtual clock of the modeled slow link: the
    epoch-relative instant its transmit queue drains. Each frame
    advances it by size/rate; the caller sleeps until its own frame
    has "transmitted". Pure function of (bytes seen, window), so a
    seeded run replays byte-for-byte."""

    __slots__ = (
        "role_a", "role_b", "rate", "start_s", "heal_s", "direction",
        "key", "began", "healed", "next_free",
    )

    def __init__(self, role_a, role_b, rate, start_s, heal_s, direction,
                 key):
        self.role_a = role_a
        self.role_b = role_b
        self.rate = float(rate)  # bytes per second
        self.start_s = start_s
        self.heal_s = heal_s  # absolute epoch offset (None = never)
        self.direction = direction
        self.key = key
        self.began = False
        self.healed = False
        self.next_free = 0.0

    def covers(self, src: str, dst: str) -> bool:
        if self.direction in ("both", "a2b") and (
            src == self.role_a and dst == self.role_b
        ):
            return True
        return self.direction in ("both", "b2a") and (
            src == self.role_b and dst == self.role_a
        )


class _SlowExecRule:
    __slots__ = ("pattern", "factor", "start_s", "heal_s", "key", "began")

    def __init__(self, pattern, factor, start_s, heal_s, key):
        self.pattern = pattern
        self.factor = float(factor)
        self.start_s = start_s
        self.heal_s = heal_s
        self.key = key
        self.began = False


def current_role() -> str:
    """Coarse process role for rule scoping. Workers carry
    RAY_TPU_TORCH_WORKER_ID from spawn; raylets set RAY_TPU_TORCH_CHAOS_ROLE."""
    if os.environ.get("RAY_TPU_TORCH_CHAOS_ROLE"):
        return os.environ["RAY_TPU_TORCH_CHAOS_ROLE"]
    if os.environ.get("RAY_TPU_TORCH_WORKER_ID"):
        return "worker"
    return "driver"


class FaultSchedule:
    """Seeded, rule-driven fault injection.

    One instance per process (module global ``_active``); the transport
    and phase-boundary hooks consult it. All decision state is guarded
    by one lock — fault paths are cold by construction (p << 1), so the
    lock never shows on a clean run's profile."""

    def __init__(self, spec: str, seed: int = 0,
                 legacy_delay_spec: str = ""):
        self.seed = int(seed)
        self.spec = spec
        self._lock = threading.Lock()
        self._msg_rules: Dict[str, List[_MsgRule]] = {}
        self._kill_rules: Dict[str, List[_KillRule]] = {}
        # Storage fault points, keyed by full rule name
        # ("io_error:spill_write") — same nth/probability grammar as
        # kill rules, but the hook site injects a failure instead of
        # dying (_KillRule is reused as the decision record).
        self._fault_rules: Dict[str, List[_KillRule]] = {}
        self._partition_rules: List[_PartitionRule] = []
        self._throttle_rules: List[_ThrottleRule] = []
        self._slowexec_rules: List[_SlowExecRule] = []
        # Shared time base for partition windows: every process in the
        # fleet must agree on when a cut begins/heals, so the epoch
        # rides the environment (the soak exports it before spawning
        # anything); a process without it anchors at install time.
        try:
            self._epoch = float(os.environ.get("RAY_TPU_TORCH_chaos_epoch", ""))
        except ValueError:
            self._epoch = 0.0
        if not self._epoch:
            self._epoch = time.time()
        self.stats: Dict[str, int] = {}
        self._role = current_role()
        for i, entry in enumerate(e for e in spec.split(",") if e.strip()):
            self._parse_entry(entry.strip(), i)
        if legacy_delay_spec:
            # RAY_testing_asio_delay_us compatibility: "mtype=lo:hi"
            # microsecond delays become always-firing delay rules.
            for i, entry in enumerate(
                e for e in legacy_delay_spec.split(",") if "=" in e
            ):
                name, rng_ = entry.split("=", 1)
                lo, hi = rng_.split(":")
                key = f"legacy:{entry}"
                self._add_msg_rule(_MsgRule(
                    name, "delay", 1.0, float(lo), float(hi), None, None,
                    key, _derive_rng(self.seed, key),
                ))

    # ------------------------------------------------------------- parsing

    def _parse_entry(self, entry: str, index: int) -> None:
        role = None
        direction = "both"
        if "?dir=" in entry:
            entry, direction = entry.split("?dir=", 1)
            if direction not in ("both", "a2b", "b2a"):
                raise ValueError(
                    f"unknown partition direction {direction!r}"
                )
        if "?role=" in entry:
            entry, role = entry.split("?role=", 1)
        name, _, value = entry.partition("=")
        if not value:
            raise ValueError(f"chaos_spec entry missing '=': {entry!r}")
        key = f"{index}:{entry}"
        rng = _derive_rng(self.seed, key)
        if name.startswith("partition:"):
            pair = name[len("partition:"):]
            if "<->" not in pair:
                raise ValueError(
                    f"partition rule needs '<roleA><-><roleB>': {entry!r}"
                )
            role_a, role_b = pair.split("<->", 1)
            parts = value.split(":")
            start_s = float(parts[0])
            heal_s = (
                start_s + float(parts[1]) if len(parts) > 1 else None
            )
            self._partition_rules.append(
                _PartitionRule(
                    role_a.strip(), role_b.strip(), start_s, heal_s,
                    direction, key,
                )
            )
            return
        if name.startswith("throttle:"):
            pair = name[len("throttle:"):]
            if "<->" not in pair:
                raise ValueError(
                    f"throttle rule needs '<roleA><-><roleB>': {entry!r}"
                )
            role_a, role_b = pair.split("<->", 1)
            parts = value.split(":")
            rate = float(parts[0])
            if rate <= 0:
                raise ValueError(f"throttle rate must be > 0: {entry!r}")
            start_s = float(parts[1]) if len(parts) > 1 else 0.0
            heal_s = (
                start_s + float(parts[2]) if len(parts) > 2 else None
            )
            self._throttle_rules.append(
                _ThrottleRule(
                    role_a.strip(), role_b.strip(), rate, start_s,
                    heal_s, direction, key,
                )
            )
            return
        if name.startswith("slowexec:"):
            pattern = name[len("slowexec:"):]
            parts = value.split(":")
            factor = float(parts[0])
            if factor < 1.0:
                raise ValueError(
                    f"slowexec factor must be >= 1: {entry!r}"
                )
            start_s = float(parts[1]) if len(parts) > 1 else 0.0
            heal_s = (
                start_s + float(parts[2]) if len(parts) > 2 else None
            )
            self._slowexec_rules.append(
                _SlowExecRule(pattern, factor, start_s, heal_s, key)
            )
            return
        if name.startswith("kill:"):
            point = name[len("kill:"):]
            if value.startswith("p:"):
                rule = _KillRule(point, None, float(value[2:]), role, key, rng)
            else:
                rule = _KillRule(point, int(value), None, role, key, rng)
            self._kill_rules.setdefault(point, []).append(rule)
            return
        if name.startswith(_FAULT_PREFIXES):
            if value.startswith("p:"):
                rule = _KillRule(name, None, float(value[2:]), role, key, rng)
            else:
                rule = _KillRule(name, int(value), None, role, key, rng)
            self._fault_rules.setdefault(name, []).append(rule)
            return
        limit = None
        if "@" in value:
            value, lim = value.rsplit("@", 1)
            limit = int(lim)
        parts = value.split(":")
        action = parts[0]
        if action not in ("delay", "drop", "dup", "reorder"):
            raise ValueError(f"unknown chaos action {action!r} in {entry!r}")
        p = float(parts[1]) if len(parts) > 1 else 1.0
        lo_us = float(parts[2]) if len(parts) > 2 else 0.0
        hi_us = float(parts[3]) if len(parts) > 3 else lo_us
        self._add_msg_rule(
            _MsgRule(name, action, p, lo_us, hi_us, limit, role, key, rng)
        )

    def _add_msg_rule(self, rule: _MsgRule) -> None:
        self._msg_rules.setdefault(rule.mtype, []).append(rule)

    # ------------------------------------------------------------ decisions

    def decide(self, mtype: str) -> Optional[Tuple[str, float, str]]:
        """First firing rule's (action, delay_seconds, rule_key) for one
        message of ``mtype``; None = deliver untouched. Each rule's
        decision stream is deterministic under the schedule's seed."""
        rules = self._msg_rules.get(mtype)
        star = self._msg_rules.get("*")
        if not rules and not star:
            return None
        with self._lock:
            for rule in (rules or []) + (star or []):
                if rule.role is not None and rule.role != self._role:
                    continue
                if rule.limit is not None and rule.fired >= rule.limit:
                    continue
                rule.hits += 1
                if rule.p < 1.0 and rule.rng.random() >= rule.p:
                    continue
                rule.fired += 1
                delay_s = 0.0
                if rule.action == "delay":
                    delay_s = rule.rng.uniform(rule.lo_us, rule.hi_us) / 1e6
                k = f"{rule.action}:{mtype}"
                self.stats[k] = self.stats.get(k, 0) + 1
                return rule.action, delay_s, rule.key
        return None

    def intercept(self, holder: Any, mtype: str, msg: Any) -> List[Any]:
        """Transport-boundary hook (PeerConn deliver side). Returns the
        messages to deliver NOW, in order. ``holder`` carries the
        reorder hold slot (``_chaos_held``) per connection."""
        decision = self.decide(mtype)
        held = getattr(holder, "_chaos_held", None)
        if decision is None:
            out = [msg]
        else:
            action, delay_s, rule_key = decision
            if _events.enabled():
                _events.record(
                    _events.CHAOS, mtype, action.upper(),
                    {"rule": rule_key, "delay_s": round(delay_s, 6)},
                )
            if action == "drop":
                out = []
            elif action == "dup":
                out = [msg, msg]
            elif action == "reorder":
                # Hold this message; it delivers right AFTER the next
                # one on this connection (a one-slot swap — the minimal
                # reordering a non-FIFO transport could produce).
                if held is None:
                    held = holder._chaos_held = []
                held.append(msg)
                return []
            else:  # delay: sleep on the reader thread — head-of-line
                # delay, exactly what a congested link does.
                if delay_s > 0:
                    time.sleep(delay_s)
                out = [msg]
        if held:
            out = out + held
            del held[:]
        return out

    def drain_held(self, holder: Any) -> List[Any]:
        """Connection closing: whatever reorder still holds delivers
        now (a held message must never silently become a drop)."""
        held = getattr(holder, "_chaos_held", None)
        if not held:
            return []
        out, holder._chaos_held = list(held), []
        return out

    # ----------------------------------------------------------- kill points

    def maybe_kill(self, point: str) -> None:
        rules = self._kill_rules.get(point)
        if not rules:
            return
        with self._lock:
            fire = None
            for rule in rules:
                if rule.role is not None and rule.role != self._role:
                    continue
                rule.hits += 1
                if rule.nth is not None:
                    if rule.hits == rule.nth:
                        fire = rule
                        break
                elif rule.rng.random() < (rule.p or 0.0):
                    fire = rule
                    break
            if fire is None:
                return
            fire.fired += 1
            self.stats[f"kill:{point}"] = (
                self.stats.get(f"kill:{point}", 0) + 1
            )
        if _events.enabled():
            _events.record(
                _events.CHAOS, point, "KILLED", {"rule": fire.key}
            )
        # The ring dies with this process for workers; the stderr line
        # ships through the log monitor so the kill stays attributable.
        sys.stderr.write(
            f"chaos: killing pid {os.getpid()} at {point} "
            f"(seed={self.seed}, rule={fire.key})\n"
        )
        sys.stderr.flush()
        self._kill()

    def _kill(self) -> None:  # monkeypatched by tests
        os._exit(143)

    # --------------------------------------------------------- fault points

    def maybe_fault(self, point: str) -> bool:
        """Storage-plane fault decision for one hit of ``point`` (e.g.
        "io_error:spill_write"). True = the hook site must inject the
        named failure; the decision stream is deterministic under the
        schedule's seed, and every injected fault records a CHAOS
        event so a red run stays attributable."""
        rules = self._fault_rules.get(point)
        if not rules:
            return False
        with self._lock:
            fire = None
            for rule in rules:
                if rule.role is not None and rule.role != self._role:
                    continue
                rule.hits += 1
                if rule.nth is not None:
                    if rule.hits == rule.nth:
                        fire = rule
                        break
                elif rule.rng.random() < (rule.p or 0.0):
                    fire = rule
                    break
            if fire is None:
                return False
            fire.fired += 1
            self.stats[point] = self.stats.get(point, 0) + 1
        if _events.enabled():
            _events.record(
                _events.CHAOS, point, "FAULT", {"rule": fire.key}
            )
        return True

    # ------------------------------------------------------------- partitions

    def partition_blocks(self, src_role: str, dst_role: str) -> bool:
        """True when a partition rule currently cuts traffic flowing
        ``src_role`` → ``dst_role``. Deterministic by construction:
        windows are pure functions of the shared epoch, not of a
        per-message RNG draw. Transition edges (first blocked message,
        first message after heal) record one CHAOS event each."""
        if not self._partition_rules:
            return False
        now = time.time() - self._epoch
        blocked = False
        for rule in self._partition_rules:
            if not rule.covers(src_role, dst_role):
                continue
            if now < rule.start_s:
                continue
            if rule.heal_s is not None and now >= rule.heal_s:
                with self._lock:
                    heal_edge = rule.began and not rule.healed
                    rule.healed = True
                if heal_edge:
                    self.stats[f"partition_heal:{rule.key}"] = 1
                    if _events.enabled():
                        _events.record(
                            _events.CHAOS,
                            f"{rule.role_a}<->{rule.role_b}",
                            "PARTITION_HEAL",
                            {"rule": rule.key, "at_s": round(now, 3)},
                        )
                continue
            with self._lock:
                begin_edge = not rule.began
                rule.began = True
                k = f"partition:{rule.key}"
                self.stats[k] = self.stats.get(k, 0) + 1
            if begin_edge and _events.enabled():
                _events.record(
                    _events.CHAOS,
                    f"{rule.role_a}<->{rule.role_b}",
                    "PARTITION_BEGIN",
                    {
                        "rule": rule.key, "dir": rule.direction,
                        "at_s": round(now, 3),
                    },
                )
            blocked = True
        return blocked

    # ------------------------------------------------------------- throttles

    #: Per-frame pacing cap: an oversized frame on a starved link must
    #: stall, not wedge the connection past every test deadline (the
    #: heal window still bounds the total degradation).
    _MAX_PACE_S = 30.0

    def throttled(self, src_role: str, dst_role: str) -> bool:
        """Cheap in-window check: True when a throttle rule currently
        degrades ``src_role`` → ``dst_role`` traffic. Callers use it to
        skip payload materialization on healthy links."""
        if not self._throttle_rules:
            return False
        now = time.time() - self._epoch
        for rule in self._throttle_rules:
            if not rule.covers(src_role, dst_role):
                continue
            if now < rule.start_s:
                continue
            if rule.heal_s is not None and now >= rule.heal_s:
                with self._lock:
                    heal_edge = rule.began and not rule.healed
                    rule.healed = True
                if heal_edge:
                    self.stats[f"throttle_heal:{rule.key}"] = 1
                    if _events.enabled():
                        _events.record(
                            _events.CHAOS,
                            f"{rule.role_a}<->{rule.role_b}",
                            "THROTTLE_HEAL",
                            {"rule": rule.key, "at_s": round(now, 3)},
                        )
                continue
            return True
        return False

    def throttle_pace(self, src_role: str, dst_role: str,
                      nbytes: int) -> float:
        """Token-bucket pacing for one ``nbytes`` frame flowing
        ``src_role`` → ``dst_role``: sleeps until the modeled slow link
        would have transmitted it, returns the seconds slept. Both the
        sender and the receiver boundary call this, so installing the
        spec in only one side's processes still degrades both
        directions of its links (mirrors partition enforcement). The
        virtual clock never runs past the heal instant — a backlogged
        bucket drains at heal instead of outliving it."""
        if not self._throttle_rules:
            return 0.0
        delay = 0.0
        edges = []
        with self._lock:
            now = time.time() - self._epoch
            for rule in self._throttle_rules:
                if not rule.covers(src_role, dst_role):
                    continue
                if now < rule.start_s:
                    continue
                if rule.heal_s is not None and now >= rule.heal_s:
                    continue
                if not rule.began:
                    rule.began = True
                    edges.append((rule, now))
                start = max(now, rule.next_free)
                free_at = start + nbytes / rule.rate
                if rule.heal_s is not None:
                    free_at = min(free_at, rule.heal_s)
                rule.next_free = free_at
                delay = max(delay, min(free_at - now, self._MAX_PACE_S))
                k = f"throttle:{rule.key}"
                self.stats[k] = self.stats.get(k, 0) + 1
        for rule, at in edges:
            if _events.enabled():
                _events.record(
                    _events.CHAOS,
                    f"{rule.role_a}<->{rule.role_b}",
                    "THROTTLE_BEGIN",
                    {
                        "rule": rule.key, "dir": rule.direction,
                        "rate": rule.rate, "at_s": round(at, 3),
                    },
                )
        if delay > 0:
            time.sleep(delay)
        return delay

    # -------------------------------------------------------------- slowexec

    def slowexec_factor(self, task_name: str) -> float:
        """Current execution stretch factor for ``task_name`` (1.0 =
        untouched). The worker multiplies wall time by this after user
        code returns."""
        if not self._slowexec_rules:
            return 1.0
        import fnmatch

        now = time.time() - self._epoch
        factor = 1.0
        edges = []
        for rule in self._slowexec_rules:
            if now < rule.start_s:
                continue
            if rule.heal_s is not None and now >= rule.heal_s:
                continue
            if not fnmatch.fnmatch(task_name, rule.pattern):
                continue
            if rule.factor > factor:
                factor = rule.factor
            with self._lock:
                if not rule.began:
                    rule.began = True
                    edges.append(rule)
                k = f"slowexec:{rule.key}"
                self.stats[k] = self.stats.get(k, 0) + 1
        for rule in edges:
            if _events.enabled():
                _events.record(
                    _events.CHAOS, rule.pattern, "SLOWEXEC",
                    {"rule": rule.key, "factor": rule.factor},
                )
        return factor

    # ----------------------------------------------------------- connect hook

    def on_connect(self, address: str) -> None:
        """transport.connect chaos: 'connect' rules delay or fail
        connection establishment (drop ⇒ OSError, the retryable
        failure reconnect paths already handle)."""
        decision = self.decide("connect")
        if decision is None:
            return
        action, delay_s, rule_key = decision
        if _events.enabled():
            _events.record(
                _events.CHAOS, "connect", action.upper(),
                {"rule": rule_key, "address": address},
            )
        if action == "delay" and delay_s > 0:
            time.sleep(delay_s)
        elif action in ("drop", "dup", "reorder"):
            raise OSError(f"chaos: connect to {address} refused")


# ------------------------------------------------------------ global state

#: The process-wide schedule; None = chaos off (the hot-path guard).
_active: Optional[FaultSchedule] = None


def install(spec: str, seed: int = 0,
            legacy_delay_spec: str = "") -> Optional[FaultSchedule]:
    """Explicitly (re)install the process-wide schedule. Empty spec
    with no legacy delays deactivates."""
    global _active
    if not spec and not legacy_delay_spec:
        _active = None
    else:
        _active = FaultSchedule(
            spec, seed=seed, legacy_delay_spec=legacy_delay_spec
        )
    return _active


def refresh() -> Optional[FaultSchedule]:
    """(Re)build from RayConfig — called after RayConfig.initialize
    (driver init, head bring-up) and once at import so spawned
    processes pick the spec up from their environment."""
    from .config import RayConfig

    try:
        spec = RayConfig.chaos_spec
        seed = RayConfig.chaos_seed
        legacy = RayConfig.testing_rpc_delay_us
    except AttributeError:  # config predating these knobs
        return _active
    return install(spec, seed, legacy)


def active() -> Optional[FaultSchedule]:
    return _active


def kill_point(name: str) -> None:
    """Named phase-boundary kill hook (no-op unless a kill rule is
    installed for this process — one module-global read when off)."""
    sched = _active
    if sched is not None:
        sched.maybe_kill(name)


def fault_point(name: str) -> bool:
    """Named storage-plane fault hook: True when the hook site must
    inject the named failure (one module-global read when chaos is
    off). See the spec grammar — io_error:spill_write, disk_full:spill,
    truncate:spill_file."""
    sched = _active
    return sched is not None and sched.maybe_fault(name)


def partition_blocks(src_role: str, dst_role: str) -> bool:
    """Transport hook: True when the installed schedule currently cuts
    ``src_role`` → ``dst_role`` traffic (one module-global read when
    chaos is off)."""
    sched = _active
    return sched is not None and sched.partition_blocks(src_role, dst_role)


def throttled(src_role: str, dst_role: str) -> bool:
    """Transport hook: True when a throttle rule currently degrades
    ``src_role`` → ``dst_role`` traffic (one module-global read when
    chaos is off)."""
    sched = _active
    return sched is not None and sched.throttled(src_role, dst_role)


def throttle_pace(src_role: str, dst_role: str, nbytes: int) -> float:
    """Transport hook: pace one frame through the modeled slow link
    (sleeps HERE, inside the chaos engine — transport dispatch paths
    stay free of direct sleeps). Returns seconds slept."""
    sched = _active
    if sched is None:
        return 0.0
    return sched.throttle_pace(src_role, dst_role, nbytes)


def slowexec_stretch(task_name: str, elapsed_s: float,
                     cancelled=None) -> float:
    """Worker execution hook: sleep the extra (factor-1) x elapsed a
    degraded machine would have taken for this task. Returns seconds
    slept (0.0 when chaos is off or no rule matches). ``cancelled``
    (optional callable) is polled during the stretch: a hedge loser
    whose twin already won stops stretching early — the straggling node
    stays slow, but cancellation still frees its worker."""
    sched = _active
    if sched is None or elapsed_s <= 0:
        return 0.0
    factor = sched.slowexec_factor(task_name)
    if factor <= 1.0:
        return 0.0
    extra = (factor - 1.0) * elapsed_s
    if cancelled is None:
        time.sleep(extra)
        return extra
    t0 = time.monotonic()
    while True:
        left = extra - (time.monotonic() - t0)
        if left <= 0 or cancelled():
            return time.monotonic() - t0
        time.sleep(min(0.05, left))


def mtype_of(msg: Any) -> Optional[str]:
    """Message-type key for fault rules: dict control messages use
    their 'type'; compact tuple frames map to op_call/op_reply."""
    t = type(msg)
    if t is dict:
        return msg.get("type")
    if t is tuple and msg:
        op = msg[0]
        if op == 1:  # protocol.OP_CALL (literal: no import cycle)
            return "op_call"
        if op == 2:  # protocol.OP_REPLY
            return "op_reply"
        if op == "RDY":
            return "rdy"
    return None


# Activate from the environment at import: worker/raylet subprocesses
# inherit RAY_TPU_TORCH_chaos_* and must not need an explicit install call.
try:
    refresh()
except Exception:  # noqa: BLE001 - chaos must never break bring-up
    _active = None
