"""The port's lint (`python -m ray_tpu_torch._lint`, a copy of the
reference's raylint in `ray_tpu_torch/_lint/`): tests/test_raylint.py,
case for case, against the port's copy, its tree (`ray_tpu_torch/`), its
event registry (`ray_tpu_torch/_private/event_names.py`) and its own
`baseline.json`; then a violation planted in a temporary file, reported
by the engine and by the CLI, and the registry read from the port's
path. Every test has a deadline after which it fails instead of hanging.

The reference's docstring: raylint: per-rule fixture tests + marker
grammar + baseline flow.

Each rule gets a seeded-violation fixture (must fire) and a clean twin
(must not): the lint's own regression net. The final tests run the
real engine over the real tree and assert the repo itself lints clean
against its baseline — the CI contract.
"""
import json
import os
import signal
import subprocess
import sys

import pytest

from ray_tpu_torch._lint import (
    RULES,
    diff_baseline,
    lint_paths,
    lint_source,
    load_baseline,
    write_baseline,
)
from ray_tpu_torch._lint.markers import parse_markers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def names(violations, rule=None):
    return [
        v.rule for v in violations if rule is None or v.rule == rule
    ]


# ------------------------------------------------------------ thread-domain


SEEDED_THREAD_DOMAIN = '''
# raylint: guarded-attrs=holders,owner_released
class Directory:
    def on_dispatch(self, entry, cid):
        entry.holders.add(cid)          # VIOLATION: unmarked function
        entry.owner_released = True     # VIOLATION
'''

CLEAN_THREAD_DOMAIN = '''
# raylint: guarded-attrs=holders,owner_released
class Directory:
    def __init__(self):
        self.holders = set()            # construction is legal

    # raylint: applier-only
    def apply(self, entry, cid):
        entry.holders.add(cid)
        entry.owner_released = True

    def read_only(self, entry):
        return len(entry.holders)       # reads are free
'''


def test_thread_domain_seeded():
    vs = lint_source(SEEDED_THREAD_DOMAIN, only=["thread-domain"])
    assert len(vs) == 2
    assert all(v.rule == "thread-domain" for v in vs)


def test_thread_domain_clean_twin():
    assert not lint_source(CLEAN_THREAD_DOMAIN, only=["thread-domain"])


def test_thread_domain_dispatch_calls_applier():
    src = '''
# raylint: guarded-attrs=holders
class D:
    # raylint: applier-only
    def _apply(self, e):
        e.holders.clear()
    # raylint: dispatch-only
    def handler(self, e):
        self._apply(e)
'''
    vs = lint_source(src, only=["thread-domain"])
    assert len(vs) == 1
    assert "calls applier-only" in vs[0].message


def test_thread_domain_nested_thread_target_not_dispatch():
    # A def nested inside a dispatch handler is usually a thread
    # target: calls it makes do NOT run on the dispatch thread and
    # must not be attributed to it (mirrors no-blocking-on-dispatch).
    src = '''
# raylint: guarded-attrs=holders
import threading
class D:
    # raylint: applier-only
    def _apply(self, e):
        e.holders.clear()
    # raylint: dispatch-only
    def handler(self, e):
        def _bg():
            self._apply(e)
        threading.Thread(target=_bg, daemon=True).start()
'''
    assert not lint_source(src, only=["thread-domain"])


def test_thread_domain_scoped_per_module():
    # No guarded-attrs declaration => rule is inert (gcs.py mutates
    # holder state legally under its own lock).
    src = "class D:\n    def f(self, e):\n        e.holders.add(1)\n"
    assert not lint_source(src, only=["thread-domain"])


# -------------------------------------------------- no-blocking-on-dispatch


SEEDED_BLOCKING = '''
# raylint: dispatch-handlers=_h_*
import time
class G:
    def _h_tick(self, state, msg):
        self._inner(msg)
    def _inner(self, msg):
        time.sleep(0.5)                # VIOLATION (transitive)
        data = open("/tmp/f").read()   # VIOLATION
        return data
'''

CLEAN_BLOCKING = '''
# raylint: dispatch-handlers=_h_*
import threading, time
class G:
    def _h_tick(self, state, msg):
        self._enqueue(msg)
        threading.Thread(target=self._bg, daemon=True).start()
    def _enqueue(self, msg):
        self.queue.append(msg)
    def _bg(self):
        time.sleep(0.5)  # its own thread: never CALLED from a handler
'''


def test_no_blocking_seeded():
    vs = lint_source(SEEDED_BLOCKING, only=["no-blocking-on-dispatch"])
    assert len(vs) == 2
    assert "reachable from dispatch handler 'G._h_tick'" in vs[0].message


def test_no_blocking_clean_twin():
    assert not lint_source(
        CLEAN_BLOCKING, only=["no-blocking-on-dispatch"]
    )


def test_no_blocking_explicit_marker_and_socket():
    src = '''
class Conn:
    # raylint: dispatch-only
    def deliver(self, sock):
        return sock.recv(4096)
'''
    vs = lint_source(src, only=["no-blocking-on-dispatch"])
    assert len(vs) == 1 and ".recv()" in vs[0].message


# ------------------------------------------------------- fixed-sleep-retry


SEEDED_SLEEP = '''
import time
def fetch(conn):
    for attempt in range(5):
        try:
            return conn.pull()
        except OSError:
            time.sleep(0.5)            # VIOLATION: fixed retry delay
'''

CLEAN_SLEEP_BACKOFF = '''
import time
from ray_tpu_torch._private.chaos import Backoff
def fetch(conn):
    bo = Backoff(base_s=0.5)
    for attempt in range(5):
        try:
            return conn.pull()
        except OSError:
            time.sleep(bo.next_delay())  # on the one retry policy
'''

CLEAN_SLEEP_POLL = '''
import time
def monitor(self):
    while not self.shutdown:
        time.sleep(0.2)                # poll cadence, not a retry
        try:
            self.tick()
        except Exception:
            self.stats["errors"] = self.stats.get("errors", 0) + 1
'''


def test_fixed_sleep_seeded():
    vs = lint_source(SEEDED_SLEEP, only=["fixed-sleep-retry"])
    assert len(vs) == 1
    assert "chaos.Backoff" in vs[0].message


def test_fixed_sleep_clean_backoff_twin():
    assert not lint_source(CLEAN_SLEEP_BACKOFF, only=["fixed-sleep-retry"])


def test_fixed_sleep_poll_cadence_not_flagged():
    assert not lint_source(CLEAN_SLEEP_POLL, only=["fixed-sleep-retry"])


# ---------------------------------------------------- raw-send-on-gcs-path


SEEDED_RAW_SEND = '''
def report_done(self, spec):
    self.conn.send({"type": "task_done", "spec": spec})   # VIOLATION
'''

SEEDED_RAW_SEND_VIA_VAR = '''
def flush(self, client):
    msg = {"type": "ref_flush", "client": b"x"}
    client.conn.send(msg)                                  # VIOLATION
'''

CLEAN_RAW_SEND = '''
def report_done(self, spec):
    self.send_reliable({"type": "task_done", "spec": spec})

def lease(self):
    self.conn.send({"type": "return_lease"})   # not a reliable class
'''


def test_raw_send_seeded():
    vs = lint_source(SEEDED_RAW_SEND, only=["raw-send-on-gcs-path"])
    assert len(vs) == 1 and "task_done" in vs[0].message


def test_raw_send_resolves_local_dict():
    vs = lint_source(
        SEEDED_RAW_SEND_VIA_VAR, only=["raw-send-on-gcs-path"]
    )
    assert len(vs) == 1 and "ref_flush" in vs[0].message


def test_raw_send_clean_twin():
    assert not lint_source(CLEAN_RAW_SEND, only=["raw-send-on-gcs-path"])


def test_raw_send_suppression_with_reason():
    src = '''
def flush(self, client):
    # raylint: disable=raw-send-on-gcs-path -- at-least-once layer itself
    client.conn.send({"type": "ref_flush"})
'''
    assert not lint_source(src, only=["raw-send-on-gcs-path"])


# ---------------------------------------------------------- swallowed-fault


SEEDED_SWALLOW = '''
def pull(self):
    try:
        self.fetch()
    except Exception:
        pass                           # VIOLATION: silent swallow
'''

CLEAN_SWALLOW = '''
def pull(self):
    try:
        self.fetch()
    except Exception:
        self.stats["errors"] += 1      # counted, never silent

def seal(self):
    try:
        self.fetch()
    except Exception as e:
        self.reply(error=str(e))       # converted, not swallowed

def strict(self):
    try:
        self.fetch()
    except ValueError:
        pass                           # narrow except: out of scope
'''


def test_swallowed_fault_seeded():
    vs = lint_source(SEEDED_SWALLOW, only=["swallowed-fault"])
    assert len(vs) == 1


def test_swallowed_fault_clean_twin():
    assert not lint_source(CLEAN_SWALLOW, only=["swallowed-fault"])


def test_swallowed_fault_bare_except_and_record():
    src = '''
def f(self):
    try:
        self.g()
    except:
        pass
'''
    assert len(lint_source(src, only=["swallowed-fault"])) == 1
    src_ok = src.replace("pass", "_events.record('chaos', 'x', 'FAULT')")
    assert not lint_source(src_ok, only=["swallowed-fault"])


# ----------------------------------------------------------- event-taxonomy


def test_event_taxonomy_seeded():
    src = '''
from . import events as _events
def f():
    _events.record(_events.TASK, "tid", "TOTALLY_NOT_AN_EVENT", None)
'''
    vs = lint_source(src, only=["event-taxonomy"])
    assert len(vs) == 1
    assert "TOTALLY_NOT_AN_EVENT" in vs[0].message


def test_event_taxonomy_clean_twin():
    src = '''
from . import events as _events
def f():
    _events.record(_events.TASK, "tid", "SUBMITTED", None)
    _events.record(_events.REFS, "x", "SHARD_APPLY", {"ops": 1})
'''
    assert not lint_source(src, only=["event-taxonomy"])


def test_event_taxonomy_unknown_category():
    src = '''
def f(rec):
    rec.record("nonsense_category", "x", "SUBMITTED", None)
'''
    vs = lint_source(src, only=["event-taxonomy"])
    assert len(vs) == 1 and "category" in vs[0].message


def test_event_taxonomy_stitch_literals():
    src = '''
# raylint: check-event-literals
def stitch(ev):
    if ev["event"] == "NOT_REGISTERED_ROW":
        return 1
    if ev["event"] in ("SHARD_APPLY", "PULL_DONE"):
        return 2
'''
    vs = lint_source(src, only=["event-taxonomy"])
    assert len(vs) == 1
    assert "NOT_REGISTERED_ROW" in vs[0].message


def test_registry_covers_runtime_constants():
    """events.py's transition/span tables and state.py's stitch names
    must stay registered (the cross-check that keeps the registry the
    single source of truth)."""
    from ray_tpu_torch._private import event_names, events

    for t in events.TASK_TRANSITIONS:
        assert event_names.is_registered(t), t
    for span in events._SPAN_KEYS:
        assert event_names.is_registered(span), span
    assert set(event_names.CATEGORIES) == {
        events.TASK, events.WORKER, events.LEASE, events.OBJECT,
        events.TRANSFER, events.SCHED, events.REFS, events.CHAOS,
        events.HEAD,
    }
    # The witness's finding event is registered under chaos.
    assert "LOCK_ORDER" in event_names.EVENTS_BY_CATEGORY["chaos"]


# ------------------------------------------------------------------ markers


def test_marker_grammar():
    mks = parse_markers(
        "# raylint: guarded-attrs=a,b\n"
        "x = 1  # raylint: disable=swallowed-fault -- known-benign\n"
        "# raylint: dispatch-only\n"
    )
    assert mks[0].directive == "guarded-attrs"
    assert mks[0].values == ["a", "b"]
    assert mks[0].own_line
    assert mks[1].directive == "disable"
    assert mks[1].values == ["swallowed-fault"]
    assert mks[1].reason == "known-benign"
    assert not mks[1].own_line
    assert mks[2].directive == "dispatch-only"


def test_bare_suppression_is_a_violation():
    src = '''
def f(self):
    try:
        self.g()
    except Exception:  # raylint: disable=swallowed-fault
        pass
'''
    vs = lint_source(src)
    assert names(vs) == ["bare-suppression"]
    with_reason = src.replace(
        "disable=swallowed-fault", "disable=swallowed-fault -- why not"
    )
    assert not lint_source(with_reason)


def test_function_scope_suppression():
    src = '''
# raylint: disable=swallowed-fault -- wrapper swallows by contract
def f(self):
    try:
        self.g()
    except Exception:
        pass
'''
    assert not lint_source(src)


# ----------------------------------------------------------------- baseline


def test_baseline_roundtrip(tmp_path):
    vs = lint_source(SEEDED_SWALLOW, path="m.py", only=["swallowed-fault"])
    bl = tmp_path / "baseline.json"
    write_baseline(str(bl), vs)
    data = json.loads(bl.read_text())
    assert data["version"] == 1
    assert len(data["violations"]) == 1
    # Same violations against the baseline: nothing new.
    new, fixed = diff_baseline(vs, load_baseline(str(bl)))
    assert not new and not fixed
    # A second identical swallow in the same function IS new (count).
    doubled = SEEDED_SWALLOW + (
        "\ndef g(self):\n    try:\n        self.fetch()\n"
        "    except Exception:\n        pass\n"
    )
    vs2 = lint_source(doubled, path="m.py", only=["swallowed-fault"])
    new, _ = diff_baseline(vs2, load_baseline(str(bl)))
    assert len(new) == 1
    # Fixing the original reports its fingerprint as stale.
    _, fixed = diff_baseline([], load_baseline(str(bl)))
    assert len(fixed) == 1


def test_fingerprint_stable_across_line_moves():
    a = lint_source(SEEDED_SWALLOW, path="m.py")
    b = lint_source("\n\n\n" + SEEDED_SWALLOW, path="m.py")
    assert [v.fingerprint for v in a] == [v.fingerprint for v in b]


# ------------------------------------------------------------- repo contract


def test_rule_catalogue_complete():
    assert set(RULES) >= {
        "thread-domain", "no-blocking-on-dispatch", "fixed-sleep-retry",
        "raw-send-on-gcs-path", "swallowed-fault", "event-taxonomy",
    }


def test_repo_lints_clean_against_baseline():
    """The CI gate, in-process: zero non-baselined violations."""
    violations, errors = lint_paths([os.path.join(REPO, "ray_tpu_torch")], REPO)
    assert not errors
    baseline = load_baseline(
        os.path.join(REPO, "ray_tpu_torch", "_lint", "baseline.json")
    )
    new, _fixed = diff_baseline(violations, baseline)
    assert not new, "\n".join(v.render() for v in new)


def test_cli_end_to_end():
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch._lint"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "new" in proc.stdout


def test_cli_refuses_partial_baseline_write():
    """--write-baseline on a narrowed run would wipe the full-scope
    debt; the CLI must refuse rather than corrupt the baseline."""
    proc = subprocess.run(
        [
            sys.executable, "-m", "ray_tpu_torch._lint",
            "ray_tpu_torch/_private/state.py", "--write-baseline",
        ],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert "refusing" in proc.stderr


# ------------------------------------------------------------ the port's own


def test_registry_is_the_ports_own():
    """The event-taxonomy rule reads the port's registry, by path, not
    the reference's."""
    from ray_tpu_torch._lint import rules

    assert rules.EVENT_NAMES_PATH == os.path.join(
        REPO, "ray_tpu_torch", "_private", "event_names.py"
    )
    from ray_tpu_torch._private import event_names

    assert rules._load_registry()["events"] == set(event_names.EVENT_NAMES)


def test_default_path_is_the_port():
    from ray_tpu_torch._lint import __main__ as cli

    assert cli.DEFAULT_PATHS == [os.path.join(REPO, "ray_tpu_torch")]
    assert cli.DEFAULT_BASELINE == os.path.join(
        REPO, "ray_tpu_torch", "_lint", "baseline.json"
    )


PLANTED = """
from . import events as _events
def f():
    _events.record(_events.TASK, "tid", "PLANTED_NOT_AN_EVENT", None)


def g(self):
    try:
        self.fetch()
    except Exception:
        pass
"""


def test_planted_violation_in_a_temporary_file_is_reported(tmp_path):
    """A file with an unregistered event name and a swallowed fault,
    linted by path: the engine reports both, and the CLI exits 1 and
    names the file and the event."""
    planted = tmp_path / "planted.py"
    planted.write_text(PLANTED)
    violations, errors = lint_paths([str(planted)], str(tmp_path))
    assert not errors
    assert sorted(names(violations)) == ["event-taxonomy", "swallowed-fault"]
    assert any("PLANTED_NOT_AN_EVENT" in v.message for v in violations)
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch._lint", str(planted)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "planted.py" in proc.stdout
    assert "PLANTED_NOT_AN_EVENT" in proc.stdout
    assert "2 new" in proc.stdout
