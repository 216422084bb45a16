"""The port's observability: Prometheus text and escaping, /metrics, the
dashboard's log viewer, worker stack and sampling profiles, the flight
recorder, the aggregator, clock-skew stitching, the six-phase task
timeline, the events CLI and the recorder's overhead budget:
tests/test_observability.py, case for case, on the port's runtime. Every
test has a deadline after which it fails instead of hanging, and every
`get` and `wait` a timeout.

The reference's docstring:

Observability depth: Prometheus exposition, metrics timeseries,
dashboard log viewer, live worker stack profiling, and the
flight-recorder event pipeline (_private/events.py).

Models the reference's dashboard/metrics-agent surface
(dashboard/modules/, _private/metrics_agent.py,
reporter/profile_manager.py) plus the task-event path
(task_event_buffer.h → gcs_task_manager.h → timeline).
"""
import json
import signal
import socket
import time
import urllib.request

import pytest

import ray_tpu_torch

DEADLINE_S = 120
GET_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _free_port() -> int:
    """A free port for the dashboard: the reference's fixed ports would
    meet its own tests' dashboards under xdist."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def cluster():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def test_prometheus_text_format():
    from ray_tpu_torch.util.metrics import prometheus_text

    snap = {
        "lat_ms": {
            "kind": "histogram",
            "description": "latency",
            "boundaries": [1.0, 10.0],
            "series": [{"tags": {"ep": "a"}, "sum": 12.5, "counts": [3, 2, 1]}],
        },
        "busy": {
            "kind": "gauge",
            "description": "",
            "series": [{"tags": {"node": "n1"}, "value": 2.0}],
        },
        "weird name-1": {
            "kind": "counter",
            "description": "d",
            "series": [{"tags": {}, "value": 7}],
        },
    }
    text = prometheus_text(snap)
    assert '# TYPE lat_ms histogram' in text
    assert 'lat_ms_bucket{ep="a",le="1.0"} 3' in text
    assert 'lat_ms_bucket{ep="a",le="+Inf"} 6' in text
    assert 'lat_ms_count{ep="a"} 6' in text
    assert 'busy{node="n1"} 2.0' in text
    # Invalid chars sanitized to underscores.
    assert "weird_name_1 7" in text


def test_prometheus_label_value_escaping():
    """Exposition format requires backslash, quote AND newline escaped
    in label values — a raw newline splits the sample line and corrupts
    the whole scrape (regression: newline was passed through)."""
    from ray_tpu_torch.util.metrics import prometheus_text

    snap = {
        "m": {
            "kind": "gauge",
            "description": "",
            "series": [
                {
                    "tags": {"err": 'a"b\\c\nd'},
                    "value": 1.0,
                }
            ],
        },
    }
    text = prometheus_text(snap)
    assert '\\n' in text
    assert 'm{err="a\\"b\\\\c\\nd"} 1.0' in text
    # Every sample stays on one physical line.
    for line in text.splitlines():
        assert line.startswith(("#", "m")) or not line


def test_metrics_endpoint_serves_user_and_core(cluster):
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.util.metrics import Counter

    c = Counter("my_requests", description="reqs", tag_keys=("route",))
    c.inc(3.0, tags={"route": "x"})

    @ray_tpu_torch.remote
    def f():
        return 1

    ray_tpu_torch.get([f.remote() for _ in range(2)], timeout=GET_TIMEOUT_S)
    url = start_dashboard(port=_free_port())
    deadline = time.time() + 10
    text = ""
    while time.time() < deadline:
        with urllib.request.urlopen(f"{url}/metrics") as r:
            text = r.read().decode()
        if "my_requests" in text:
            break
        time.sleep(0.5)
    assert 'my_requests{route="x"} 3.0' in text
    # Core runtime series present too.
    assert "ray_tpu_torch_resources_total" in text
    assert "ray_tpu_torch_nodes_alive 1" in text
    assert "ray_tpu_torch_control_messages" in text


def test_every_exported_metric_name_takes_the_ports_prefix(cluster):
    """After a task, a put/get, a straggler sweep and a pull manager's
    gauges, every name `/metrics` declares starts with `ray_tpu_torch_`,
    or is a user metric this file declares (the registry is the
    process's, so an earlier test's metric is still there): no series of
    the port meets a series of the reference in one scrape."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.object_plane.pull_manager import PullManager
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.util.metrics import Counter

    Counter("prefix_probe_requests", description="reqs").inc(1.0)

    @ray_tpu_torch.remote
    def f():
        return 1

    assert ray_tpu_torch.get(f.remote(), timeout=GET_TIMEOUT_S) == 1
    assert ray_tpu_torch.get(ray_tpu_torch.put(b"x" * 1000), timeout=GET_TIMEOUT_S) == b"x" * 1000
    worker_mod._global.node.gcs._score_nodes(1.0)  # one straggler sweep
    pm = PullManager(fetcher=None)
    with pm._cond:
        pm._update_gauges_locked()
    url = start_dashboard(port=_free_port())
    want = ("ray_tpu_torch_node_health_score", "ray_tpu_torch_pull_queue_depth",
            "prefix_probe_requests")
    deadline = time.time() + 20
    names = set()
    while time.time() < deadline:
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
            text = r.read().decode()
        names = {line.split()[2] for line in text.splitlines()
                 if line.startswith("# TYPE ")}
        if all(n in names for n in want):
            break
        time.sleep(0.5)
    assert all(n in names for n in want), sorted(names)
    user = {"my_requests", "prefix_probe_requests"}
    foreign = sorted(n for n in names
                     if not n.startswith("ray_tpu_torch_") and n not in user)
    assert not foreign, foreign


def test_metrics_timeseries_accumulates(cluster):
    from ray_tpu_torch.dashboard import start_dashboard

    url = start_dashboard(port=_free_port())
    time.sleep(5)
    with urllib.request.urlopen(f"{url}/api/metrics_timeseries") as r:
        ts = json.loads(r.read())
    assert "nodes alive" in ts["series"]
    assert len(ts["series"]["nodes alive"]) >= 2
    assert ts["series"]["nodes alive"][-1] == 1.0


def test_dashboard_log_viewer(cluster):
    from ray_tpu_torch.dashboard import start_dashboard

    @ray_tpu_torch.remote
    def shouty():
        print("HELLO-FROM-WORKER-xyzzy")
        return 1

    ray_tpu_torch.get(shouty.remote(), timeout=GET_TIMEOUT_S)
    url = start_dashboard(port=_free_port())
    deadline = time.time() + 15
    found = False
    while time.time() < deadline and not found:
        with urllib.request.urlopen(f"{url}/api/logs?tail=500") as r:
            lines = json.loads(r.read())["lines"]
        found = any("xyzzy" in l[2] for l in lines)
        time.sleep(0.5)
    assert found, "worker print never reached the dashboard log viewer"


def test_worker_stack_profiling(cluster):
    """A live stack dump from a worker stuck in user code shows the
    user frame (the case profiling exists for)."""
    import threading

    @ray_tpu_torch.remote
    def stuck_in_user_code():
        time.sleep(8.0)
        return 1

    ref = stuck_in_user_code.remote()
    # Find the busy worker.
    from ray_tpu_torch._private.worker import global_client
    from ray_tpu_torch.util.state import list_workers

    wid = None
    deadline = time.time() + 10
    while time.time() < deadline and wid is None:
        for w in list_workers():
            if w.get("state") == "BUSY":
                wid = bytes.fromhex(w["worker_id"])
                break
        time.sleep(0.2)
    assert wid is not None, "no busy worker found"
    reply = global_client().request(
        {"type": "worker_stacks", "worker_id": wid}, timeout=15.0
    )
    assert reply.get("ok"), reply
    assert "stuck_in_user_code" in reply["text"]
    assert "--- thread" in reply["text"]
    ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S)


def test_worker_stacks_unknown_worker(cluster):
    from ray_tpu_torch._private.worker import global_client

    reply = global_client().request(
        {"type": "worker_stacks", "worker_id": b"\x00" * 16}, timeout=10.0
    )
    assert not reply.get("ok")


def test_sampling_profile_folded_stacks(cluster):
    """?mode=sample returns a statistical profile in folded-flamegraph
    format with the busy function dominating (reference:
    profile_manager.py py-spy -f capture)."""
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.util.state import list_workers

    @ray_tpu_torch.remote
    class Spinner:
        def pid(self):
            import os as _os

            return _os.getpid()

        def spin_hot_loop_marker(self, seconds):
            import time as _t

            t_end = _t.monotonic() + seconds
            x = 0
            while _t.monotonic() < t_end:
                x += 1
            return x

    s = Spinner.remote()
    target_pid = ray_tpu_torch.get(s.pid.remote(), timeout=GET_TIMEOUT_S)
    ref = s.spin_hot_loop_marker.remote(8.0)

    url = start_dashboard(port=_free_port())
    # Select the spinner's worker by pid: other actors (the dashboard
    # itself) are also "is_actor" workers.
    wid = next(
        w["worker_id"]
        for w in list_workers(limit=100)
        if w["pid"] == target_pid
    )
    with urllib.request.urlopen(
        f"{url}/api/profile/{wid}?mode=sample&duration=2", timeout=30
    ) as r:
        folded = r.read().decode()
    assert folded.startswith("# folded stacks:")
    lines = [l for l in folded.splitlines()[1:] if l.strip()]
    assert lines, folded
    # Every line is "stack;frames count".
    for line in lines[:5]:
        stack, _, count = line.rpartition(" ")
        assert stack and count.isdigit(), line
    # The hot loop dominates the samples.
    assert "spin_hot_loop_marker" in folded
    ray_tpu_torch.get(ref, timeout=60)


# ---------------------------------------------------- flight recorder


def test_flight_recorder_ring_overflow_drop_accounting():
    """Overflow evicts oldest, counts every drop, and the counter
    resets per drain so batches never double-count."""
    from ray_tpu_torch._private.events import TASK, FlightRecorder

    rec = FlightRecorder(capacity=4, enabled=True, source="unit")
    for i in range(10):
        rec.record(TASK, f"t{i}", "SUBMITTED")
    assert len(rec) == 4
    items, dropped = rec.drain()
    assert len(items) == 4 and dropped == 6
    # Oldest evicted: the survivors are the newest four.
    assert [it[3] for it in items] == ["t6", "t7", "t8", "t9"]
    # Drain is destructive and resets the drop counter.
    items, dropped = rec.drain()
    assert items == [] and dropped == 0


def test_flight_recorder_disabled_records_nothing():
    from ray_tpu_torch._private.events import TASK, FlightRecorder

    rec = FlightRecorder(capacity=4, enabled=False)
    rec.record(TASK, "t", "SUBMITTED")
    assert len(rec) == 0 and rec.dropped == 0


def test_aggregator_span_expansion_and_phase_histograms():
    """One SUBMIT_SPAN + one EXEC_SPAN (the compact hot-path form)
    expand into all seven transitions and feed the six phase
    histograms."""
    from ray_tpu_torch._private.events import (
        TASK,
        TASK_PHASES,
        TASK_TRANSITIONS,
        EventAggregator,
    )

    agg = EventAggregator(per_job_cap=100)
    t0 = 1000.0
    agg.ingest(
        [
            (t0, 1.0, TASK, "tid1", "SUBMIT_SPAN",
             {"t_submit": t0, "t_queue": t0 + 1, "t_lease": t0 + 2}),
            (t0 + 6, 2.0, TASK, "tid1", "EXEC_SPAN",
             {"t_fork": t0 + 3, "t_start": t0 + 4, "t_end": t0 + 5,
              "t_seal": t0 + 6, "worker": "w1"}),
        ],
        source="unit",
    )
    names = [e["event"] for e in agg.task_transitions("tid1")]
    assert names == list(TASK_TRANSITIONS)
    summary = agg.summary()
    for phase in TASK_PHASES:
        assert sum(summary["phase_counts"][phase]) == 1
        assert summary["phase_sums"][phase] == pytest.approx(1.0)


def test_aggregator_per_job_retention_counts_evictions():
    from ray_tpu_torch._private.events import TASK, EventAggregator

    agg = EventAggregator(per_job_cap=5)
    agg.ingest(
        [(float(i), float(i), TASK, f"t{i}", "SUBMITTED", None)
         for i in range(12)],
        source="jobA",
    )
    summary = agg.summary()
    assert summary["jobs"]["jobA"] == 5
    assert summary["drops"]["jobA"] == 7  # evictions, never silent
    # Ring drops from the shipping batch land beside retention drops.
    agg.ingest([], source="jobA", ring_dropped=3)
    assert agg.summary()["drops"]["jobA"] == 10


def test_aggregator_merges_local_ring_before_shipped_batches():
    """The driver/head SUBMIT_SPAN sits in the process-local ring while
    the worker's EXEC_SPAN ships on the next done-batch flush; the
    aggregator must drain the local ring ahead of shipped batches or
    every task's submit/queue/lease phases collapse to zero width and
    an orphan open-task entry leaks per task."""
    from ray_tpu_torch._private.events import (
        TASK,
        TASK_PHASES,
        EventAggregator,
        FlightRecorder,
    )

    rec = FlightRecorder(capacity=100, enabled=True, source="driver")
    agg = EventAggregator(per_job_cap=100)
    agg.local_recorder = rec
    t0 = 1000.0
    rec.record(
        TASK, "tid", "SUBMIT_SPAN",
        {"t_submit": t0, "t_queue": t0 + 1, "t_lease": t0 + 2},
    )
    agg.ingest(
        [(t0 + 6, 0.0, TASK, "tid", "EXEC_SPAN",
          {"t_fork": t0 + 3, "t_start": t0 + 4, "t_end": t0 + 5,
           "t_seal": t0 + 6, "worker": "w"})],
        source="worker-1",
    )
    summary = agg.summary()
    for phase in TASK_PHASES:
        assert summary["phase_sums"][phase] == pytest.approx(1.0), phase
    assert not agg._open  # sealed and fully merged, no orphan


def test_aggregator_list_nonpositive_limit_returns_nothing():
    """limit=0 must not invert into 'everything' via a -0 slice (the
    dashboard passes user-supplied limits straight through)."""
    from ray_tpu_torch._private.events import TASK, EventAggregator

    agg = EventAggregator(per_job_cap=10)
    agg.ingest([(1.0, 0.0, TASK, "t", "SUBMITTED", None)], source="j")
    assert agg.list(limit=0) == []
    assert agg.list(limit=-5) == []
    assert len(agg.list(limit=10)) == 1


def test_stitch_clamps_cross_process_clock_skew():
    """A worker wall clock behind the head's must not yield negative
    phase durations — boundaries clamp monotone."""
    from ray_tpu_torch._private.events import TASK_PHASES, stitch_task_phases

    evs = [
        {"category": "task", "entity": "t", "event": e, "timestamp": ts}
        for e, ts in (
            ("SUBMITTED", 100.0),
            ("QUEUED", 100.5),
            ("LEASED", 101.0),
            ("FORKED", 100.2),  # skewed: behind the lease timestamp
            ("EXEC_START", 100.3),
            ("EXEC_END", 102.0),
            ("SEALED", 102.1),
        )
    ]
    rows = stitch_task_phases(evs)["t"]
    assert [r["name"] for r in rows] == list(TASK_PHASES)
    for a, b in zip(rows, rows[1:]):
        assert a["dur"] >= 0
        assert b["ts"] == pytest.approx(a["ts"] + a["dur"])


def test_task_timeline_six_phases_e2e(cluster, tmp_path):
    """A 3-task run yields a valid Chrome trace with one stitched row
    per task: six phases, monotonically ordered and contiguous; the
    `ray_tpu_torch events --task` surface returns the same transitions."""
    from ray_tpu_torch._private.events import TASK_PHASES, TASK_TRANSITIONS
    from ray_tpu_torch._private.state import task_transitions, timeline
    from ray_tpu_torch.util.state import list_cluster_events

    @ray_tpu_torch.remote
    def f(x):
        return x * 2

    assert ray_tpu_torch.get([f.remote(i) for i in range(3)], timeout=GET_TIMEOUT_S) == [0, 2, 4]

    deadline = time.time() + 20
    tids = []
    while time.time() < deadline:
        evs = list_cluster_events(category="task", limit=10_000)
        by = {}
        for e in evs:
            by.setdefault(e["entity"], set()).add(e["event"])
        tids = [
            t for t, names in by.items()
            if set(TASK_TRANSITIONS) <= names
        ]
        if len(tids) >= 3:
            break
        time.sleep(0.3)
    assert len(tids) >= 3, f"complete lifecycles: {len(tids)}"

    out = tmp_path / "trace.json"
    timeline(str(out))
    trace = json.loads(out.read_text())  # valid Chrome trace JSON
    assert isinstance(trace, list)
    by_task = {}
    for row in trace:
        if row.get("cat") == "task_phase":
            by_task.setdefault(row["args"]["task_id"], []).append(row)
    for tid in tids:
        rows = by_task[tid]
        assert [r["name"] for r in rows] == list(TASK_PHASES)
        for a, b in zip(rows, rows[1:]):
            assert a["dur"] >= 0
            # Contiguous + monotone: each phase starts where the
            # previous ended.
            assert b["ts"] == pytest.approx(a["ts"] + a["dur"])

    # Same transitions through the per-task read the CLI uses.
    names = [e["event"] for e in task_transitions(tids[0])]
    assert set(TASK_TRANSITIONS) <= set(names)
    ts = [e["timestamp"] for e in task_transitions(tids[0])]
    assert ts == sorted(ts)


def test_events_cli_lists_task_transitions(cluster, monkeypatch, capsys):
    from ray_tpu_torch._private.events import TASK_TRANSITIONS
    from ray_tpu_torch.scripts import cli
    from ray_tpu_torch.util.state import list_cluster_events

    @ray_tpu_torch.remote
    def g():
        return 1

    ray_tpu_torch.get(g.remote(), timeout=GET_TIMEOUT_S)
    deadline = time.time() + 20
    tid = None
    while time.time() < deadline and tid is None:
        for e in list_cluster_events(category="task", event="SEALED"):
            tid = e["entity"]
        if tid is None:
            time.sleep(0.3)
    assert tid is not None
    monkeypatch.setattr(cli, "_connect", lambda: None)
    cli.main(["events", "--task", tid])
    table = capsys.readouterr().out
    for name in ("SUBMITTED", "EXEC_START", "SEALED"):
        assert name in table
    cli.main(["events", "--task", tid, "--json"])
    rows = json.loads(capsys.readouterr().out)
    assert {r["event"] for r in rows} >= set(TASK_TRANSITIONS[:1])


def test_event_drops_exported_as_prometheus_counter(cluster):
    """Deliberate ring overflow: the drop count ships with the batch,
    lands in the aggregator, and surfaces as a Prometheus counter —
    never silently lost."""
    from ray_tpu_torch._private import events as ev
    from ray_tpu_torch._private.worker import global_client
    from ray_tpu_torch.util.metrics import (
        flight_recorder_snapshot,
        prometheus_text,
    )
    from ray_tpu_torch.util.state import summarize_events

    rec = ev.FlightRecorder(capacity=4, enabled=True, source="overflow-t")
    for i in range(20):
        rec.record(ev.TASK, f"x{i}", "SUBMITTED")
    items, dropped = rec.drain()
    assert dropped == 16
    global_client().send(
        {
            "type": "event_batch",
            "events": items,
            "events_dropped": dropped,
            "source": rec.source,
        }
    )
    deadline = time.time() + 10
    while time.time() < deadline:
        if summarize_events()["drops"].get("overflow-t", 0) >= 16:
            break
        time.sleep(0.2)
    text = prometheus_text(flight_recorder_snapshot())
    assert "# TYPE ray_tpu_torch_flight_recorder_dropped_total counter" in text
    assert (
        'ray_tpu_torch_flight_recorder_dropped_total{source="overflow-t"} 16'
        in text
    )


def test_flight_recorder_overhead_budget(cluster):
    """The recorder is always-on, so it must be nearly free: ≤5% on
    the single_client_tasks_async shape vs recorder disabled.

    Shared CI hosts swing far more than the 5% signal between fixed
    windows, so the measurement is built to survive that: both configs
    run in ONE cluster, A/B-ed with the runtime recording toggle in
    tightly-paired off/on segments so drift hits both sides alike.
    Each attempt produces two independent estimators —

    - wall: each side's fastest single batch (external load only ever
      slows a batch down, so per-side minima converge to true cost);
    - cpu: median over pairs of the segment ratio of driver-process
      CPU per task (`time.process_time` spans all threads of the
      driver process, which hosts the client loop, GCS dispatch AND
      the event indexer — exactly where recorder cost lands — and
      neighbors' load cannot inflate it);

    and the budget must fail BOTH estimators on EVERY attempt before
    the test does. A real regression (overhead well past 5%) fails
    them all; a one-sided load spike cannot."""
    import statistics

    from ray_tpu_torch.util.state import set_events_recording

    @ray_tpu_torch.remote
    def tiny():
        return b"ok"

    batch = 200
    # Warm up: spawn workers, grow the lease pool to steady state.
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 3.0:
        ray_tpu_torch.get([tiny.remote() for _ in range(batch)], timeout=GET_TIMEOUT_S)

    def segment(rounds: int):
        """(fastest single-batch wall seconds, CPU seconds) over
        `rounds` batches."""
        best_wall = float("inf")
        c0 = time.process_time()
        for _ in range(rounds):
            t0 = time.perf_counter()
            ray_tpu_torch.get([tiny.remote() for _ in range(batch)], timeout=GET_TIMEOUT_S)
            best_wall = min(best_wall, time.perf_counter() - t0)
        return best_wall, time.process_time() - c0

    attempts = []
    try:
        for _attempt in range(4):
            wall_on = wall_off = float("inf")
            cpu_ratios = []
            for _ in range(6):
                set_events_recording(False)
                w_off, c_off = segment(5)
                set_events_recording(True)
                w_on, c_on = segment(5)
                wall_off = min(wall_off, w_off)
                wall_on = min(wall_on, w_on)
                if c_on > 0:
                    cpu_ratios.append(c_off / c_on)
            wall_ratio = wall_off / wall_on
            cpu_ratio = statistics.median(cpu_ratios) if cpu_ratios else 1.0
            attempts.append((wall_ratio, cpu_ratio))
            if wall_ratio >= 0.95 or cpu_ratio >= 0.95:
                break
        else:
            raise AssertionError(
                "flight recorder overhead over budget on every attempt "
                "and both estimators: (wall, cpu) off/on ratios "
                f"{[('%.3f' % w, '%.3f' % c) for w, c in attempts]} "
                "all < 0.95"
            )
    finally:
        set_events_recording(True)  # leave the cluster fixture as found
