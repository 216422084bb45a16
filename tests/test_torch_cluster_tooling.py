"""The port's cluster tooling: tests/test_cluster_tooling.py, case for
case, on the port's runtime, then the reference and the port side by
side where the comparison means something.

The reference's docstring: state API, timeline, metrics, cluster
harness, jobs, autoscaler, CLI — models the reference's python/ray/tests
coverage of util/state, ray.timeline, util/metrics, cluster_utils, job
submission, and the autoscaler fake-provider loop.

Then: the state API's columns and `summarize_tasks` of one workload on
both runtimes; `init(address="auto")` with and without a head; the
session file, which is the port's own; `num_gpus` where the reference
has `num_tpus`; the job supervisor on the head node; the remote
debugger. Every test has a deadline after which it fails instead of
hanging, every `get` and every subprocess wait a timeout. Standalone
heads started here write under a fresh temp root of their own
(RAY_TPU_TORCH_TEMP_DIR), so no other head on the machine is read.
"""
import importlib
import inspect
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster

DEADLINE_S = 150
GET_TIMEOUT_S = 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def cluster():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def temp_root(monkeypatch):
    """A fresh temp root for this test's standalone head and CLI calls
    (short: the head's socket lies under it)."""
    root = tempfile.mkdtemp(prefix="rtpt")
    monkeypatch.setenv("RAY_TPU_TORCH_TEMP_DIR", root)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _env():
    return {**os.environ, "PYTHONPATH": REPO}


def _cli(*args, timeout=60):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", *args],
        env=_env(), capture_output=True, text=True, timeout=timeout,
    )


class _Head:
    """`python -m ray_tpu_torch start --head` in a subprocess, up once
    `status` answers; `stop` ends it."""

    def __init__(self, *args):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "start", "--head", *args],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        deadline = time.time() + 60
        while time.time() < deadline:
            r = _cli("status")
            if r.returncode == 0 and "Cluster status" in r.stdout:
                self.status = r.stdout
                return
            assert self.proc.poll() is None, self.proc.stdout.read()
            time.sleep(0.5)
        raise AssertionError("CLI status never succeeded")

    def stop(self):
        _cli("stop", timeout=30)
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)


# ------------------------------------------- tests/test_cluster_tooling.py


def test_state_api_lists(cluster):
    from ray_tpu_torch.util.state import (
        list_actors,
        list_nodes,
        list_tasks,
        list_workers,
        summarize_tasks,
    )

    @ray_tpu_torch.remote
    def f(x):
        return x

    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return "pong"

    a = A.options(name="state_test_actor").remote()
    ray_tpu_torch.get(a.ping.remote(), timeout=GET_TIMEOUT_S)
    ray_tpu_torch.get([f.remote(i) for i in range(5)], timeout=GET_TIMEOUT_S)

    actors = list_actors()
    assert any(x["name"] == "state_test_actor" for x in actors)
    nodes = list_nodes()
    assert len(nodes) >= 1 and nodes[0]["alive"]
    workers = list_workers()
    assert len(workers) >= 1
    tasks = list_tasks()
    f_tasks = [t for t in tasks if t["name"] == "f"]
    assert len(f_tasks) == 5
    assert all(t["state"] == "FINISHED" for t in f_tasks)
    summary = summarize_tasks()
    assert summary["by_func_name"]["f"]["FINISHED"] == 5


def test_list_tasks_read_your_writes(cluster):
    """A list issued immediately after get() must include every task the
    caller saw finish, even when completions rode the leased-worker
    direct path whose task_done records are batched."""
    from ray_tpu_torch.util.state import list_tasks

    @ray_tpu_torch.remote
    def g(x):
        return x

    done = 0
    for burst in range(4):
        ray_tpu_torch.get([g.remote(i) for i in range(8)], timeout=GET_TIMEOUT_S)
        done += 8
        g_tasks = [t for t in list_tasks() if t["name"] == "g"]
        assert len(g_tasks) == done, f"burst {burst}: {len(g_tasks)}/{done}"


def test_timeline_export(cluster, tmp_path):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(0.05)
        return 1

    ray_tpu_torch.get([slow.remote() for _ in range(4)], timeout=GET_TIMEOUT_S)
    out = tmp_path / "trace.json"
    ray_tpu_torch.timeline(str(out))
    trace = json.loads(out.read_text())
    spans = [t for t in trace if t["name"] == "slow"]
    assert len(spans) == 4
    assert all(t["ph"] == "X" and t["dur"] >= 50_000 * 0.5 for t in spans)


def test_metrics_counter_gauge(cluster):
    from ray_tpu_torch.util.metrics import Counter, Gauge, get_metrics_snapshot

    c = Counter("test_requests", tag_keys=("route",))
    c.inc(tags={"route": "/a"})
    c.inc(2.0, tags={"route": "/a"})
    g = Gauge("test_qsize")
    g.set(7.0)
    snap = get_metrics_snapshot()
    series = {tuple(s["tags"].items()): s["value"]
              for s in snap["test_requests"]["series"]}
    assert series[(("route", "/a"),)] == 3.0
    assert snap["test_qsize"]["series"][0]["value"] == 7.0


def test_cluster_add_remove_node(cluster):
    c = Cluster(initialize_head=False)
    node = c.add_node(num_cpus=2, resources={"special": 1})
    assert ray_tpu_torch.cluster_resources().get("special") == 1.0

    @ray_tpu_torch.remote(resources={"special": 1})
    def on_special():
        return "ran"

    assert ray_tpu_torch.get(on_special.remote(), timeout=GET_TIMEOUT_S) == "ran"
    c.remove_node(node)
    deadline = time.time() + 10
    while time.time() < deadline:
        if "special" not in {
            k
            for n in ray_tpu_torch.nodes()
            if n["alive"]
            for k in n["total"]
        }:
            break
        time.sleep(0.1)


def test_job_submission(cluster):
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('job ran ok')\""
    )
    status = client.wait_until_finish(job_id, timeout_s=60)
    assert status == JobStatus.SUCCEEDED
    assert "job ran ok" in client.get_job_logs(job_id)
    jobs = client.list_jobs()
    assert any(j["job_id"] == job_id for j in jobs)

    bad = client.submit_job(entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
    assert client.wait_until_finish(bad, timeout_s=60) == JobStatus.FAILED


def test_autoscaler_scales_up_and_down(cluster):
    from ray_tpu_torch.autoscaler import Autoscaler

    scaler = Autoscaler(
        {"cpu_worker": {"resources": {"CPU": 2, "scale": 2}, "max_workers": 3}},
        idle_timeout_s=2.0,
        interval_s=0.2,
    )
    scaler.start()
    try:
        # Demand needing the custom resource only autoscaled nodes have.
        @ray_tpu_torch.remote(resources={"scale": 1})
        def burst(i):
            time.sleep(0.3)
            return i

        refs = [burst.remote(i) for i in range(6)]
        assert sorted(ray_tpu_torch.get(refs, timeout=90)) == list(range(6))
        assert scaler.num_launches >= 1
        # Idle nodes terminate after the timeout.
        deadline = time.time() + 30
        while time.time() < deadline:
            if scaler.num_terminations >= scaler.num_launches:
                break
            time.sleep(0.25)
        assert scaler.num_terminations >= 1
    finally:
        scaler.stop()


def test_cli_status_and_list(temp_root):
    """Drive the CLI against a standalone head (start → status → list →
    stop), exercising the session file + address='auto' path."""
    head = _Head("--num-cpus", "2")
    try:
        r = _cli("list", "nodes")
        assert r.returncode == 0 and "node_id" in r.stdout
    finally:
        head.stop()


def test_cli_submit_jobs_and_summary(temp_root):
    """`submit --wait` with a runtime_env (the port's CLI takes
    `--runtime-env-json`, as upstream Ray's does), then `jobs` and
    `summary tasks` against the same standalone head."""
    head = _Head("--num-cpus", "2")
    try:
        r = _cli("submit", "--wait", "--runtime-env-json",
                 json.dumps({"env_vars": {"RTPT_JOB_VAR": "from-the-env"}}), "--",
                 sys.executable, "-c", "\"import os; print(os.environ['RTPT_JOB_VAR'])\"",
                 timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
        job_id = r.stdout.split()[1].rstrip(":")
        assert "from-the-env" in r.stdout and f"job {job_id}: SUCCEEDED" in r.stdout
        bad = _cli("submit", "--wait", "--", sys.executable, "-c", "'raise SystemExit(3)'",
                   timeout=120)
        assert bad.returncode == 1 and ": FAILED" in bad.stdout
        jobs = _cli("jobs")
        assert jobs.returncode == 0 and job_id in jobs.stdout and "SUCCEEDED" in jobs.stdout
        summary = _cli("summary", "tasks")
        assert summary.returncode == 0
        assert json.loads(summary.stdout)["by_func_name"]["run"] == {"FINISHED": 2}
    finally:
        head.stop()


def test_actors_survive_live_head_failover_under_supervised_head():
    """`SupervisedHead`, as tests/test_fault_tolerance.py drives it: a
    detached actor and a max_restarts>0 actor stay callable through a
    live head failover, the driver connected, the node daemon (joined
    through `DaemonCluster.attach`) and its workers outliving the head."""
    from ray_tpu_torch.cluster_utils import DaemonCluster, SupervisedHead

    sess = tempfile.mkdtemp(prefix="rtpt")
    head = SupervisedHead(
        session_dir=os.path.join(sess, "sess"),
        env={"RAY_TPU_TORCH_head_recovery_grace_s": "5.0"},
    )
    cluster = None
    try:
        ray_tpu_torch.init(address=head.address)
        cluster = DaemonCluster.attach(head.tcp_address, head.authkey)
        cluster.add_node(num_cpus=2)

        @ray_tpu_torch.remote(max_restarts=2)
        class Phoenix:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        det = Phoenix.options(name="det_survivor", lifetime="detached").remote()
        reg = Phoenix.remote()
        assert ray_tpu_torch.get(det.incr.remote(), timeout=GET_TIMEOUT_S) == 1
        assert ray_tpu_torch.get(reg.incr.remote(), timeout=GET_TIMEOUT_S) == 1

        head.kill()
        assert head.wait_restarted(1, timeout=60), "head never came back"
        deadline = time.monotonic() + 90
        vals = {}
        while time.monotonic() < deadline and len(vals) < 2:
            for key, h in (("det", det), ("reg", reg)):
                if key in vals:
                    continue
                try:
                    vals[key] = ray_tpu_torch.get(h.incr.remote(), timeout=20)
                except Exception:  # noqa: BLE001 - mid-recovery
                    time.sleep(0.5)
        assert vals.get("det", 0) >= 1, "detached actor lost in failover"
        assert vals.get("reg", 0) >= 1, "restartable actor lost in failover"
        h = ray_tpu_torch.get_actor("det_survivor")
        assert ray_tpu_torch.get(h.incr.remote(), timeout=30) > vals["det"]
    finally:
        if cluster is not None:
            for p in list(cluster._daemons):
                try:
                    cluster.kill_node(p)
                except Exception:  # noqa: BLE001
                    pass
        try:
            ray_tpu_torch.shutdown()
        except Exception:  # noqa: BLE001
            pass
        head.stop()
        shutil.rmtree(sess, ignore_errors=True)


# ------------------------------------------------- against the reference


def _workload(rt):
    @rt.remote
    def f(x):
        return x

    @rt.remote
    class A:
        def ping(self):
            return "pong"

    a = A.options(name="columns_actor").remote()
    rt.get(a.ping.remote(), timeout=GET_TIMEOUT_S)
    rt.get([f.remote(i) for i in range(5)], timeout=GET_TIMEOUT_S)
    big = rt.put(b"x" * (1 << 20))
    pg = importlib.import_module(f"{rt.__name__}.util").placement_group([{"CPU": 1}])
    assert pg.wait(timeout_seconds=30)
    return a, big, pg


def test_state_api_columns_and_task_summary_match_the_reference():
    """The same workload on both runtimes at once: every state listing
    has the reference's columns, and `summarize_tasks` counts the
    workload's tasks as the reference does."""
    import ray_tpu.util.state as ref_state
    import ray_tpu_torch.util.state as port_state

    ray_tpu.init(num_cpus=4, ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    try:
        held = [_workload(ray_tpu), _workload(ray_tpu_torch)]
        for kind in ("actors", "tasks", "nodes", "workers", "objects",
                     "placement_groups"):
            ref = getattr(ref_state, f"list_{kind}")()
            port = getattr(port_state, f"list_{kind}")()
            assert ref and port, kind
            assert {frozenset(r) for r in ref} == {frozenset(p) for p in port}, kind
        ref, port = ref_state.summarize_tasks(), port_state.summarize_tasks()
        assert set(ref) == set(port) == {"total", "by_func_name"}
        for name in ("f", "ping"):
            assert ref["by_func_name"][name] == port["by_func_name"][name], name
        assert port["by_func_name"]["f"] == {"FINISHED": 5}
        del held
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def test_address_auto_without_a_head_raises_the_references_error(temp_root, monkeypatch):
    from ray_tpu.exceptions import RayTpuError as RefError
    from ray_tpu_torch.exceptions import RayTpuError

    with pytest.raises(RayTpuError) as port:
        ray_tpu_torch.init(address="auto")
    # The reference reads its own file under the temporary directory;
    # an empty one has no head either.
    monkeypatch.setattr(tempfile, "tempdir", temp_root)
    with pytest.raises(RefError) as ref:
        ray_tpu.init(address="auto")
    prefix = "address='auto' but no running head found"
    assert str(port.value).startswith(prefix) and str(ref.value).startswith(prefix)
    assert "python -m ray_tpu_torch start --head" in str(port.value)
    # The thin client's scheme: an address with no proxy behind it
    # refuses the connection, and one without a key is malformed.
    with pytest.raises(ConnectionRefusedError):
        ray_tpu_torch.init(address="ray_tpu_torch://127.0.0.1:1?00")
    with pytest.raises(RayTpuError, match="client address must be ray_tpu_torch://"):
        ray_tpu_torch.init(address="ray_tpu_torch://127.0.0.1:1")
    assert not ray_tpu_torch.is_initialized()


def test_address_auto_connects_to_the_standalone_head(temp_root):
    head = _Head("--num-cpus", "2", "--num-gpus", "0", "--port", "0")
    try:
        ray_tpu_torch.init(address="auto")
        try:
            assert ray_tpu_torch.cluster_resources() == {"CPU": 2.0}
            from ray_tpu_torch._private.worker import head_tcp_address

            with open(os.path.join(temp_root, "latest_session.json")) as f:
                info = json.load(f)
            assert head_tcp_address() == (info["tcp_address"],
                                          bytes.fromhex(info["authkey"]))

            @ray_tpu_torch.remote
            def pid():
                return os.getpid()

            assert ray_tpu_torch.get(pid.remote(), timeout=GET_TIMEOUT_S) != os.getpid()
        finally:
            ray_tpu_torch.shutdown()
    finally:
        head.stop()
    assert not os.path.exists(os.path.join(temp_root, "latest_session.json"))


def test_session_file_is_the_ports_own(temp_root):
    """Pinned divergence: the reference keeps `latest_session.json` under
    `$TMPDIR/ray_tpu/`; the port keeps its own under its temp root, so a
    head of each on one machine never reads the other's."""
    from ray_tpu.scripts import cli as ref_cli
    from ray_tpu_torch._private.config import session_file, temp_root as root

    assert ref_cli.SESSION_FILE == os.path.join(
        tempfile.gettempdir(), "ray_tpu", "latest_session.json")
    assert root() == temp_root
    assert session_file() == os.path.join(temp_root, "latest_session.json")
    assert session_file() != ref_cli.SESSION_FILE


def test_num_gpus_takes_the_place_of_num_tpus(cluster):
    """Pinned divergence: `Cluster.add_node`, `DaemonCluster.add_node`
    and `start` take `num_gpus` where the reference takes `num_tpus`."""
    from ray_tpu.cluster_utils import Cluster as RefCluster, DaemonCluster as RefDaemons
    from ray_tpu_torch.cluster_utils import DaemonCluster

    for ref, port in ((RefCluster, Cluster), (RefDaemons, DaemonCluster)):
        ref_args = inspect.signature(ref.add_node).parameters
        port_args = inspect.signature(port.add_node).parameters
        assert "num_tpus" in ref_args and "num_tpus" not in port_args
        assert "num_gpus" in port_args and "num_gpus" not in ref_args
    node = Cluster(initialize_head=False).add_node(num_cpus=1, num_gpus=2)
    assert node.resources == {"CPU": 1.0, "GPU": 2.0}
    assert ray_tpu_torch.cluster_resources().get("GPU") == 2.0
    assert "--num-gpus" in _cli("start", "--help").stdout
    assert "--num-tpus" not in _cli("start", "--help").stdout


def test_the_job_supervisor_runs_on_the_head_node(cluster):
    """Pinned divergence: the supervisor (and its entrypoint) runs on the
    head node, as upstream Ray's does; the reference's goes wherever a
    zero-CPU actor lands, and an autoscaled node that took it would stay
    busy for as long as it lives."""
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient
    from ray_tpu_torch.util.state import list_actors, list_nodes, list_workers

    extra = Cluster(initialize_head=False).add_node(num_cpus=2, label="extra")
    client = JobSubmissionClient()
    job_id = client.submit_job(entrypoint=f"{sys.executable} -c \"print('on the head')\"")
    assert client.wait_until_finish(job_id, timeout_s=60) == JobStatus.SUCCEEDED
    head = next(n["node_id"] for n in list_nodes() if n["label"] == "head")
    sup = next(a for a in list_actors() if a["name"] == f"_job_supervisor_{job_id}")
    workers = {w["worker_id"]: w for w in list_workers()}
    assert workers[sup["worker_id"]]["node_id"] == head != extra.node_id.hex()


def test_remote_debugger_attach_inspect_continue(cluster):
    """tests/test_rpdb.py on the port: `set_trace()` in a task parks it on
    a socket; a client attaches, reads a local and continues it."""
    from ray_tpu_torch.util import rpdb

    @ray_tpu_torch.remote
    def buggy(x):
        secret = x * 7
        rpdb.set_trace()
        return secret

    ref = buggy.remote(6)
    deadline = time.time() + 60
    live = []
    while time.time() < deadline and not live:
        live = rpdb.sessions()
        time.sleep(0.2)
    assert live, "no rpdb session registered"
    sock = rpdb.connect(live[0][1])
    sock.settimeout(30)
    f = sock.makefile("rw", buffering=1)

    def read_until_prompt():
        out = ""
        while not out.endswith("(rpdb) "):
            ch = f.read(1)
            if not ch:
                break
            out += ch
        return out

    read_until_prompt()
    f.write("p secret\n")
    assert "42" in read_until_prompt()
    f.write("c\n")
    f.flush()
    assert ray_tpu_torch.get(ref, timeout=GET_TIMEOUT_S) == 42
    sock.close()
