"""The port's dashboard: tests/test_dashboard_tracing.py (2) and
tests/test_serve_rest.py (4), case for case, on the port's runtime and
its Serve, and the workflow route, whose POST releases a waiting
workflow.

Each dashboard binds a free port picked at the test's start (the
reference's files bind 18266 and 18280, which a reference test running
beside this file may hold). Every test has a deadline after which it
fails instead of hanging, every `get` and request a timeout.
"""
import json
import signal
import socket
import sys
import textwrap
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch

DEADLINE_S = 150
HTTP_TIMEOUT_S = 60


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
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(url, method="GET", body=None, timeout=HTTP_TIMEOUT_S):
    req = urllib.request.Request(url, method=method)
    data = None
    if body is not None:
        data = json.dumps(body).encode()
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, data=data, timeout=timeout) as r:
        raw = r.read()
        return r.status, json.loads(raw) if raw else None


# --------------------------------------- tests/test_dashboard_tracing.py


@pytest.fixture
def cluster():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def test_dashboard_serves_state(cluster):
    from ray_tpu_torch.dashboard import start_dashboard

    url = start_dashboard(port=_free_port())

    @ray_tpu_torch.remote
    def f():
        return 1

    ray_tpu_torch.get([f.remote() for _ in range(3)], timeout=HTTP_TIMEOUT_S)

    with urllib.request.urlopen(f"{url}/", timeout=HTTP_TIMEOUT_S) as r:
        shell = r.read()
        assert b"ray_tpu_torch dashboard" in shell
        assert b"/static/app.js" in shell  # SPA shell loads the app
    with urllib.request.urlopen(f"{url}/static/app.js", timeout=HTTP_TIMEOUT_S) as r:
        js = r.read()
        assert r.headers.get_content_type() == "application/javascript"
        # every nav page has a renderer
        for page in (b"overview", b"nodes", b"jobs", b"serve", b"profile"):
            assert b"PAGES." + page in js
    with urllib.request.urlopen(f"{url}/static/style.css", timeout=HTTP_TIMEOUT_S) as r:
        assert r.headers.get_content_type() == "text/css"
    try:
        urllib.request.urlopen(f"{url}/static/../__init__.py", timeout=HTTP_TIMEOUT_S)
        assert False, "traversal must 404"
    except urllib.error.HTTPError as e:
        assert e.code == 404
    with urllib.request.urlopen(f"{url}/api/jobs", timeout=HTTP_TIMEOUT_S) as r:
        assert json.loads(r.read()) == []  # no jobs submitted yet
    with urllib.request.urlopen(f"{url}/api/cluster", timeout=HTTP_TIMEOUT_S) as r:
        cluster_info = json.loads(r.read())
        assert cluster_info["total"]["CPU"] == 4.0
    with urllib.request.urlopen(f"{url}/api/tasks", timeout=HTTP_TIMEOUT_S) as r:
        tasks = json.loads(r.read())
        assert any(t["name"] == "f" for t in tasks)
    with urllib.request.urlopen(f"{url}/api/nodes", timeout=HTTP_TIMEOUT_S) as r:
        assert len(json.loads(r.read())) >= 1


def test_tracing_spans_parent_child(cluster, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_TRACE", "1")
    from ray_tpu_torch.util import tracing

    @ray_tpu_torch.remote
    def child_task(x):
        time.sleep(0.02)
        return x * 2

    with tracing.span("driver_block"):
        ref = child_task.remote(21)
        assert ray_tpu_torch.get(ref, timeout=HTTP_TIMEOUT_S) == 42

    spans = tracing.get_trace()
    names = {s["name"] for s in spans}
    assert "driver_block" in names and "child_task" in names
    driver = next(s for s in spans if s["name"] == "driver_block")
    child = next(s for s in spans if s["name"] == "child_task")
    # Same trace; the task span is a child of the driver span.
    assert child["trace_id"] == driver["trace_id"]
    assert child["parent_span_id"] == driver["span_id"]
    assert child["end"] - child["start"] >= 0.015


# -------------------------------------------- tests/test_serve_rest.py


@pytest.fixture(scope="module")
def app_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("serve_rest_apps")


@pytest.fixture(scope="module")
def dash(app_dir):
    import os

    # The REST deploy imports the application INSIDE the dashboard
    # actor process; PYTHONPATH set before init propagates to spawned
    # workers (a real user ships code via runtime_env py_modules).
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = (
        f"{app_dir}:{old}" if old else str(app_dir)
    )
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    from ray_tpu_torch.dashboard import start_dashboard

    url = start_dashboard(port=_free_port())
    yield url
    if old is None:
        os.environ.pop("PYTHONPATH", None)
    else:
        os.environ["PYTHONPATH"] = old
    try:
        from ray_tpu_torch import serve

        serve.shutdown()
    except Exception:  # noqa: BLE001
        pass
    ray_tpu_torch.shutdown()


def test_serve_rest_deploy_get_delete(dash, app_dir):
    mod = app_dir / "rest_app_mod_torch.py"
    mod.write_text(
        textwrap.dedent(
            """
            from ray_tpu_torch import serve

            @serve.deployment
            class Upper:
                def __call__(self, x):
                    return str(x).upper()

            app = Upper.bind()
            """
        )
    )
    sys.path.insert(0, str(app_dir))
    try:
        # PUT the declarative config: deploys over HTTP, no CLI.
        status, apps = _req(
            f"{dash}/api/serve/applications/",
            method="PUT",
            body={
                "applications": [
                    {
                        "name": "rest_app",
                        "route_prefix": None,
                        "import_path": "rest_app_mod_torch:app",
                        "deployments": [
                            {"name": "Upper", "num_replicas": 2}
                        ],
                    }
                ]
            },
            timeout=120,
        )
        assert status == 200
        assert apps["rest_app"]["status"] == "RUNNING"
        assert apps["rest_app"]["deployments"]["Upper"]["num_replicas"] == 2

        # The app actually serves.
        from ray_tpu_torch import serve

        handle = serve.get_app_handle("rest_app")
        assert handle.remote("hi").result(timeout_s=30) == "HI"

        # GET reflects live status; the dashboard shows it without CLI.
        status, apps = _req(f"{dash}/api/serve/applications/")
        assert status == 200 and "rest_app" in apps

        # Bad config -> 400 with an error, not a 500.
        try:
            _req(
                f"{dash}/api/serve/applications/",
                method="PUT",
                body={"applications": [{"name": "x"}]},
            )
            raised = False
        except urllib.error.HTTPError as e:
            raised = True
            assert e.code == 400
        assert raised

        # DELETE tears everything down.
        req = urllib.request.Request(
            f"{dash}/api/serve/applications/", method="DELETE"
        )
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            assert r.status == 204
        status, apps = _req(f"{dash}/api/serve/applications/")
        assert apps == {}
    finally:
        sys.path.remove(str(app_dir))


def test_task_and_actor_drilldown(dash):
    @ray_tpu_torch.remote
    class Worker:
        def work(self, n):
            return n * 2

    w = Worker.remote()
    assert ray_tpu_torch.get(w.work.remote(21), timeout=HTTP_TIMEOUT_S) == 42

    # Find the actor id via the state API the dashboard uses.
    from ray_tpu_torch.util.state import list_actors

    actors = [a for a in list_actors(limit=1000) if a.get("state") == "ALIVE"]
    assert actors
    aid = actors[-1]["actor_id"]
    status, detail = _req(f"{dash}/api/actor/{aid}")
    assert status == 200
    assert detail["actor"]["actor_id"] == aid

    from ray_tpu_torch.util.state import list_tasks

    tasks = list_tasks(limit=1000)
    assert tasks
    tid = tasks[-1]["task_id"]
    status, detail = _req(f"{dash}/api/task/{tid}")
    assert status == 200
    assert detail["task"]["task_id"] == tid

    # Unknown ids 404.
    with pytest.raises(urllib.error.HTTPError):
        _req(f"{dash}/api/actor/ffffffffffff")


def test_per_node_timeseries(dash):
    deadline = time.time() + 30
    series = {}
    while time.time() < deadline:
        with urllib.request.urlopen(
            f"{dash}/api/metrics_timeseries", timeout=10
        ) as r:
            series = json.loads(r.read())["series"]
        if any(name.startswith("CPU used @") for name in series):
            return
        time.sleep(1)
    pytest.fail(f"no per-node series in {sorted(series)}")


def test_serve_put_malformed_body_is_400(dash):
    req = urllib.request.Request(
        f"{dash}/api/serve/applications/",
        method="PUT",
        data=b"not json at all",
        headers={"Content-Type": "application/json"},
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400


# ------------------------------------------------------ workflow events


def test_workflow_event_posted_over_http_releases_a_waiting_workflow(dash, tmp_path):
    """The reference's route, now on the port's workflow: a POST to
    /api/workflow/events/{key} fires the event a waiting workflow node
    resolves to (test_dag_workflow.py::test_workflow_event_over_http)."""
    from ray_tpu_torch import workflow

    workflow.init(str(tmp_path / "wf_http"))

    @ray_tpu_torch.remote
    def consume(evt):
        return evt["source"]

    fut = workflow.run_async(
        consume.bind(workflow.wait_for_event("dash/deploy/done", timeout_s=60)),
        workflow_id="dash-http-evt",
    )
    time.sleep(0.5)
    assert not fut.done()
    status, body = _req(f"{dash}/api/workflow/events/dash/deploy/done", "POST",
                        {"source": "ci-pipeline"})
    assert status == 200 and body == {"ok": True, "key": "dash/deploy/done"}
    assert fut.result(timeout=HTTP_TIMEOUT_S) == "ci-pipeline"


def test_prometheus_metrics_carry_the_ports_series(dash):
    with urllib.request.urlopen(f"{dash}/metrics", timeout=HTTP_TIMEOUT_S) as r:
        text = r.read().decode()
    assert "# TYPE ray_tpu_torch_nodes_alive gauge" in text
    assert "ray_tpu_torch_resources_total{resource=\"CPU\"} 4.0" in text
    assert "ray_tpu_torch_task_phase_seconds_count" in text
