"""The port's log pipeline: tests/test_logging.py, case for case, on the
port's runtime. Every test has a deadline after which it fails instead
of hanging, and every `get` and `wait` a timeout.

The reference's docstring:

Log pipeline: worker stdout reaches the driver with (node, worker)
prefixes; `get_logs` serves the ring; dedup collapses floods.

Reference behavior: python/ray/_private/log_monitor.py +
ray_logging/__init__.py:259-294.
"""
import signal
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.log_monitor import LogDeduplicator
from ray_tpu_torch._private.worker import global_client

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


@pytest.fixture
def cluster():
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def test_worker_prints_reach_driver(cluster, capfd):
    @ray_tpu_torch.remote
    class Chatty:
        def speak(self, text):
            print(f"chatty-says {text}", flush=True)
            return text

    a = Chatty.remote()
    assert ray_tpu_torch.get(a.speak.remote("hello-logs"), timeout=30) == "hello-logs"
    deadline = time.time() + 10
    seen = ""
    while time.time() < deadline:
        out, _ = capfd.readouterr()
        seen += out
        if "chatty-says hello-logs" in seen:
            break
        time.sleep(0.2)
    assert "chatty-says hello-logs" in seen, seen[-2000:]
    # Driver prefix carries the node and worker identity.
    line = next(l for l in seen.splitlines() if "chatty-says hello-logs" in l)
    assert line.startswith("(head worker="), line
    ray_tpu_torch.kill(a)


def test_get_logs_ring(cluster):
    @ray_tpu_torch.remote
    def noisy(i):
        print(f"noisy-line-{i}", flush=True)
        return i

    ray_tpu_torch.get([noisy.remote(i) for i in range(5)], timeout=GET_TIMEOUT_S)
    deadline = time.time() + 10
    lines = []
    while time.time() < deadline:
        reply = global_client().request({"type": "get_logs", "tail": 500})
        lines = [l for _, _, l in reply["lines"] if l.startswith("noisy-line-")]
        if len(set(lines)) >= 5:
            break
        time.sleep(0.2)
    assert len(set(lines)) >= 5, lines


def test_dedup_collapses_repeats():
    d = LogDeduplicator(window_s=60.0)
    entries = [("n", f"w{i}", "same warning") for i in range(50)]
    out = d.filter(entries)
    assert len(out) == 1  # 49 suppressed inside the window
    out2 = d.filter([("n", "w0", "different line")])
    assert [e[2] for e in out2] == ["different line"]
