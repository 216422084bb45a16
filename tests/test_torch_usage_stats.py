"""The port's offline usage stats: tests/test_usage_stats.py, case for
case, on the port's runtime. Every test has a deadline after which it
fails instead of hanging, and every `get` and `wait` a timeout.

The reference's docstring:

Offline usage stats (reference: _private/usage/usage_lib.py —
same recording surface, local-JSONL sink, nothing leaves the host).
"""
import json
import os
import signal

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import usage_stats

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
def sink(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_TEMP_DIR", str(tmp_path))
    monkeypatch.setattr(usage_stats, "_path", None)
    yield tmp_path


def test_record_and_flush(sink):
    usage_stats.record_library_usage("data")
    usage_stats.record_extra_usage_tag("train_backend", "jax")
    path = usage_stats.flush()
    assert path and os.path.exists(path)
    rows = usage_stats.read_all()
    assert rows and "data" in rows[-1]["libraries"]
    assert rows[-1]["tags"]["train_backend"] == "jax"


def test_disable_env(sink, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "0")
    assert usage_stats.flush() is None


def test_library_imports_register(sink):
    import ray_tpu_torch.data  # noqa: F401
    import ray_tpu_torch.tune  # noqa: F401

    snap = usage_stats.cluster_snapshot()
    assert "data" in snap["libraries"] and "tune" in snap["libraries"]


def test_shutdown_flushes(sink):
    ray_tpu_torch.init(num_cpus=1, ignore_reinit_error=True)
    usage_stats.record_library_usage("core")
    ray_tpu_torch.shutdown()
    rows = usage_stats.read_all()
    assert rows and "core" in rows[-1]["libraries"]
