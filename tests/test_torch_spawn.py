"""The port's worker spawning: tests/test_spawn.py, case for case, on the
port's runtime. Every test has a deadline after which it fails instead
of hanging, and every `get` and `wait` a timeout.

The reference's docstring:

Worker spawning: pipelined zygote forks and their failure escapes
(reference behavior: worker_pool.cc StartWorkerProcess async spawn with
registration-failure cleanup).
"""
import signal
import subprocess
import sys

from ray_tpu_torch._private.spawn import ForkedProc
import pytest

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


def test_forked_proc_fallback_rescues_failed_fork():
    """A zygote fork failure escapes to the cold-path Popen: the handle
    resolves to the fallback child and nobody is told of a death."""
    deaths = []
    proc = ForkedProc(
        on_fail=lambda: deaths.append(1),
        fallback=lambda: subprocess.Popen([sys.executable, "-c", "pass"]),
    )
    proc._fail()  # what the zygote reply loop does on a pid-less reply
    assert proc.pid > 0
    assert proc.wait(timeout=30) == 0
    assert proc.poll() == 0  # reaped via the Popen handle
    assert not deaths


def test_forked_proc_on_fail_when_fallback_also_fails():
    deaths = []

    def bad_fallback():
        raise OSError("no more processes")

    proc = ForkedProc(on_fail=lambda: deaths.append(1), fallback=bad_fallback)
    proc._fail()
    assert proc.poll() == 1
    assert deaths == [1]


def test_forked_proc_signal_before_resolve_is_delivered():
    """A kill issued while the fork is in flight lands when the pid
    resolves (the reply loop runs _resolve)."""
    proc = ForkedProc()
    proc.kill()  # queued: no pid yet
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    proc._resolve(child.pid)
    assert child.wait(timeout=30) != 0  # SIGKILL delivered on resolve
