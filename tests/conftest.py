import os
import tempfile

import pytest

import ray_tpu


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc; skips without them"
    )
    # With the witness armed, point every process — this one and the
    # spawned heads/raylets/workers, via env inheritance — at ONE
    # sidecar violations file. sessionfinish scans it, so an inversion
    # witnessed inside a daemon fails the run too; violations() alone
    # only ever sees the driver process.
    from ray_tpu._private import lock_witness

    if lock_witness.enabled() and not os.environ.get(
        lock_witness.FILE_ENV
    ):
        path = os.path.join(
            tempfile.gettempdir(),
            f"rtpu_lock_witness_{os.getpid()}.log",
        )
        try:
            os.unlink(path)
        except OSError:
            pass
        os.environ[lock_witness.FILE_ENV] = path


def pytest_sessionfinish(session, exitstatus):
    """With the lock witness armed (make race-smoke), a suite that ran
    green but witnessed a lock-order inversion still FAILS — the
    violation is a deadlock waiting for production traffic to align."""
    from ray_tpu._private import lock_witness

    if lock_witness.installed():
        vs = lock_witness.violations()
        rep = lock_witness.witness_report()
        print(f"\n[lock-witness] {rep}")
        side = os.environ.get(lock_witness.FILE_ENV)
        side_text = ""
        if side and os.path.exists(side):
            with open(side, encoding="utf-8") as f:
                side_text = f.read().strip()
            try:
                os.unlink(side)  # consumed: don't leak one per run
            except OSError:
                pass
        if vs or side_text:
            if side_text:
                # The sidecar already holds this process's findings
                # (pid-tagged) alongside any daemon's — printing the
                # in-memory list too would show each driver inversion
                # twice.
                print(
                    "[lock-witness] sidecar findings (all processes, "
                    "incl. spawned daemons):"
                )
                print(side_text)
            else:
                for v in vs:
                    print(v.render())
            session.exitstatus = 3


@pytest.fixture
def ray_start():
    """Fresh local cluster per test (reference: conftest ray_start_regular)."""
    ray_tpu.init(num_cpus=4, ignore_reinit_error=True)
    yield
    ray_tpu.shutdown()


@pytest.fixture
def ray_start_2_cpus():
    ray_tpu.init(num_cpus=2, ignore_reinit_error=True)
    yield
    ray_tpu.shutdown()
