"""The port's GCS persistence and head restarts:
tests/test_gcs_persistence.py, case for case, on the port's runtime.
Every test has a deadline after which it fails instead of hanging, and
every `get` and `wait` a timeout.

The reference's docstring:

GCS persistence + head restart recovery.

Reference behavior: the Redis-backed gcs store_client
(src/ray/gcs/store_client/redis_store_client.h) and
NotifyGCSRestart (src/ray/raylet/node_manager.h:614): kill the head,
restart it on the same endpoint, and the cluster recovers — daemons
rejoin, named/detached actors restart from their creation specs, KV
survives, and tasks queued at the old head complete.
"""
import os
import secrets
import signal
import socket
import subprocess
import sys
import time

import pytest

from ray_tpu_torch._private.node import gcs_socket_path
from torch_runtime_cases import daemon_shm, shm_of  # noqa: F401 - a fixture

DEADLINE_S = 150
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kill(proc: subprocess.Popen, left: set) -> None:
    """SIGKILLs a head or node daemon, noting its `/dev/shm/rtpt_*`
    files for the `daemon_shm` finalizer first."""
    left.update(shm_of(proc.pid))
    proc.kill()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_head(session_dir: str, port: int, authkey: str,
                extra_env: dict = None) -> subprocess.Popen:
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "ray_tpu_torch._private.head_main",
            "--session-dir", session_dir,
            "--tcp-port", str(port),
            "--authkey", authkey,
            "--num-cpus", "0",
        ],
        env={**os.environ, "PYTHONPATH": REPO, **(extra_env or {})},
        stderr=subprocess.PIPE,
    )
    # Wait for the listening line.
    deadline = time.time() + 30
    while time.time() < deadline:
        line = proc.stderr.readline().decode(errors="replace")
        if "head up" in line:
            return proc
        if proc.poll() is not None:
            raise RuntimeError(f"head exited: {proc.stderr.read().decode()}")
    raise TimeoutError("head did not come up")


def _spawn_raylet(address: str, authkey: str, resources: str) -> subprocess.Popen:
    return subprocess.Popen(
        [
            sys.executable, "-m", "ray_tpu_torch._private.raylet",
            "--address", address,
            "--authkey", authkey,
            "--resources", resources,
            "--transfer-host", "127.0.0.1",
        ],
        env={**os.environ, "PYTHONPATH": REPO},
        stderr=subprocess.DEVNULL,
        stdout=subprocess.DEVNULL,
    )


def _run_driver(code: str, address: str) -> str:
    out = subprocess.run(
        [sys.executable, "-c", code, address],
        env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr.decode(errors="replace")
    return out.stdout.decode(errors="replace")


PHASE1 = """
import sys, time
import ray_tpu_torch

ray_tpu_torch.init(address=sys.argv[1])

@ray_tpu_torch.remote
class Counter:
    def __init__(self):
        self.n = 0
    def mark(self, key):
        import ray_tpu_torch as rt
        from ray_tpu_torch._private.worker import global_client
        self.n += 1
        global_client().kv_put(key.encode(), str(self.n).encode())
        return self.n

# Detached + named + restartable: survives this driver, restarts after
# head failover, and its method calls route via the GCS (so they queue
# head-side while the actor is still pending on the 'late' resource).
c = Counter.options(
    name="survivor", lifetime="detached", max_restarts=3,
    resources={"late": 1},
).remote()
c.mark.remote("queued_marker")
time.sleep(1.0)  # let the buffered call + creation spec land in the GCS
from ray_tpu_torch._private.worker import global_client
global_client().kv_put(b"phase1", b"done")
time.sleep(0.5)  # persist tick
print("PHASE1-OK")
"""

PHASE2 = """
import sys, time
import ray_tpu_torch
from ray_tpu_torch._private.worker import global_client

ray_tpu_torch.init(address=sys.argv[1])
client = global_client()
assert client.kv_get(b"phase1") == b"done", "kv lost across restart"

# Named actor resolves after head restart.
c = ray_tpu_torch.get_actor("survivor")

# The task queued at the OLD head completed after failover.
deadline = time.time() + 60
val = None
while time.time() < deadline:
    val = client.kv_get(b"queued_marker")
    if val is not None:
        break
    time.sleep(0.5)
assert val is not None, "queued task never completed after head restart"

# And the restarted actor serves new calls.
n = ray_tpu_torch.get(c.mark.remote("post_restart"), timeout=60)
assert n >= 1
print("PHASE2-OK", val.decode(), n)
"""


def test_head_restart_recovers_state(tmp_path, daemon_shm):
    session_dir = str(tmp_path / "headsess")
    daemon_shm.add(gcs_socket_path(session_dir))
    port = _free_port()
    authkey = secrets.token_bytes(16).hex()
    address = f"127.0.0.1:{port}?{authkey}"

    head = _spawn_head(session_dir, port, authkey)
    raylet1 = _spawn_raylet(f"127.0.0.1:{port}", authkey, '{"CPU": 2}')
    try:
        time.sleep(1.0)
        assert "PHASE1-OK" in _run_driver(PHASE1, address)

        # SIGKILL the head mid-session: the actor is still PENDING on
        # the missing 'late' resource, its first call queued head-side.
        _kill(head, daemon_shm)
        head.wait(timeout=10)
        time.sleep(0.5)

        head = _spawn_head(session_dir, port, authkey)

        # The surviving raylet rejoins; a new node brings the 'late'
        # resource so the detached actor can finally schedule.
        raylet2 = _spawn_raylet(
            f"127.0.0.1:{port}", authkey, '{"CPU": 1, "late": 1}'
        )
        try:
            out = _run_driver(PHASE2, address)
            assert "PHASE2-OK" in out
        finally:
            _kill(raylet2, daemon_shm)
    finally:
        for p in (raylet1, head):
            try:
                _kill(p, daemon_shm)
            except Exception:
                pass


def test_mid_persist_kill_loads_last_complete_generation(tmp_path, daemon_shm):
    """ISSUE 9 satellite: a head killed MID persist tick — new table
    files on disk, manifest not yet swapped (chaos kill point
    gcs.mid_persist) — must never leave a torn snapshot: the restarted
    head loads the last COMPLETE generation (the manifest-last atomic
    rename ordering is the crash-consistency contract)."""
    import pickle

    session_dir = str(tmp_path / "headsess")
    daemon_shm.add(gcs_socket_path(session_dir))
    port = _free_port()
    authkey = secrets.token_bytes(16).hex()
    address = f"127.0.0.1:{port}?{authkey}"

    # The 1st dirty persist tick (marker A) completes; the 2nd (marker
    # B) dies between the table-file writes and the manifest swap.
    head = _spawn_head(
        session_dir, port, authkey,
        extra_env={
            "RAY_TPU_TORCH_chaos_spec": "kill:gcs.mid_persist=2?role=head",
            "RAY_TPU_TORCH_chaos_seed": "1",
        },
    )
    daemon_shm.update(shm_of(head.pid))  # it dies at its own kill point
    state_dir = os.path.join(session_dir, "gcs_state.d")

    def manifest_kv_file():
        try:
            with open(os.path.join(state_dir, "manifest.pkl"), "rb") as f:
                return pickle.load(f).get("kv")
        except (OSError, pickle.PickleError):
            return None

    try:
        _run_driver(
            """
import sys
import ray_tpu_torch
from ray_tpu_torch._private.worker import global_client
ray_tpu_torch.init(address=sys.argv[1])
global_client().kv_put(b"marker_a", b"1")
print("A-OK")
""",
            address,
        )
        # Wait for tick 1 (marker_a) to land in the manifest.
        deadline = time.time() + 20
        while time.time() < deadline and manifest_kv_file() is None:
            time.sleep(0.1)
        gen1_kv = manifest_kv_file()
        assert gen1_kv is not None, "first persist never landed"

        # marker_b dirties the kv table; the persist tick for it dies
        # at the kill point (after table files, before manifest swap).
        subprocess.run(
            [sys.executable, "-c", """
import sys
import ray_tpu_torch
from ray_tpu_torch._private.worker import global_client
ray_tpu_torch.init(address=sys.argv[1])
global_client().kv_put(b"marker_b", b"1")
""", address],
            env={**os.environ, "PYTHONPATH": REPO},
            timeout=60,
        )
        try:
            head.wait(timeout=30)  # the kill point fires on that tick
        except subprocess.TimeoutExpired:
            raise AssertionError("head survived the mid-persist kill point")
        # Torn state on disk: a NEWER kv table file exists but the
        # manifest still names the last complete generation.
        assert manifest_kv_file() == gen1_kv
        newer = [
            f for f in os.listdir(state_dir)
            if f.startswith("kv.") and not f.endswith(".tmp")
            and f != gen1_kv
        ]
        assert newer, "kill point fired before the torn window"

        head = _spawn_head(session_dir, port, authkey)
        out = _run_driver(
            """
import sys
import ray_tpu_torch
from ray_tpu_torch._private.worker import global_client
ray_tpu_torch.init(address=sys.argv[1])
c = global_client()
assert c.kv_get(b"marker_a") == b"1", "complete generation lost"
print("RESTORED", c.kv_get(b"marker_b"))
""",
            address,
        )
        # marker_a (last complete cut) MUST be there; marker_b belongs
        # to the torn tick and must read as cleanly absent, not corrupt.
        assert "RESTORED None" in out
    finally:
        try:
            _kill(head, daemon_shm)
        except Exception:
            pass


def test_segmented_persistence_rewrites_only_dirty_tables(tmp_path):
    """A KV put must not re-serialize the actor/object tables
    (reference: the Redis store writes per key; the old single-pickle
    snapshot was O(cluster state) per write-batch)."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import _global, global_client

    ray_tpu_torch.init(num_cpus=2, _temp_dir=str(tmp_path))
    try:
        @ray_tpu_torch.remote
        class Keep:
            def ping(self):
                return "ok"

        a = Keep.options(name="seg_actor").remote()
        assert ray_tpu_torch.get(a.ping.remote(), timeout=GET_TIMEOUT_S) == "ok"
        ref = ray_tpu_torch.put(b"x" * 64)  # inline object -> objects table
        state_dir = os.path.join(_global.node.session_dir, "gcs_state.d")

        def tables_present():
            if not os.path.isdir(state_dir):
                return set()
            return {f.split(".")[0] for f in os.listdir(state_dir)}

        deadline = time.time() + 10
        while time.time() < deadline and not (
            {"actors", "objects", "manifest"} <= tables_present()
        ):
            time.sleep(0.1)
        def mtimes():
            return {
                f: os.path.getmtime(os.path.join(state_dir, f))
                for f in os.listdir(state_dir)
            }

        # Quiesce: async task_done batches from the warm-up calls dirty
        # the actors table a beat later — baseline only once the files
        # have been stable for a full second.
        before = mtimes()
        deadline = time.time() + 20
        while time.time() < deadline:
            time.sleep(1.0)
            now = mtimes()
            if now == before:
                break
            before = now
        for i in range(5):
            global_client().kv_put(f"seg{i}".encode(), b"v")
        def newest(table):
            files = [
                f for f in os.listdir(state_dir)
                if f.startswith(table + ".") and not f.endswith(".tmp")
            ]
            return max(files, default=None)

        before_files = {
            t: newest(t) for t in ("kv", "actors", "objects",
                                   "named_actors")
        }
        deadline = time.time() + 10
        while time.time() < deadline:
            if newest("kv") != before_files["kv"]:
                break
            time.sleep(0.1)
        assert newest("kv") != before_files["kv"], "kv never persisted"
        for t in ("actors", "objects", "named_actors"):
            if before_files[t] is not None:
                assert newest(t) == before_files[t], (
                    f"{t} table rewritten by a pure KV put"
                )
        del ref
    finally:
        ray_tpu_torch.shutdown()
