"""Cluster test harnesses.

Reference: python/ray/cluster_utils.py:135. Two levels of realism:

- ``Cluster``: N *logical* nodes in one GCS (the reference's in-process
  harness) — multi-node scheduling/failover tests in one process tree,
  all sharing the head's object store.
- ``DaemonCluster``: head GCS listening on TCP plus N real node-daemon
  *processes* (ray_tpu_torch._private.raylet), each with its own shm pool and
  object-transfer server — the full multi-host control + data plane on
  one machine, the way the reference's fake_multi_node provider runs
  real raylets locally.
"""
from __future__ import annotations

import os
import re
import secrets
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import ray_tpu_torch
from ._private.worker import global_client


class ClusterNode:
    def __init__(self, node_id: bytes, resources: Dict[str, float]):
        self.node_id = node_id
        self.resources = resources

    def __repr__(self):
        return f"ClusterNode({self.node_id.hex()[:8]}, {self.resources})"


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        head_node_args: Optional[dict] = None,
    ):
        self._nodes = []
        if initialize_head:
            ray_tpu_torch.init(**(head_node_args or {"num_cpus": 1}),
                         ignore_reinit_error=True)

    def add_node(self, *, num_cpus: float = 1, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 label: str = "") -> ClusterNode:
        """A logical node of ``num_cpus`` CPUs and ``num_gpus`` GPUs (the
        reference's ``num_tpus``) in this process's GCS."""
        res = {"CPU": float(num_cpus)}
        if num_gpus:
            res["GPU"] = float(num_gpus)
        res.update(resources or {})
        reply = global_client().request(
            {"type": "add_node", "resources": res, "label": label}
        )
        if not reply.get("ok"):
            raise RuntimeError(f"add_node failed: {reply}")
        node = ClusterNode(reply["node_id"], res)
        self._nodes.append(node)
        return node

    def remove_node(self, node: ClusterNode) -> None:
        global_client().request(
            {"type": "remove_node", "node_id": node.node_id}
        )
        if node in self._nodes:
            self._nodes.remove(node)

    def shutdown(self):
        ray_tpu_torch.shutdown()


def _pinned_pythonpath() -> str:
    """PYTHONPATH with this very package's root first: subprocesses
    (head_main, raylet) must resolve ray_tpu_torch even when the launching
    process runs from an unrelated cwd."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(
        ray_tpu_torch.__file__
    )))
    return os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH", "")) if p
    )


class SupervisedHead:
    """Standalone head process (``ray_tpu_torch._private.head_main``) under a
    tiny supervisor: when the head dies — SIGKILL'd by a chaos test or
    by a ``kill:gcs.*`` kill point inside it — it is relaunched on the
    SAME port and session dir, so the new head restores the persisted
    GCS tables and live drivers/raylets/workers reconnect to it
    (reference: the external supervisor keeping gcs_server alive that
    NotifyGCSRestart assumes).

    The head-failover chaos scenario drives this; tests use it to kill
    a live head out from under a connected driver.
    """

    def __init__(
        self,
        session_dir: str,
        port: Optional[int] = None,
        authkey: Optional[bytes] = None,
        num_cpus: float = 0.0,
        env: Optional[Dict[str, str]] = None,
    ):
        os.makedirs(session_dir, exist_ok=True)
        self.session_dir = session_dir
        # No port given: the first head binds one of the kernel's choice
        # and reports it ("head up: tcp=..."), and every restart takes
        # the same. A port picked here and bound later by the head could
        # be taken between the two by another process on a busy host.
        self.port = int(port or 0)
        self.authkey = authkey or secrets.token_bytes(16)
        self.num_cpus = num_cpus
        self._env = dict(env or {})
        self._lock = threading.Lock()
        self._stopping = False
        self._gen = 0
        self._env.setdefault("PYTHONPATH", _pinned_pythonpath())
        #: Completed restart count (a kill that came back).
        self.restarts = 0
        self.proc: Optional[subprocess.Popen] = None
        self._start_head()
        self._watcher = threading.Thread(
            target=self._watch, name="head-supervisor", daemon=True
        )
        self._watcher.start()

    @property
    def tcp_address(self) -> str:
        return f"127.0.0.1:{self.port}"

    @property
    def address(self) -> str:
        """``ray_tpu_torch.init(address=...)`` form (host:port?authkey)."""
        return f"{self.tcp_address}?{self.authkey.hex()}"

    def _start_head(self) -> None:
        self._gen += 1
        log_path = os.path.join(self.session_dir, f"head-{self._gen}.err")
        with open(log_path, "wb") as log:
            proc = subprocess.Popen(
                [
                    sys.executable, "-m", "ray_tpu_torch._private.head_main",
                    "--session-dir", self.session_dir,
                    "--tcp-port", str(self.port),
                    "--authkey", self.authkey.hex(),
                    "--num-cpus", str(self.num_cpus),
                ],
                env={**os.environ, **self._env},
                stdout=subprocess.DEVNULL,
                stderr=log,
            )
        deadline = time.time() + 30
        while time.time() < deadline:
            if proc.poll() is not None:
                with open(log_path, "rb") as f:
                    tail = f.read()[-2000:].decode(errors="replace")
                raise RuntimeError(f"head exited during startup: {tail}")
            try:
                with open(log_path, "rb") as f:
                    up = re.search(rb"head up: tcp=\S+:(\d+)", f.read())
                if up:
                    self.port = self.port or int(up.group(1))
                    break
            except OSError:
                pass
            time.sleep(0.05)
        else:
            proc.kill()
            raise TimeoutError("head did not come up within 30s")
        self.proc = proc

    def _watch(self) -> None:
        while True:
            proc = self.proc
            if proc is None:
                return
            proc.wait()
            with self._lock:
                if self._stopping:
                    return
            # Relaunch on the same address/session: persisted tables
            # restore; everyone reconnects. A port still draining from
            # the old process retries briefly — on the one retry
            # policy (chaos.Backoff: jittered, capped), not a fixed
            # sleep (raylint fixed-sleep-retry).
            from ._private.chaos import Backoff

            bo = Backoff(base_s=0.5, cap_s=4.0)
            for attempt in range(5):
                try:
                    self._start_head()
                    break
                except (RuntimeError, TimeoutError, OSError):
                    if attempt == 4:
                        return  # supervisor gives up: head stays dead
                    bo.sleep()
            with self._lock:
                if self._stopping:
                    return
                self.restarts += 1

    def kill(self) -> None:
        """SIGKILL the current head (the supervisor restarts it)."""
        proc = self.proc
        if proc is not None:
            try:
                proc.kill()
            except OSError:
                pass

    def wait_restarted(self, n: int, timeout: float = 60.0) -> bool:
        """Block until at least ``n`` restarts completed."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if self.restarts >= n:
                    return True
            time.sleep(0.1)
        return False

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
        proc = self.proc
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


class DaemonCluster:
    """Head + real node-daemon subprocesses over the TCP control plane."""

    def __init__(self, head_node_args: Optional[dict] = None):
        args = dict(head_node_args or {"num_cpus": 1})
        args.setdefault("tcp_port", 0)
        ray_tpu_torch.init(**args, ignore_reinit_error=True)
        from ._private.worker import _global

        if _global.node is None or not _global.node.tcp_address:
            raise RuntimeError(
                "DaemonCluster needs a fresh TCP-enabled head; an existing "
                "session without tcp_port is already initialized — "
                "shutdown() first"
            )
        self.head_address = _global.node.tcp_address
        self.authkey = _global.node.authkey
        self._daemons: List[subprocess.Popen] = []

    @classmethod
    def attach(
        cls,
        head_address: Optional[str] = None,
        authkey: Optional[bytes] = None,
    ) -> "DaemonCluster":
        """Attach to the ALREADY-initialized TCP-enabled head instead of
        starting one (``__init__`` refuses a live session). Daemons
        added through the attached handle are owned by it — callers
        shut them down via ``kill_node``, not ``shutdown`` (the session
        belongs to whoever initialized it).

        Pass ``head_address``/``authkey`` explicitly to attach to an
        EXTERNAL head (e.g. a ``SupervisedHead``) this process joined
        via ``init(address=...)`` — there is no in-process node then."""
        if head_address is not None and authkey is not None:
            self = cls.__new__(cls)
            self.head_address = head_address
            self.authkey = authkey
            self._daemons = []
            return self
        from ._private.worker import _global

        if _global.node is None or not _global.node.tcp_address:
            raise RuntimeError(
                "DaemonCluster.attach needs an initialized TCP-enabled "
                "head (init(tcp_port=...))"
            )
        self = cls.__new__(cls)
        self.head_address = _global.node.tcp_address
        self.authkey = _global.node.authkey
        self._daemons = []
        return self

    def add_node(
        self,
        *,
        num_cpus: float = 1,
        num_gpus: int = 0,
        resources: Optional[Dict[str, float]] = None,
        label: str = "",
        wait: bool = True,
        env: Optional[Dict[str, str]] = None,
    ) -> subprocess.Popen:
        """A node daemon of ``num_cpus`` CPUs and ``num_gpus`` GPUs (the
        reference's ``num_tpus``) plus ``resources``. ``env`` overlays
        the daemon's environment — chaos tests use it to install a
        per-node fault schedule (e.g. a partition spec that only the
        victim raylet and its workers enforce)."""
        import json

        before = len(ray_tpu_torch.nodes())
        env = {
            **os.environ,
            "PYTHONPATH": _pinned_pythonpath(),
            **(env or {}),
        }
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "ray_tpu_torch._private.raylet",
                "--address",
                self.head_address,
                "--authkey",
                self.authkey.hex(),
                "--num-cpus",
                str(float(num_cpus)),
                "--num-gpus",
                str(int(num_gpus)),
                "--resources",
                json.dumps(resources or {}),
                "--label",
                label,
                "--transfer-host",
                "127.0.0.1",
            ],
            env=env,
            stderr=subprocess.PIPE,
            stdout=subprocess.PIPE,
        )
        self._daemons.append(proc)
        if wait:
            deadline = time.time() + 30
            while time.time() < deadline:
                if len(ray_tpu_torch.nodes()) > before:
                    return proc
                if proc.poll() is not None:
                    _, err = proc.communicate()
                    raise RuntimeError(
                        f"node daemon exited: {err.decode(errors='replace')}"
                    )
                time.sleep(0.05)
            raise TimeoutError("node daemon did not register within 30s")
        return proc

    def kill_node(self, proc: subprocess.Popen, graceful: bool = False):
        proc.terminate() if graceful else proc.kill()
        proc.wait(timeout=10)
        if proc in self._daemons:
            self._daemons.remove(proc)

    def shutdown(self):
        ray_tpu_torch.shutdown()
        deadline = time.time() + 5
        for proc in self._daemons:
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self._daemons.clear()
