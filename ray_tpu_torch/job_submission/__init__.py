"""Job submission: run entrypoint commands on the cluster.

Reference: dashboard/modules/job/ (JobManager job_manager.py:56 spawns
a per-job JobSupervisor actor job_supervisor.py:49 that runs the
entrypoint as a subprocess) + python/ray/job_submission/ SDK. Same
shape here: a supervisor actor per job runs the shell entrypoint with
the session address exported, captures logs, and records status in the
GCS KV. As in upstream Ray, the supervisor (and so the entrypoint) runs
on the head node: an entrypoint is a driver, and a supervisor on an
autoscaled node would keep that node busy for as long as it lives.
"""
from __future__ import annotations

import enum
import json
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch

_NS = "__jobs__"


class JobStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    def is_terminal(self) -> bool:
        return self in (JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED)


class _JobSupervisor:
    """One actor per job (reference: job_supervisor.py:49)."""

    def __init__(self, job_id: str, entrypoint: str, env: Dict[str, str]):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.env = env
        self.proc = None

    def run(self) -> int:
        import os
        import subprocess

        from ray_tpu_torch._private.worker import global_client

        client = global_client()

        def set_status(status: str, **extra):
            client.kv_put(
                f"status_{self.job_id}".encode(),
                json.dumps(
                    {"status": status, "ts": time.time(), **extra}
                ).encode(),
                ns=_NS,
            )

        env = dict(os.environ)
        env.update(self.env)
        set_status(JobStatus.RUNNING)
        self.proc = subprocess.Popen(
            self.entrypoint,
            shell=True,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        lines: List[str] = []
        for line in self.proc.stdout:
            lines.append(line)
            if len(lines) % 50 == 0:
                client.kv_put(
                    f"logs_{self.job_id}".encode(),
                    "".join(lines).encode(),
                    ns=_NS,
                )
        rc = self.proc.wait()
        client.kv_put(
            f"logs_{self.job_id}".encode(), "".join(lines).encode(), ns=_NS
        )
        set_status(
            JobStatus.SUCCEEDED if rc == 0 else JobStatus.FAILED,
            returncode=rc,
        )
        return rc

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()


class JobSubmissionClient:
    """Reference: python/ray/job_submission/JobSubmissionClient (REST
    there; direct actor submission here)."""

    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address or "auto")
        from ray_tpu_torch._private.worker import global_client

        self._client = global_client()

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[Dict[str, Any]] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        env = dict((runtime_env or {}).get("env_vars", {}))
        self._client.kv_put(
            f"status_{job_id}".encode(),
            json.dumps(
                {
                    "status": JobStatus.PENDING,
                    "ts": time.time(),
                    "entrypoint": entrypoint,
                    "metadata": metadata or {},
                }
            ).encode(),
            ns=_NS,
        )
        from ray_tpu_torch._private.worker import head_node_id
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        supervisor = (
            ray_tpu_torch.remote(_JobSupervisor)
            # max_concurrency=2: stop() must be able to run while run()
            # is blocked streaming the subprocess.
            .options(
                name=f"_job_supervisor_{job_id}", num_cpus=0,
                max_concurrency=2,
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=head_node_id(), soft=False
                ),
            )
            .remote(job_id, entrypoint, env)
        )
        supervisor.run.remote()
        return job_id

    def get_job_status(self, job_id: str) -> JobStatus:
        return JobStatus(self._get_info(job_id)["status"])

    def _get_info(self, job_id: str) -> Dict[str, Any]:
        blob = self._client.kv_get(f"status_{job_id}".encode(), ns=_NS)
        if blob is None:
            raise ValueError(f"No such job {job_id!r}")
        return json.loads(blob)

    def get_job_info(self, job_id: str) -> Dict[str, Any]:
        return self._get_info(job_id)

    def get_job_logs(self, job_id: str) -> str:
        blob = self._client.kv_get(f"logs_{job_id}".encode(), ns=_NS)
        return blob.decode() if blob else ""

    def stop_job(self, job_id: str) -> bool:
        try:
            sup = ray_tpu_torch.get_actor(f"_job_supervisor_{job_id}")
        except ValueError:
            return False
        ray_tpu_torch.get(sup.stop.remote())
        # Don't clobber an outcome that already landed.
        if not self.get_job_status(job_id).is_terminal():
            self._client.kv_put(
                f"status_{job_id}".encode(),
                json.dumps(
                    {"status": JobStatus.STOPPED, "ts": time.time()}
                ).encode(),
                ns=_NS,
            )
        return True

    def list_jobs(self) -> List[Dict[str, Any]]:
        out = []
        for key in self._client.kv_keys(b"status_", ns=_NS):
            info = json.loads(self._client.kv_get(key, ns=_NS))
            info["job_id"] = key.decode()[len("status_"):]
            out.append(info)
        return sorted(out, key=lambda i: i.get("ts", 0))

    def wait_until_finish(self, job_id: str, timeout_s: float = 300.0) -> JobStatus:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            status = self.get_job_status(job_id)
            if status.is_terminal():
                return status
            time.sleep(0.2)
        raise TimeoutError(f"job {job_id} not finished in {timeout_s}s")
