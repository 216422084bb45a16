"""Workflow storage: task results + metadata on a filesystem.

Reference: python/ray/workflow/workflow_storage.py — results are
written atomically (tmp + rename) so a crash mid-write never yields a
corrupt "completed" marker.

The port's store is its own: ``~/.ray_tpu_torch/workflows``, or
``$RAY_TPU_TORCH_WORKFLOW_STORAGE``, so a resume never reads the
reference's results of the same workflow id. Results go through the
port's serializer, which stores a tensor as a host tensor of its dtype:
a resume on a host without a card loads it.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

from .._private import serialization

DEFAULT_STORAGE = os.path.join(
    os.path.expanduser("~"), ".ray_tpu_torch", "workflows"
)


class WorkflowStorage:
    def __init__(self, base: Optional[str] = None):
        self.base = base or os.environ.get(
            "RAY_TPU_TORCH_WORKFLOW_STORAGE", DEFAULT_STORAGE
        )
        os.makedirs(self.base, exist_ok=True)

    # ------------------------------------------------------------- paths
    def _wf_dir(self, workflow_id: str) -> str:
        return os.path.join(self.base, workflow_id)

    def _task_result_path(self, workflow_id: str, task_id: str) -> str:
        return os.path.join(self._wf_dir(workflow_id), "tasks", f"{task_id}.pkl")

    def _status_path(self, workflow_id: str) -> str:
        return os.path.join(self._wf_dir(workflow_id), "status.json")

    # ----------------------------------------------------------- results
    def _atomic_write(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def save_task_result(self, workflow_id: str, task_id: str, value: Any) -> None:
        self._atomic_write(
            self._task_result_path(workflow_id, task_id),
            serialization.pack(value),
        )

    def has_task_result(self, workflow_id: str, task_id: str) -> bool:
        return os.path.exists(self._task_result_path(workflow_id, task_id))

    def load_task_result(self, workflow_id: str, task_id: str) -> Any:
        with open(self._task_result_path(workflow_id, task_id), "rb") as f:
            # A bytearray, so numpy results come back writable.
            return serialization.unpack(bytearray(f.read()))

    # ------------------------------------------------------------ status
    def save_status(self, workflow_id: str, status: str,
                    extra: Optional[Dict[str, Any]] = None) -> None:
        payload = {"status": status, "updated_at": time.time(), **(extra or {})}
        self._atomic_write(
            self._status_path(workflow_id),
            json.dumps(payload).encode(),
        )

    def load_status(self, workflow_id: str) -> Optional[Dict[str, Any]]:
        try:
            with open(self._status_path(workflow_id)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def save_dag(self, workflow_id: str, dag_blob: bytes) -> None:
        self._atomic_write(
            os.path.join(self._wf_dir(workflow_id), "dag.pkl"), dag_blob
        )

    def load_dag(self, workflow_id: str) -> bytes:
        with open(os.path.join(self._wf_dir(workflow_id), "dag.pkl"), "rb") as f:
            return f.read()

    # -------------------------------------------------------------- list
    def list_workflows(self) -> List[str]:
        try:
            return sorted(
                d
                for d in os.listdir(self.base)
                if os.path.isdir(os.path.join(self.base, d))
            )
        except FileNotFoundError:
            return []

    def delete_workflow(self, workflow_id: str) -> None:
        import shutil

        shutil.rmtree(self._wf_dir(workflow_id), ignore_errors=True)
