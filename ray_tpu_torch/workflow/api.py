"""Workflow execution (reference: python/ray/workflow/api.py:123 run /
:177 run_async, workflow_executor.py, workflow_state_from_dag.py).

Each DAG node becomes a durable task: its result is persisted before
the workflow advances, keyed by a deterministic task id (topological
position + function name), so ``resume`` replays only what's missing.
"""
from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ..dag import DAGNode, FunctionNode, InputNode
from .storage import WorkflowStorage

_storage: Optional[WorkflowStorage] = None
_lock = threading.Lock()


def init(storage_dir: Optional[str] = None) -> None:
    """Point workflow persistence at a directory (default
    ~/.ray_tpu_torch/workflows or $RAY_TPU_TORCH_WORKFLOW_STORAGE)."""
    global _storage
    with _lock:
        _storage = WorkflowStorage(storage_dir)


def _get_storage() -> WorkflowStorage:
    global _storage
    with _lock:
        if _storage is None:
            _storage = WorkflowStorage()
        return _storage


def _task_ids(dag: DAGNode) -> Dict[int, str]:
    """Deterministic per-node ids: topo position + name (reference:
    workflow_state_from_dag.py naming)."""
    ids = {}
    for i, node in enumerate(dag.topological_order()):
        if isinstance(node, InputNode):
            ids[id(node)] = f"{i}_input"
        elif isinstance(node, FunctionNode):
            ids[id(node)] = f"{i}_{node.fn_name}"
        else:
            ids[id(node)] = f"{i}_node"
    return ids


def _execute_durable(dag: DAGNode, workflow_id: str, storage: WorkflowStorage):
    ids = _task_ids(dag)
    if any(
        isinstance(n, InputNode) for n in dag.topological_order()
    ):
        raise ValueError(
            "workflow DAGs must be fully bound (no InputNode): "
            "workflow.run takes no runtime input"
        )
    cache: Dict[int, Any] = {}
    pending: List = []  # (task_id, node_key, ref) in topo order
    storage.save_status(workflow_id, "RUNNING")
    try:
        # Submit everything eagerly (refs as inputs → parallel branches
        # actually run in parallel); completed tasks short-circuit to
        # their stored values.
        for node in dag.topological_order():
            tid = ids[id(node)]
            if storage.has_task_result(workflow_id, tid):
                cache[id(node)] = storage.load_task_result(workflow_id, tid)
                continue
            ref_or_val = node._execute_node(cache, (), {})
            cache[id(node)] = ref_or_val
            pending.append((tid, id(node), ref_or_val))
        # Persist results as they materialize (topo order guarantees a
        # resume never sees a child persisted before its parents).
        for tid, key, ref in pending:
            value = (
                ray_tpu_torch.get(ref) if isinstance(ref, ray_tpu_torch.ObjectRef) else ref
            )
            storage.save_task_result(workflow_id, tid, value)
            cache[key] = value
        result = cache[id(dag)]
        storage.save_status(workflow_id, "SUCCESSFUL")
        return result
    except Exception as e:
        storage.save_status(workflow_id, "FAILED", {"error": repr(e)})
        raise


def run(dag: DAGNode, *, workflow_id: Optional[str] = None) -> Any:
    """Execute a DAG durably; blocks for the result."""
    storage = _get_storage()
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:8]}"
    storage.save_dag(workflow_id, cloudpickle.dumps(dag))
    return _execute_durable(dag, workflow_id, storage)


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None):
    """Execute in a background thread; returns a concurrent Future."""
    import concurrent.futures

    storage = _get_storage()
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:8]}"
    storage.save_dag(workflow_id, cloudpickle.dumps(dag))
    fut: concurrent.futures.Future = concurrent.futures.Future()

    def runner():
        try:
            fut.set_result(_execute_durable(dag, workflow_id, storage))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    threading.Thread(target=runner, daemon=True).start()
    return fut


def resume(workflow_id: str) -> Any:
    """Re-run a stored workflow; completed tasks are skipped
    (exactly-once across driver crashes)."""
    storage = _get_storage()
    dag = cloudpickle.loads(storage.load_dag(workflow_id))
    return _execute_durable(dag, workflow_id, storage)


def get_status(workflow_id: str) -> Optional[str]:
    meta = _get_storage().load_status(workflow_id)
    return meta["status"] if meta else None


def get_output(workflow_id: str) -> Any:
    """Last task's stored output of a SUCCESSFUL workflow."""
    storage = _get_storage()
    dag = cloudpickle.loads(storage.load_dag(workflow_id))
    ids = _task_ids(dag)
    return storage.load_task_result(workflow_id, ids[id(dag)])


def list_all() -> List[Dict[str, Any]]:
    storage = _get_storage()
    out = []
    for wid in storage.list_workflows():
        meta = storage.load_status(wid) or {}
        out.append({"workflow_id": wid, "status": meta.get("status", "UNKNOWN")})
    return out


def cancel(workflow_id: str) -> None:
    _get_storage().save_status(workflow_id, "CANCELED")


def delete(workflow_id: str) -> None:
    _get_storage().delete_workflow(workflow_id)
