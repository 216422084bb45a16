"""Checkpoints: directory contract + torch.distributed.checkpoint
persistence of state dicts.

Reference: train/_checkpoint.py:56 (Checkpoint = directory + fs handle).
The reference saves pytrees of sharded jax arrays with orbax; here a
state dict (nested dicts of tensors, DTensors included) goes through
`torch.distributed.checkpoint`, where every rank writes the shards it
holds, keeping the report(metrics, checkpoint) contract.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import warnings
from typing import Any, Dict, Optional


class Checkpoint:
    """A directory of checkpoint data (reference: train.Checkpoint)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        return self.path

    def to_directory(self, dest: Optional[str] = None) -> str:
        dest = dest or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


def _fresh_dir(path: str) -> str:
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    return path


def save_pytree(path: str, tree: Dict[str, Any]) -> None:
    """Synchronous save of a state dict with `torch.distributed.checkpoint`
    (every rank of an initialised process group writes its own shards;
    without one, this process writes everything)."""
    import torch.distributed.checkpoint as dcp

    with _quiet():
        dcp.save(tree, checkpoint_id=_fresh_dir(path), no_dist=_no_dist())


def load_pytree(path: str, template: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    """Restore a state dict. With `template` (a state dict of the saved
    structure — the counterpart of the reference's abstract tree), the
    values load in place into its tensors, on their devices and
    shardings, and the template is returned. Without one, the tensors are
    rebuilt on the CPU from the checkpoint's metadata."""
    import torch
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    path = os.path.abspath(path)
    if template is not None:
        with _quiet():
            dcp.load(template, checkpoint_id=path, no_dist=_no_dist())
        return template
    meta = dcp.FileSystemReader(path).read_metadata()
    state: Dict[str, Any] = {}
    for key, item in meta.state_dict_metadata.items():
        value = None  # non-tensor values load from their pickled bytes
        if isinstance(item, TensorStorageMetadata):
            value = torch.empty(item.size, dtype=item.properties.dtype)
        _set_path(state, meta.planner_data[key], value)
    with _quiet():
        dcp.load(state, checkpoint_id=path, no_dist=True)
    return state


def _set_path(root: Any, path, value) -> None:
    """Put `value` at `path` (dcp's flattening map: dict keys and list
    indices) in the nested containers under `root`, growing them."""
    node = root
    for part, nxt in zip(path[:-1], path[1:]):
        empty = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            node.extend([None] * (part + 1 - len(node)))
            if node[part] is None:
                node[part] = empty
            node = node[part]
        else:
            node = node.setdefault(part, empty)
    if isinstance(node, list):
        node.extend([None] * (path[-1] + 1 - len(node)))
    node[path[-1]] = value


@contextlib.contextmanager
def _quiet():
    """dcp warns that it runs in one process whenever no process group is
    initialised, which is this module's intended single-process use."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="torch.distributed is disabled",
            category=UserWarning,
        )
        yield


def _no_dist() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized())


class AsyncCheckpointer:
    """Async save: each tensor is staged to host memory at save(); the
    files are written in a background thread
    (`torch.distributed.checkpoint.async_save`), so the card goes on
    training (reference: orbax AsyncCheckpointer)."""

    def __init__(self):
        self._future = None

    def save(self, path: str, tree: Dict[str, Any]) -> None:
        import torch.distributed.checkpoint as dcp

        self.wait()
        with _quiet():
            self._future = dcp.async_save(tree, checkpoint_id=_fresh_dir(path))

    def wait(self) -> None:
        if self._future is not None:
            self._future.result()
            self._future = None

    def close(self) -> None:
        self.wait()
