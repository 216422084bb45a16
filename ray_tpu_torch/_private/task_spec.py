"""Immutable task description (reference: src/ray/common/task/task_spec.h:247).

A TaskSpec fully describes one invocation: the function (by id, with the
cloudpickled blob shipped once and cached in the GCS function table —
reference: _private/function_manager.py), serialized args with the
ObjectRefs they depend on, resource demands, and actor/placement options.

The scheduling class (resource-shape equivalence class, reference
task_spec.h:75) is derived from the sorted resource dict and used for
fair dispatch queues.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ids import ActorID, ObjectID, PlacementGroupID, TaskID


@dataclass
class TaskSpec:
    task_id: TaskID
    name: str
    function_id: bytes
    # cloudpickle blob of the function / actor class; None when the GCS
    # function table already has it (keyed by function_id).
    function_blob: Optional[bytes]
    # cloudpickle blob of (args, kwargs); ObjectRefs inside are pickled
    # as refs and resolved (top-level only) by the executing worker.
    args_blob: bytes
    # ObjectIDs this task's top-level args depend on; the scheduler holds
    # the task until all are ready.
    dependencies: List[ObjectID] = field(default_factory=list)
    # Refs NESTED inside arg values (captured at serialization). Never
    # gate scheduling, but the head pins them for the task's lifetime —
    # and converts the pin to a borrow edge when the worker retains the
    # ref — exactly like dependencies (reference: borrowed refs ride
    # serialization capture, reference_count.h:61).
    borrowed_refs: List[ObjectID] = field(default_factory=list)
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    # Actor protocol: creation task pins its worker; method tasks route to
    # that worker in order.
    actor_creation: bool = False
    actor_id: Optional[ActorID] = None
    method_name: str = ""
    max_restarts: int = 0
    max_retries: int = 0
    retry_exceptions: bool = False
    max_concurrency: int = 1
    # Placement.
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    scheduling_strategy: Any = None
    # Named / detached actors.
    actor_name: Optional[str] = None
    lifetime: Optional[str] = None
    runtime_env: Optional[Dict[str, Any]] = None
    # Concurrency groups (reference: concurrency_group_manager.h):
    # creation carries {group: limit}; a method call may pin itself to a
    # group (class-declared defaults resolve worker-side).
    concurrency_groups: Optional[Dict[str, int]] = None
    concurrency_group: Optional[str] = None

    def scheduling_class(self) -> Tuple[Tuple[str, float], ...]:
        return tuple(sorted(self.resources.items()))

    def __reduce__(self):
        # Positional tuple wire format: specs are pickled once per call on
        # the submission hot path, and the default dataclass pickle ships
        # every field name as a string plus one reduce record per ID
        # object. This encoding is ~3x smaller and faster to round-trip.
        return (
            _rebuild_spec,
            (
                self.task_id._bytes,
                self.name,
                self.function_id,
                self.function_blob,
                self.args_blob,
                [d._bytes for d in self.dependencies],
                self.num_returns,
                self.resources,
                self.actor_creation,
                self.actor_id._bytes if self.actor_id is not None else None,
                self.method_name,
                self.max_restarts,
                self.max_retries,
                self.retry_exceptions,
                self.max_concurrency,
                (
                    self.placement_group_id._bytes
                    if self.placement_group_id is not None
                    else None
                ),
                self.placement_group_bundle_index,
                self.scheduling_strategy,
                self.actor_name,
                self.lifetime,
                self.runtime_env,
                self.concurrency_groups,
                self.concurrency_group,
                [d._bytes for d in self.borrowed_refs],
            ),
        )

    def return_object_ids(self) -> List[ObjectID]:
        # Cached: recomputed on the submit hot path otherwise (deterministic
        # from task_id, so caching across pickling is safe).
        ids = getattr(self, "_return_ids", None)
        if ids is None:
            ids = [
                ObjectID.for_task_return(self.task_id, i)
                for i in range(self.num_returns)
            ]
            object.__setattr__(self, "_return_ids", ids)
        return ids


def _rebuild_spec(
    task_id,
    name,
    function_id,
    function_blob,
    args_blob,
    dependencies,
    num_returns,
    resources,
    actor_creation,
    actor_id,
    method_name,
    max_restarts,
    max_retries,
    retry_exceptions,
    max_concurrency,
    placement_group_id,
    placement_group_bundle_index,
    scheduling_strategy,
    actor_name,
    lifetime,
    runtime_env,
    concurrency_groups=None,
    concurrency_group=None,
    borrowed_refs=None,
) -> TaskSpec:
    return TaskSpec(
        task_id=TaskID(task_id),
        name=name,
        function_id=function_id,
        function_blob=function_blob,
        args_blob=args_blob,
        dependencies=[ObjectID(d) for d in dependencies],
        num_returns=num_returns,
        resources=resources,
        actor_creation=actor_creation,
        actor_id=ActorID(actor_id) if actor_id is not None else None,
        method_name=method_name,
        max_restarts=max_restarts,
        max_retries=max_retries,
        retry_exceptions=retry_exceptions,
        max_concurrency=max_concurrency,
        placement_group_id=(
            PlacementGroupID(placement_group_id)
            if placement_group_id is not None
            else None
        ),
        placement_group_bundle_index=placement_group_bundle_index,
        scheduling_strategy=scheduling_strategy,
        actor_name=actor_name,
        lifetime=lifetime,
        runtime_env=runtime_env,
        concurrency_groups=concurrency_groups,
        concurrency_group=concurrency_group,
        borrowed_refs=[ObjectID(d) for d in borrowed_refs or []],
    )
