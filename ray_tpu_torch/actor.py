"""Actor classes and handles.

Reference: python/ray/actor.py — ActorClass._remote :854 (creation) and
ActorMethod._remote :278 (method calls). Creation is centrally scheduled
through the control plane (the reference's GcsActorManager/-Scheduler);
method calls route to the actor's pinned worker in submission order.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Union

from ._private import submit as _submit
from ._private.ids import ActorID, PlacementGroupID, TaskID
from ._private.task_spec import TaskSpec
from ._private.worker import global_client
from .object_ref import ObjectRef

def _maybe_trace(runtime_env, name):
    from .util import tracing

    return tracing.inject(runtime_env, name)


_VALID_ACTOR_OPTIONS = {
    "num_cpus",
    "num_gpus",
    "num_tpus",
    "resources",
    "name",
    "lifetime",
    "max_restarts",
    "max_task_retries",
    "max_concurrency",
    "concurrency_groups",
    "get_if_exists",
    "scheduling_strategy",
    "placement_group",
    "placement_group_bundle_index",
    "runtime_env",
}


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1,
                 concurrency_group: Optional[str] = None):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def options(self, *, num_returns: Optional[int] = None,
                name: Optional[str] = None,
                concurrency_group: Optional[str] = None):
        return ActorMethod(
            self._handle, self._method_name,
            num_returns or self._num_returns,
            concurrency_group or self._concurrency_group,
        )

    def bind(self, *args, **kwargs):
        """Lazy actor-method call node for DAGs / compiled graphs."""
        from .dag import ClassMethodNode

        return ClassMethodNode(self, args, kwargs)

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        client = global_client()
        args_blob, deps, borrowed = _submit.prepare_args(args, kwargs)
        if borrowed:
            # Actor-method deps never gate dispatch (the pinned worker
            # resolves args itself), so nested refs can ride the same
            # pin path as top-level ones: client-side pinning on the
            # direct route, head-side task_pins + pin→borrow conversion
            # on the GCS route.
            deps = deps + borrowed
        if self._num_returns in ("streaming", "dynamic"):
            # Streaming actor method: GCS-routed so the pinned worker's
            # stream_item reports and ordered dispatch share a channel.
            return _submit.submit_streaming(
                client, self._method_name, self._handle._class_function_id,
                None, args_blob, deps, {},
                actor_id=self._handle._actor_id,
                method_name=self._method_name,
            )
        # Steady state: compact frame straight down the established
        # direct connection — no TaskSpec, no GCS hop (reference: actor
        # calls go gRPC straight to the actor process). Frames carry a
        # per-call concurrency-group override; class-declared groups
        # resolve worker-side.
        refs = client.call_actor_fast(
            self._handle._actor_id.binary(),
            self._method_name,
            args_blob,
            self._num_returns,
            deps,
            self._concurrency_group,
        )
        if refs is None:
            spec = TaskSpec(
                task_id=TaskID.from_random(),
                name=f"{self._method_name}",
                function_id=self._handle._class_function_id,
                function_blob=None,
                args_blob=args_blob,
                dependencies=deps,
                num_returns=self._num_returns,
                resources={},
                actor_id=self._handle._actor_id,
                method_name=self._method_name,
                concurrency_group=self._concurrency_group,
            )
            # Route resolution / buffering path; None means route via
            # the GCS (restartable actors, actor pending, remote node).
            refs = client.submit_actor_direct(spec)
            if refs is None:
                refs = client.submit(spec)
        return refs[0] if self._num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; "
            f"use .remote()."
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_function_id: bytes = b"\x00" * 16):
        self._actor_id = actor_id
        self._class_function_id = class_function_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name == "__ray_apply__":
            # Framework-internal: apply a shipped function to the actor
            # instance (compiled-graph loops) — see worker_main.
            return ActorMethod(self, "__ray_apply__")
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __ray_terminate__(self):  # pragma: no cover - attribute shadow helper
        raise TypeError("use handle.__ray_terminate__.remote()")

    @property
    def __ray_terminate_method__(self) -> ActorMethod:
        return ActorMethod(self, "__ray_terminate__")

    def terminate(self) -> ObjectRef:
        """Graceful exit: queued behind pending method calls."""
        return ActorMethod(self, "__ray_terminate__").remote()

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_function_id))


class ActorClass:
    def __init__(self, cls: type, **default_options):
        bad = set(default_options) - _VALID_ACTOR_OPTIONS
        if bad:
            raise ValueError(f"Invalid actor options: {sorted(bad)}")
        self._cls = cls
        self._default_options = default_options
        self._blob: Optional[bytes] = None
        self._function_id: Optional[bytes] = None
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()."
        )

    def options(self, **options) -> "ActorClass":
        merged = _submit.resolve_options(self._default_options, options)
        clone = ActorClass(self._cls, **merged)
        clone._blob = self._blob
        clone._function_id = self._function_id
        return clone

    def _ensure_pickled(self):
        if self._blob is None:
            self._blob = _submit.pickle_by_value(self._cls)
            self._function_id = _submit.function_id_for(self._blob)

    def remote(self, *args, **kwargs) -> ActorHandle:
        client = global_client()
        self._ensure_pickled()
        opts = self._default_options
        name = opts.get("name")
        actor_id = ActorID.from_random()
        if name:
            # Atomic name reservation in the GCS (get-or-create).
            reply = client.request(
                {
                    "type": "reserve_actor_name",
                    "name": name,
                    "actor_id": actor_id.binary(),
                }
            )
            if not reply.get("created"):
                if opts.get("get_if_exists"):
                    return ActorHandle(ActorID(reply["actor_id"]), self._function_id)
                raise ValueError(f"Actor name '{name}' is already taken")
        try:
            args_blob, deps, borrowed = _submit.prepare_args(args, kwargs)
        except BaseException:
            if name:
                client.send(
                    {
                        "type": "release_actor_name",
                        "name": name,
                        "actor_id": actor_id.binary(),
                    }
                )
            raise
        pg = opts.get("placement_group")
        bundle_index = opts.get("placement_group_bundle_index", -1)
        strategy = opts.get("scheduling_strategy")
        if strategy is not None and hasattr(strategy, "placement_group"):
            pg = strategy.placement_group
            bundle_index = strategy.placement_group_bundle_index
        pg_id: Optional[PlacementGroupID] = None
        if pg is not None:
            pg_id = pg.id if hasattr(pg, "id") else pg
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            name=f"{self._cls.__name__}.__init__",
            function_id=self._function_id,
            function_blob=client.register_function_once(self._function_id, self._blob),
            args_blob=args_blob,
            dependencies=deps,
            borrowed_refs=borrowed,
            num_returns=1,
            resources=_submit.resources_from_options(opts, is_actor=True),
            actor_creation=True,
            actor_id=actor_id,
            max_restarts=opts.get("max_restarts", 0) or 0,
            max_concurrency=opts.get("max_concurrency", 1) or 1,
            concurrency_groups=opts.get("concurrency_groups"),
            actor_name=name,
            lifetime=opts.get("lifetime"),
            placement_group_id=pg_id,
            placement_group_bundle_index=(
                bundle_index if bundle_index is not None else -1
            ),
            scheduling_strategy=_submit.normalize_strategy(strategy),
            runtime_env=_submit.prepare_runtime_env(
                _maybe_trace(
                    opts.get("runtime_env"), f"{self._cls.__name__}.__init__"
                ),
                client,
            ),
        )
        client.submit(spec)
        return ActorHandle(actor_id, self._function_id)
