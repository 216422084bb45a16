"""@remote functions (reference: python/ray/remote_function.py —
RemoteFunction._remote :266)."""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Union

from ._private import submit as _submit
from ._private.ids import PlacementGroupID, TaskID, fast_unique_bytes
from ._private.task_spec import TaskSpec
from ._private.worker import global_client
from .object_ref import ObjectRef

_VALID_OPTIONS = {
    "num_cpus",
    "num_gpus",
    "num_tpus",
    "num_returns",
    "resources",
    "max_retries",
    "retry_exceptions",
    "name",
    "scheduling_strategy",
    "placement_group",
    "placement_group_bundle_index",
    "runtime_env",
}


def _maybe_trace(runtime_env, task_name):
    """Inject span context when RAY_TPU_TORCH_TRACE=1 (reference:
    tracing_helper.py _tracing_task_invocation)."""
    from .util import tracing

    return tracing.inject(runtime_env, task_name)


class RemoteFunction:
    def __init__(self, fn, **default_options):
        bad = set(default_options) - _VALID_OPTIONS
        if bad:
            raise ValueError(f"Invalid @remote options: {sorted(bad)}")
        self._fn = fn
        self._default_options = default_options
        self._blob: Optional[bytes] = None
        self._function_id: Optional[bytes] = None
        # Simple-options analysis, computed once: plain tasks (no
        # placement, no runtime_env, no retries-with-exceptions) take a
        # submit path that skips the per-call option plumbing.
        opts = default_options
        self._simple = not any(
            opts.get(k)
            for k in (
                "placement_group",
                "scheduling_strategy",
                "runtime_env",
                "name",
            )
        ) and (opts.get("placement_group_bundle_index") in (None, -1))
        self._resources = _submit.resources_from_options(opts)
        self._num_returns = opts.get("num_returns", 1) or 1
        # Reference default: tasks retry 3x on SYSTEM failure (worker
        # crash / node loss), never on application exceptions unless
        # retry_exceptions is set (ray_constants.DEFAULT_TASK_MAX_RETRIES).
        mr = opts.get("max_retries")
        self._max_retries = 3 if mr is None else mr
        self._retry_exceptions = bool(opts.get("retry_exceptions", False))
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._fn.__name__}' cannot be called directly; "
            f"use .remote()."
        )

    def options(self, **options) -> "RemoteFunction":
        merged = _submit.resolve_options(self._default_options, options)
        clone = RemoteFunction(self._fn, **merged)
        clone._blob = self._blob
        clone._function_id = self._function_id
        return clone

    def _ensure_pickled(self):
        if self._blob is None:
            self._blob = _submit.pickle_by_value(self._fn)
            self._function_id = _submit.function_id_for(self._blob)

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node instead of executing (reference:
        ray.dag — dag_node.py); run with ``.execute()`` or hand to
        ``workflow.run``."""
        from .dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        client = global_client()
        self._ensure_pickled()
        opts = self._default_options
        args_blob, deps, borrowed = _submit.prepare_args(args, kwargs)
        num_returns = self._num_returns
        if num_returns in ("streaming", "dynamic"):
            # Streaming generator: each yield seals as its own object,
            # reported incrementally; the caller iterates refs while the
            # task runs (reference: num_returns="streaming",
            # _raylet.pyx:1289). Routed via the GCS so stream_item
            # reports and scheduling share one ordered channel.
            return _submit.submit_streaming(
                client, self._fn.__name__, self._function_id,
                client.register_function_once(self._function_id, self._blob),
                args_blob, deps, _submit.resources_from_options(opts),
                borrowed=borrowed,
            )
        if self._simple:
            from .util import tracing

            if not tracing.enabled():
                spec = TaskSpec.__new__(TaskSpec)
                # Syscall-free id on the steady-state path; return
                # object ids derive from bytes [:12] which stay unique
                # (see ids.fast_unique_bytes).
                spec.task_id = TaskID(fast_unique_bytes())
                spec.name = self._fn.__name__
                spec.function_id = self._function_id
                spec.function_blob = client.register_function_once(
                    self._function_id, self._blob
                )
                spec.args_blob = args_blob
                spec.dependencies = deps
                spec.borrowed_refs = borrowed
                spec.num_returns = num_returns
                spec.resources = self._resources
                spec.actor_creation = False
                spec.actor_id = None
                spec.method_name = ""
                spec.max_restarts = 0
                spec.max_retries = self._max_retries
                spec.retry_exceptions = self._retry_exceptions
                spec.max_concurrency = 1
                spec.placement_group_id = None
                spec.placement_group_bundle_index = -1
                spec.scheduling_strategy = None
                spec.actor_name = None
                spec.lifetime = None
                spec.runtime_env = None
                spec.concurrency_groups = None
                spec.concurrency_group = None
                refs = client.submit_task_leased(spec)
                if refs is None:
                    refs = client.submit(spec)
                return refs[0] if num_returns == 1 else refs
        pg = opts.get("placement_group")
        pg_id: Optional[PlacementGroupID] = None
        bundle_index = opts.get("placement_group_bundle_index", -1)
        strategy = opts.get("scheduling_strategy")
        if strategy is not None and hasattr(strategy, "placement_group"):
            pg = strategy.placement_group
            bundle_index = strategy.placement_group_bundle_index
        if pg is not None:
            pg_id = pg.id if hasattr(pg, "id") else pg
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            name=opts.get("name") or self._fn.__name__,
            function_id=self._function_id,
            function_blob=client.register_function_once(self._function_id, self._blob),
            args_blob=args_blob,
            dependencies=deps,
            borrowed_refs=borrowed,
            num_returns=num_returns,
            resources=_submit.resources_from_options(opts),
            max_retries=(
                3
                if opts.get("max_retries") is None
                else opts["max_retries"]
            ),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            placement_group_id=pg_id,
            placement_group_bundle_index=(
                bundle_index if bundle_index is not None else -1
            ),
            scheduling_strategy=_submit.normalize_strategy(strategy),
            runtime_env=_submit.prepare_runtime_env(
                _maybe_trace(opts.get("runtime_env"),
                             opts.get("name") or self._fn.__name__),
                client,
            ),
        )
        # Leased direct transport for plain tasks (no deps/PG; a GPU
        # only from the local raylet, see _lease_eligible); falls
        # back to GCS-routed scheduling (reference: direct task submitter
        # vs GCS-scheduled tasks, direct_task_transport.cc:24).
        refs = client.submit_task_leased(spec)
        if refs is None:
            refs = client.submit(spec)
        return refs[0] if num_returns == 1 else refs
