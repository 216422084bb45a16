"""Shared task-submission helpers (driver + nested worker submission).

Reference: the submission half of the core worker —
CoreWorker::SubmitTask (core_worker.cc:2149) + the option validation in
_private/ray_option_utils.py:123.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from . import serialization
from .ids import ObjectID
from ..object_ref import ObjectRef


def function_id_for(blob: bytes) -> bytes:
    return hashlib.blake2b(blob, digest_size=16).digest()


_EMPTY_ARGS_BLOB = serialization.pack(((), {}))


def prepare_args(
    args: tuple, kwargs: dict
) -> Tuple[bytes, List[ObjectID], List[ObjectID]]:
    """Serialize call args. Returns (blob, deps, borrowed):

    - top-level ObjectRefs become task *dependencies* (resolved by the
      executing worker; gate scheduling for plain tasks);
    - refs NESTED inside arg values (a list of refs, a dataclass
      holding one) become *borrowed_refs*: they do not gate scheduling,
      but the head pins them for the task's lifetime and converts the
      pin to a borrow edge if the worker retains the ref past the call
      (reference: borrowed refs are tracked from serialization capture,
      reference_count.h:61). Without the pin there is an unprotected
      window — the caller's release can reach the head before the
      executing worker's batched badd, freeing an object the worker
      holds (found by the chaos soak as a wedged in-actor get)."""
    if not args and not kwargs:
        # No-arg calls dominate control-plane microbenchmarks; skip the
        # pickle round entirely.
        return _EMPTY_ARGS_BLOB, [], []
    deps: List[ObjectID] = []
    for a in args:
        if isinstance(a, ObjectRef):
            deps.append(a.id())
    for v in kwargs.values():
        if isinstance(v, ObjectRef):
            deps.append(v.id())
    from ..object_ref import _CaptureRefs

    with _CaptureRefs() as cap:
        blob = serialization.pack((list(args), dict(kwargs)))
    borrowed: List[ObjectID] = []
    if cap.seen:
        top = {d.binary() for d in deps}
        seen = set()
        for ob in cap.seen:
            if ob not in top and ob not in seen:
                seen.add(ob)
                borrowed.append(ObjectID(ob))
    return blob, deps, borrowed


def resolve_options(
    defaults: Dict[str, Any], overrides: Optional[Dict[str, Any]]
) -> Dict[str, Any]:
    opts = dict(defaults)
    if overrides:
        for k, v in overrides.items():
            if v is not None or k not in opts:
                opts[k] = v
    return opts


def normalize_strategy(strategy: Any) -> Any:
    """Ship-ready scheduling strategy: PG strategies are folded into the
    spec's placement fields by the caller (→ None here); "SPREAD" passes
    through; NodeAffinity gets its node_id coerced to raw bytes so the
    scheduler compares against NodeState keys directly."""
    if strategy is None or hasattr(strategy, "placement_group"):
        return None
    if isinstance(strategy, str):
        return None if strategy == "DEFAULT" else strategy
    node_id = getattr(strategy, "node_id", None)
    if node_id is not None and not isinstance(node_id, bytes):
        # Coerce on a copy — the caller may reuse (or share) the
        # strategy object across submissions.
        import copy

        strategy = copy.copy(strategy)
        if hasattr(node_id, "binary"):
            strategy.node_id = node_id.binary()
        elif isinstance(node_id, str):
            strategy.node_id = bytes.fromhex(node_id)
    return strategy


def resources_from_options(opts: Dict[str, Any], is_actor: bool = False) -> Dict[str, float]:
    """Tasks default to 1 CPU; actors default to 0 for their lifetime
    (reference: ray_option_utils.py — num_cpus default 1 for tasks,
    0 for actors so many idle actors don't hold cores)."""
    res: Dict[str, float] = {}
    num_cpus = opts.get("num_cpus")
    if num_cpus is None:
        num_cpus = 0 if is_actor else 1
    if num_cpus:
        res["CPU"] = float(num_cpus)
    num_tpus = opts.get("num_tpus")
    if num_tpus:
        res["TPU"] = float(num_tpus)
    num_gpus = opts.get("num_gpus")
    if num_gpus:
        res["GPU"] = float(num_gpus)
    extra = opts.get("resources")
    if extra:
        res.update({k: float(v) for k, v in extra.items()})
    return res


def pickle_by_value(obj: Any) -> bytes:
    return cloudpickle.dumps(obj)


def submit_streaming(client, name, function_id, function_blob, args_blob,
                     deps, resources, actor_id=None, method_name="",
                     borrowed=None):
    """Submit a streaming-generator task (num_returns = -1 sentinel on
    the wire) via the GCS route; returns an ObjectRefGenerator."""
    from .ids import TaskID
    from .task_spec import TaskSpec
    from ..object_ref import ObjectRefGenerator

    spec = TaskSpec(
        task_id=TaskID.from_random(),
        name=name,
        function_id=function_id,
        function_blob=function_blob,
        args_blob=args_blob,
        dependencies=deps,
        num_returns=-1,
        resources=resources,
        actor_id=actor_id,
        method_name=method_name,
        borrowed_refs=borrowed or [],
    )
    client.submit(spec)
    return ObjectRefGenerator(
        spec.task_id.binary(), client, client.worker_id.binary()
    )


def prepare_runtime_env(runtime_env, client):
    """Validate + package a runtime_env at submission time (local dirs
    become content-addressed KV URIs; see runtime_env.package)."""
    if not runtime_env:
        return None
    from . import runtime_env as _re

    return _re.package(runtime_env, client)
