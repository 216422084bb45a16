"""Model multiplexing: many models per replica with LRU residency.

Reference: python/ray/serve/multiplex.py (_ModelMultiplexWrapper) +
api.py multiplexed:635 / get_multiplexed_model_id:773. The router
prefers replicas that already host the requested model id
(pow_2_scheduler multiplex ranking); the replica loads on miss and
evicts least-recently-used models beyond ``max_num_models_per_replica``.
"""
from __future__ import annotations

import asyncio
import functools
import inspect
from collections import OrderedDict
from typing import Callable, Optional


class _ModelMultiplexWrapper:
    def __init__(self, load_fn, self_arg, max_num_models: int):
        self._load_fn = load_fn
        self._self_arg = self_arg
        self._max = max_num_models
        self._models: "OrderedDict[str, object]" = OrderedDict()
        self._locks = {}

    async def load(self, model_id: str):
        if model_id in self._models:
            self._models.move_to_end(model_id)
            return self._models[model_id]
        lock = self._locks.setdefault(model_id, asyncio.Lock())
        async with lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
            while len(self._models) >= self._max and self._models:
                old_id, old = self._models.popitem(last=False)
                if hasattr(old, "__del__"):
                    try:
                        old.__del__()
                    except Exception:  # noqa: BLE001
                        pass
            if self._self_arg is not None:
                result = self._load_fn(self._self_arg, model_id)
            else:
                result = self._load_fn(model_id)
            if inspect.isawaitable(result):
                result = await result
            self._models[model_id] = result
            self._push_model_ids()
            return result

    def model_ids(self):
        return list(self._models)

    def _push_model_ids(self):
        """Tell the controller which models live here so routers can
        rank replicas by residency."""
        try:
            from .. import get_actor
            from ._private.common import CONTROLLER_NAME
            from ._private.replica import get_replica_context

            ctx = get_replica_context()
            dep_id_str = f"{ctx.app_name}#{ctx.deployment}"
            get_actor(CONTROLLER_NAME).record_multiplexed_model_ids.remote(
                dep_id_str, ctx.replica_id, tuple(self._models)
            )
        except Exception:  # noqa: BLE001 - outside a replica (unit tests)
            pass


def multiplexed(
    _func: Optional[Callable] = None, *, max_num_models_per_replica: int = 3
):
    """Decorate a model-loading function/method; call it with a model id
    to get the (cached) model."""

    def wrap(func):
        params = list(inspect.signature(func).parameters)
        is_method = bool(params) and params[0] == "self"
        wrappers = {}

        if is_method:

            @functools.wraps(func)
            async def method_wrapper(self, model_id: str):
                w = wrappers.get(id(self))
                if w is None:
                    w = _ModelMultiplexWrapper(
                        func, self, max_num_models_per_replica
                    )
                    wrappers[id(self)] = w
                    _register_wrapper(self, w)
                return await w.load(model_id)

            return method_wrapper

        w = _ModelMultiplexWrapper(func, None, max_num_models_per_replica)

        @functools.wraps(func)
        async def func_wrapper(model_id: str):
            return await w.load(model_id)

        func_wrapper.__serve_multiplex_wrapper__ = w
        return func_wrapper

    if _func is not None:
        return wrap(_func)
    return wrap


def _register_wrapper(instance, wrapper):
    if not hasattr(instance, "__serve_multiplex_wrappers__"):
        try:
            instance.__serve_multiplex_wrappers__ = []
        except Exception:  # noqa: BLE001
            return
    instance.__serve_multiplex_wrappers__.append(wrapper)


def get_loaded_model_ids(callable_obj) -> list:
    out = []
    for w in getattr(callable_obj, "__serve_multiplex_wrappers__", []):
        out.extend(w.model_ids())
    return out


def get_multiplexed_model_id() -> str:
    """Inside a replica handling a request: the model id the caller
    asked for via handle.options(multiplexed_model_id=...)."""
    from ._private.replica import get_replica_context

    try:
        return get_replica_context().multiplexed_model_id
    except RuntimeError:
        return ""
