"""DeploymentHandle: the composition API for calling deployments.

Reference: python/ray/serve/handle.py (_DeploymentHandleBase:104,
DeploymentResponse:456). A handle embeds a Router (power-of-two-choices
over live replicas); ``handle.method.remote(*args)`` returns a
DeploymentResponse that can be awaited, resolved with ``.result()``, or
passed directly as an argument to another handle call (model
composition).
"""
from __future__ import annotations

import concurrent.futures
import uuid
from typing import Any, Optional

from ._private.common import DeploymentID, RequestMetadata


class DeploymentResponse:
    def __init__(self, future: "concurrent.futures.Future"):
        self._future = future

    def result(self, timeout_s: Optional[float] = None) -> Any:
        return self._future.result(timeout=timeout_s)

    def cancel(self):
        self._future.cancel()

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self._future).__await__()


class DeploymentResponseGenerator:
    """Iterator of streamed chunk VALUES from a stream=True handle call
    (reference: handle.py DeploymentResponseGenerator). The underlying
    async generator lives on the router's event loop (which owns
    replica choice, rejection retries, and in-flight accounting); sync
    and async iteration both bridge to it."""

    def __init__(self, agen, loop):
        self._agen = agen
        self._loop = loop

    def _pull(self) -> "concurrent.futures.Future":
        import asyncio

        async def nxt():
            try:
                return await self._agen.__anext__()
            except StopAsyncIteration:
                return _GEN_END

        return asyncio.run_coroutine_threadsafe(nxt(), self._loop)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._pull().result()
        if item is _GEN_END:
            raise StopIteration
        return item

    def __aiter__(self):
        return self

    async def __anext__(self):
        import asyncio

        item = await asyncio.wrap_future(self._pull())
        if item is _GEN_END:
            raise StopAsyncIteration
        return item


_GEN_END = object()


class _MethodProxy:
    def __init__(self, handle: "DeploymentHandle", method_name: str):
        self._handle = handle
        self._method = method_name

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle._remote(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(
        self,
        deployment_name: str,
        app_name: str = "default",
        *,
        method_name: str = "__call__",
        multiplexed_model_id: str = "",
        _is_http: bool = False,
        _stream: bool = False,
    ):
        self.deployment_id = DeploymentID(deployment_name, app_name)
        self._method_name = method_name
        self._multiplexed_model_id = multiplexed_model_id
        self._is_http = _is_http
        self._stream = _stream
        self._router = None

    # ------------------------------------------------------------ options
    def options(
        self,
        *,
        method_name: Optional[str] = None,
        multiplexed_model_id: Optional[str] = None,
        stream: Optional[bool] = None,
    ) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_id.name,
            self.deployment_id.app_name,
            method_name=method_name or self._method_name,
            multiplexed_model_id=(
                multiplexed_model_id
                if multiplexed_model_id is not None
                else self._multiplexed_model_id
            ),
            _is_http=self._is_http,
            _stream=self._stream if stream is None else stream,
        )

    def __getattr__(self, name: str) -> _MethodProxy:
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodProxy(self, name)

    # ------------------------------------------------------------- calls
    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._remote(self._method_name, args, kwargs)

    def _remote(self, method_name: str, args, kwargs):
        from ._private.router import get_or_create_router

        if self._router is None:
            self._router = get_or_create_router(self.deployment_id)
        meta = RequestMetadata(
            request_id=uuid.uuid4().hex,
            call_method=method_name,
            multiplexed_model_id=self._multiplexed_model_id,
            http_request=self._is_http,
        )
        if self._stream:
            agen, loop = self._router.assign_request_streaming(meta, args, kwargs)
            return DeploymentResponseGenerator(agen, loop)
        return DeploymentResponse(self._router.assign_request(meta, args, kwargs))

    def __repr__(self):
        return f"DeploymentHandle({self.deployment_id})"

    def __reduce__(self):
        return (
            _rebuild_handle,
            (
                self.deployment_id.name,
                self.deployment_id.app_name,
                self._method_name,
                self._multiplexed_model_id,
            ),
        )


def _rebuild_handle(name, app_name, method_name, multiplexed_model_id):
    return DeploymentHandle(
        name,
        app_name,
        method_name=method_name,
        multiplexed_model_id=multiplexed_model_id,
    )


