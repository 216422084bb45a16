"""gRPC ingress proxy.

Reference: serve/_private/proxy.py:540 (gRPCProxy) — gRPC requests ride
the same route table + DeploymentHandle path as HTTP. Schema-free
transport: a generic handler accepts any ``/<app_name>/<method>`` (or
``/ray_tpu_torch.serve.Serve/Call`` with app/method in metadata) unary call
whose request bytes are a pickled ``(args, kwargs)`` tuple and whose
response bytes are the pickled return value — no protoc codegen needed
for either side (the reference's RayServeAPIService plays the same
role for its generic entrypoints).
"""
from __future__ import annotations

import pickle
from typing import Dict, Optional

from ..handle import DeploymentHandle
from .common import LongPollKey


class _GenericHandler:
    def __init__(self, proxy: "GrpcProxyActor"):
        self._proxy = proxy

    def service(self, handler_call_details):
        import grpc

        method = handler_call_details.method  # "/pkg.Service/Method"
        md = dict(handler_call_details.invocation_metadata or ())

        async def unary(request_bytes, context):
            return await self._proxy.handle_call(
                method, md, request_bytes, context
            )

        return grpc.unary_unary_rpc_method_handler(
            unary,
            request_deserializer=None,  # raw bytes in
            response_serializer=None,  # raw bytes out
        )


class GrpcProxyActor:
    """One per cluster (next to the HTTP proxy)."""

    def __init__(self, host: str, port: int):
        self._host = host
        self._port = port
        self._apps: Dict[str, dict] = {}  # app_name -> route info
        self._handles: Dict[str, DeploymentHandle] = {}
        self._long_poll = None
        self._server = None

    async def ready(self) -> str:
        if self._server is not None:
            return f"{self._host}:{self._port}"
        import grpc.aio

        from ... import get_actor
        from .common import CONTROLLER_NAME
        from .long_poll import LongPollClient

        self._long_poll = LongPollClient(
            get_actor(CONTROLLER_NAME),
            {LongPollKey.GRPC_APPS: self._update_routes},
        )
        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((_GenericHandler(self),))
        self._port = self._server.add_insecure_port(
            f"{self._host}:{self._port}"
        )
        await self._server.start()
        return f"{self._host}:{self._port}"

    def _update_routes(self, routes: Dict[str, dict]):
        apps = {}
        handles = {}
        for prefix, info in routes.items():
            apps[info["app_name"]] = info
            handles[info["app_name"]] = DeploymentHandle(
                info["ingress"], info["app_name"]
            )
        self._apps = apps
        self._handles = handles

    async def handle_call(self, method: str, metadata, request_bytes: bytes,
                          context):
        import grpc

        # Routing: "/<app>/<call_method>", or metadata
        # ("application", "call-method") with any method path.
        app = metadata.get("application")
        call_method = metadata.get("call-method", "__call__")
        if app is None:
            parts = [p for p in method.split("/") if p]
            if len(parts) == 2 and parts[0] in self._handles:
                app, call_method = parts
        if app is None or app not in self._handles:
            await context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"no serve application for rpc {method!r}",
            )
        try:
            args, kwargs = pickle.loads(request_bytes) if request_bytes else (
                (), {}
            )
        except Exception as e:  # noqa: BLE001
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"request is not a pickled (args, kwargs): {e}",
            )
        handle = self._handles[app]
        if call_method != "__call__":
            handle = handle.options(method_name=call_method)
        try:
            result = await handle.remote(*args, **kwargs)
        except Exception as e:  # noqa: BLE001
            await context.abort(
                grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
            )
        return pickle.dumps(result)

    async def shutdown(self):
        if self._long_poll:
            self._long_poll.stop()
        if self._server:
            await self._server.stop(grace=1.0)
