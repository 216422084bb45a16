"""HTTP proxy actor.

Reference: serve/_private/proxy.py (ProxyActor:1130, HTTPProxy:761 —
uvicorn/starlette there; aiohttp here). The proxy keeps a route table
pushed from the controller via long-poll, resolves the longest matching
route prefix to an application's ingress deployment, and forwards the
request through a DeploymentHandle.
"""
from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional

from ..handle import DeploymentHandle
from .common import HTTPRequest, LongPollKey


class ProxyActor:
    def __init__(self, host: str, port: int):
        self._host = host
        self._port = port
        self._routes: Dict[str, dict] = {}
        self._handles: Dict[str, DeploymentHandle] = {}
        self._long_poll = None
        self._runner = None

    async def ready(self) -> str:
        if self._runner is not None:  # idempotent under get_if_exists races
            return f"http://{self._host}:{self._port}"
        from aiohttp import web

        from ... import get_actor
        from .common import CONTROLLER_NAME
        from .long_poll import LongPollClient

        self._long_poll = LongPollClient(
            get_actor(CONTROLLER_NAME),
            {LongPollKey.ROUTE_TABLE: self._update_routes},
        )
        app = web.Application(client_max_size=256 * 1024 * 1024)
        app.router.add_route("*", "/{tail:.*}", self._handle)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self._host, self._port)
        await site.start()
        return f"http://{self._host}:{self._port}"

    def _update_routes(self, routes: Dict[str, dict]):
        self._routes = routes
        self._handles = {
            prefix: DeploymentHandle(
                info["ingress"], info["app_name"], _is_http=True
            )
            for prefix, info in routes.items()
        }

    def _match_route(self, path: str) -> Optional[str]:
        best = None
        for prefix in self._routes:
            norm = prefix.rstrip("/") or "/"
            if path == norm or path.startswith(norm + "/") or norm == "/":
                if best is None or len(norm) > len(best.rstrip("/") or "/"):
                    best = prefix
        return best

    async def _handle(self, request):
        from aiohttp import web

        if request.path == "/-/healthz":
            return web.Response(text="ok")
        if request.path == "/-/routes":
            return web.json_response(
                {p: i["app_name"] for p, i in self._routes.items()}
            )
        prefix = self._match_route(request.path)
        if prefix is None:
            return web.Response(status=404, text="no route")
        handle = self._handles[prefix]
        body = await request.read()
        req = HTTPRequest(
            method=request.method,
            path=request.path,
            query=dict(request.query),
            headers=dict(request.headers),
            body=body,
        )
        if self._routes[prefix].get("streaming"):
            return await self._handle_streaming(request, handle, req)
        try:
            result = await handle.remote(req)
        except Exception as e:  # noqa: BLE001 - surface as 500
            return web.Response(status=500, text=f"{type(e).__name__}: {e}")
        return _encode_response(web, result)

    async def _handle_streaming(self, request, handle, req):
        """Generator ingress: write each yielded chunk as it arrives —
        the client observes output while the handler is still running
        (reference: Serve token streaming over the generator path)."""
        from aiohttp import web

        gen = handle.options(stream=True).remote(req)
        resp = web.StreamResponse(
            status=200,
            headers={"Content-Type": "text/plain; charset=utf-8"},
        )
        await resp.prepare(request)
        try:
            async for chunk in gen:
                await resp.write(_encode_chunk(chunk))
        except Exception as e:  # noqa: BLE001 - stream already started
            await resp.write(
                f"\n[stream error] {type(e).__name__}: {e}".encode()
            )
        await resp.write_eof()
        return resp

    async def shutdown(self):
        if self._long_poll:
            self._long_poll.stop()
        if self._runner:
            await self._runner.cleanup()


def _encode_chunk(chunk) -> bytes:
    if isinstance(chunk, bytes):
        return chunk
    if isinstance(chunk, str):
        return chunk.encode()
    return (json.dumps(chunk) + "\n").encode()


def _encode_response(web, result):
    status = 200
    if isinstance(result, tuple) and len(result) == 2 and isinstance(result[0], int):
        status, result = result
    if isinstance(result, bytes):
        return web.Response(status=status, body=result)
    if isinstance(result, str):
        return web.Response(status=status, text=result)
    return web.Response(
        status=status,
        text=json.dumps(result),
        content_type="application/json",
    )
