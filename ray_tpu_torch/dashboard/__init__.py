"""Dashboard: HTTP view of cluster state, metrics, logs, profiling.

Reference: dashboard/ (aiohttp head process serving a React frontend +
JSON APIs fed by the GCS and agents). Equivalent riding the same data
pipelines, with the frontend as a no-build-step static SPA
(``client/``: hash-routed pages for overview/nodes/workers/actors/
tasks/PGs/objects/jobs/serve/logs plus an SVG flamegraph viewer —
reference ``dashboard/client/src``, matched in function not pixels):

  /                         the SPA shell (client/index.html)
  /static/{app.js,style.css} SPA assets
  /api/cluster              resources
  /api/{nodes,workers,...}  state API as JSON
  /api/metrics_timeseries   ring buffer of sampled core gauges
  /api/logs?prefix=&tail=   the driver log ring (log pipeline)
  /api/profile/{worker_id}  live thread stacks from a worker;
                            ?mode=sample&duration=5 returns a
                            statistical profile as folded flamegraph
                            stacks (reference:
                            reporter/profile_manager.py py-spy -f —
                            in-process sampling instead of ptrace)
  /metrics                  Prometheus text exposition of user +
                            core-runtime metrics (reference: the node
                            metrics agent's Prometheus endpoint)
  /api/serve/applications/  GET live app statuses / PUT a declarative
                            config (deploys it) / DELETE all apps
                            (reference: dashboard/modules/serve/ REST
                            config API)
  /api/workflow/events/{k}  POST fires a workflow event (reference:
                            workflow/http_event_provider.py); the port
                            has no workflow yet, so it answers 501
  /api/task/{task_id}       one task's state + its timeline events
  /api/actor/{actor_id}     one actor's state + its tasks
  /api/jobs                 submitted jobs (job_submission KV table)
  /api/job/{job_id}/logs    one job's captured output

    from ray_tpu_torch.dashboard import start_dashboard
    url = start_dashboard(port=8265)

aiohttp is imported where the server starts, never with this module: a
machine without it has the rest of the port.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

_CLIENT_DIR = os.path.join(os.path.dirname(__file__), "client")

# Core gauges sampled into the timeseries ring (2s period, ~10min of
# history at 300 samples).
_SAMPLE_PERIOD_S = 2.0
_RING = 300


class DashboardActor:
    def __init__(self, host: str, port: int):
        self._host = host
        self._port = port
        self._runner = None
        self._ts: dict = {}  # name -> deque[(t, value)]
        # Sampler runs in a to_thread worker while handlers iterate on
        # the event loop — guard both.
        self._ts_lock = threading.Lock()
        self._sampler = None

    async def ready(self) -> str:
        if self._runner is not None:
            return f"http://{self._host}:{self._port}"
        import asyncio

        from aiohttp import web

        app = web.Application()
        app.router.add_get("/", self._index)
        app.router.add_get("/api/cluster", self._cluster)
        app.router.add_get("/api/metrics_timeseries", self._timeseries)
        app.router.add_get("/api/logs", self._logs)
        app.router.add_get("/api/profile/{worker_id}", self._profile)
        app.router.add_get("/metrics", self._prometheus)
        app.router.add_get(
            "/api/serve/applications/", self._serve_get
        )
        app.router.add_put(
            "/api/serve/applications/", self._serve_put
        )
        app.router.add_delete(
            "/api/serve/applications/", self._serve_delete
        )
        app.router.add_post(
            "/api/workflow/events/{key:.+}", self._workflow_event
        )
        app.router.add_get("/api/events", self._events)
        app.router.add_get("/api/events_summary", self._events_summary)
        app.router.add_get("/api/task/{task_id}", self._task_detail)
        app.router.add_get("/api/actor/{actor_id}", self._actor_detail)
        app.router.add_get("/api/jobs", self._jobs)
        app.router.add_get("/api/job/{job_id}/logs", self._job_logs)
        app.router.add_get("/api/{kind}", self._list)
        app.router.add_get("/static/{name}", self._static)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self._host, self._port)
        await site.start()
        self._sampler = asyncio.ensure_future(self._sample_loop())
        return f"http://{self._host}:{self._port}"

    # -------------------------------------------------------- timeseries
    def _sample_once(self):
        import ray_tpu_torch

        total = ray_tpu_torch.cluster_resources()
        avail = ray_tpu_torch.available_resources()
        now = time.time()
        samples = {}
        for k, v in total.items():
            samples[f"{k} used"] = v - avail.get(k, 0.0)
        nodes = ray_tpu_torch.nodes()
        samples["nodes alive"] = float(
            sum(1 for n in nodes if n["alive"])
        )
        # Per-node CPU drill-down series (reference: per-node charts in
        # the dashboard frontend).
        for n in nodes:
            if not n["alive"]:
                continue
            # Labels default to the hostname, which co-hosted nodes
            # share: suffix a node-id tag so series never collapse.
            label = n.get("label") or "node"
            tag = n["node_id"].hex()[:6]
            used = n["total"].get("CPU", 0.0) - n["available"].get("CPU", 0.0)
            samples[f"CPU used @ {label}:{tag}"] = used
        from ..util.state import list_workers

        samples["workers"] = float(len(list_workers(limit=10_000)))
        with self._ts_lock:
            for name, v in samples.items():
                self._ts.setdefault(name, deque(maxlen=_RING)).append(
                    (now, v)
                )

    async def _sample_loop(self):
        import asyncio

        while True:
            try:
                # Off the event loop: the sample does blocking GCS RPCs.
                await asyncio.to_thread(self._sample_once)
            except Exception:  # noqa: BLE001 - cluster may be mid-shutdown
                pass
            await asyncio.sleep(_SAMPLE_PERIOD_S)

    async def _timeseries(self, request):
        from aiohttp import web

        with self._ts_lock:
            series = {
                name: [v for _, v in dq] for name, dq in self._ts.items()
            }
            stamps = {
                name: [t for t, _ in dq] for name, dq in self._ts.items()
            }
        return web.json_response(
            {
                "period_s": _SAMPLE_PERIOD_S,
                "series": series,
                "timestamps": stamps,
            }
        )

    # ------------------------------------------------------------- pages
    async def _index(self, request):
        from aiohttp import web

        with open(os.path.join(_CLIENT_DIR, "index.html")) as f:
            return web.Response(text=f.read(), content_type="text/html")

    async def _static(self, request):
        from aiohttp import web

        name = request.match_info["name"]
        # Flat directory, explicit allowlist: no traversal surface.
        types = {"app.js": "application/javascript", "style.css": "text/css"}
        if name not in types:
            return web.Response(status=404, text=f"no asset {name}")
        with open(os.path.join(_CLIENT_DIR, name)) as f:
            return web.Response(text=f.read(), content_type=types[name])

    async def _cluster(self, request):
        from aiohttp import web

        import ray_tpu_torch

        return web.json_response(
            {
                "total": ray_tpu_torch.cluster_resources(),
                "available": ray_tpu_torch.available_resources(),
            }
        )

    async def _list(self, request):
        import asyncio

        from aiohttp import web

        from ..util import state as state_api

        kind = request.match_info["kind"]
        fn = getattr(state_api, f"list_{kind}", None)
        if fn is None:
            return web.Response(status=404, text=f"unknown kind {kind}")
        return web.json_response(await asyncio.to_thread(fn, limit=500))

    # -------------------------------------------------------------- logs
    async def _logs(self, request):
        import asyncio

        from aiohttp import web

        from .._private.worker import global_client

        reply = await asyncio.to_thread(
            global_client().request,
            {
                "type": "get_logs",
                "worker_prefix": request.query.get("prefix", ""),
                "tail": int(request.query.get("tail", 200)),
            },
        )
        return web.json_response({"lines": reply.get("lines", [])})

    # ----------------------------------------------------------- profile
    async def _profile(self, request):
        import asyncio

        from aiohttp import web

        from .._private.worker import global_client

        wid = bytes.fromhex(request.match_info["worker_id"])
        if request.query.get("mode") == "sample":
            # Statistical profile: folded flamegraph stacks, ready for
            # speedscope / flamegraph.pl.
            try:
                duration = float(request.query.get("duration", "5"))
            except ValueError:
                duration = 5.0
            if not (duration == duration):  # NaN
                duration = 5.0
            duration = min(max(duration, 0.1), 60.0)
            reply = await asyncio.to_thread(
                global_client().request,
                {
                    "type": "worker_profile",
                    "worker_id": wid,
                    "duration": duration,
                    "interval": float(
                        request.query.get("interval", "0.01")
                    ),
                },
                duration + 15.0,
            )
            if not reply.get("ok"):
                return web.Response(
                    status=404, text=reply.get("error", "?")
                )
            header = (
                f"# folded stacks: {reply.get('samples')} samples over "
                f"{duration}s\n"
            )
            return web.Response(
                text=header + reply["text"], content_type="text/plain"
            )
        # The GCS waiter can take up to its 10s sweep to time out —
        # never hold the event loop for that.
        reply = await asyncio.to_thread(
            global_client().request,
            {"type": "worker_stacks", "worker_id": wid},
            15.0,
        )
        if not reply.get("ok"):
            return web.Response(status=404, text=reply.get("error", "?"))
        return web.Response(text=reply["text"], content_type="text/plain")

    # ------------------------------------------------------------- serve
    def _serve_statuses_json(self):
        from .. import serve

        out = {}
        for name, info in serve.status().items():
            out[name] = {
                "status": info.status.value,
                "message": info.message,
                "route_prefix": info.route_prefix,
                "deployments": {
                    d: {
                        "status": s.status.value,
                        "message": s.message,
                        "num_replicas": s.num_replicas,
                    }
                    for d, s in info.deployments.items()
                },
            }
        return out

    async def _serve_get(self, request):
        import asyncio

        from aiohttp import web

        try:
            return web.json_response(
                await asyncio.to_thread(self._serve_statuses_json)
            )
        except ValueError:  # controller actor not found: serve not started
            return web.json_response({})

    async def _serve_put(self, request):
        """Declarative deploy over HTTP: the same schema as `serve
        deploy config.yaml` (reference: dashboard/modules/serve PUT
        /api/serve/applications/)."""
        import asyncio

        from aiohttp import web

        from ..serve.schema import deploy_config

        def deploy(config):
            deploy_config(config, _blocking=True)
            return self._serve_statuses_json()

        try:
            config = await request.json()
            return web.json_response(
                await asyncio.to_thread(deploy, config)
            )
        except Exception as e:  # noqa: BLE001 - bad body/config -> 400
            return web.json_response(
                {"error": f"{type(e).__name__}: {e}"}, status=400
            )

    async def _serve_delete(self, request):
        import asyncio

        from aiohttp import web

        from .. import serve

        await asyncio.to_thread(serve.shutdown)
        return web.Response(status=204)

    async def _workflow_event(self, request):
        """HTTP event provider (reference: workflow/
        http_event_provider.py). The port has no workflow module yet:
        the route answers 501 until it does."""
        from aiohttp import web

        return web.json_response(
            {"error": "workflow is not ported yet",
             "key": request.match_info["key"]},
            status=501,
        )

    # --------------------------------------------------------------- jobs
    async def _jobs(self, request):
        """Submitted jobs (reference: dashboard/modules/job/ — the job
        head serves the submission table the SDK writes)."""
        import asyncio

        from aiohttp import web

        from ..job_submission import JobSubmissionClient

        # No swallow: an empty table already returns [] — any exception
        # here is a real failure and must surface as a 500, not render
        # as a healthy empty jobs list.
        return web.json_response(
            await asyncio.to_thread(lambda: JobSubmissionClient().list_jobs())
        )

    async def _job_logs(self, request):
        import asyncio

        from aiohttp import web

        from ..job_submission import JobSubmissionClient

        jid = request.match_info["job_id"]
        text = await asyncio.to_thread(
            lambda: JobSubmissionClient().get_job_logs(jid)
        )
        return web.Response(text=text, content_type="text/plain")

    # ------------------------------------------------------------- events
    async def _events(self, request):
        """Flight-recorder feed (events.py): runtime transitions for
        the timeline view, filterable by task id / category."""
        import asyncio

        from aiohttp import web

        from ..util.state import list_cluster_events

        q = request.query
        try:
            limit = int(q.get("limit", "500"))
        except ValueError:
            limit = 500
        events = await asyncio.to_thread(
            list_cluster_events,
            entity=q.get("task") or None,
            category=q.get("category") or None,
            limit=limit,
        )
        return web.json_response({"events": events})

    async def _events_summary(self, request):
        """Derived flight-recorder metrics as JSON: per-phase latency
        histograms, drop counters, queue depth — the same numbers the
        /metrics Prometheus series are built from."""
        import asyncio

        from aiohttp import web

        from ..util.state import summarize_events

        summary = await asyncio.to_thread(summarize_events)
        return web.json_response({"summary": summary})

    # --------------------------------------------------------- drill-down
    async def _task_detail(self, request):
        import asyncio

        from aiohttp import web

        from .._private import state as _state
        from ..util.state import list_tasks

        tid = request.match_info["task_id"]

        def build():
            # EXACT match only: ids are process-prefix + counter, so a
            # truncated prefix matches every id from that driver.
            rows = [
                t for t in list_tasks(limit=10_000)
                if t.get("task_id", "") == tid
            ]
            events = [
                e for e in _state.task_events()
                if e.get("task_id", "") == tid
            ]
            return {"task": rows[0] if rows else None, "events": events}

        detail = await asyncio.to_thread(build)
        if detail["task"] is None and not detail["events"]:
            return web.Response(status=404, text=f"no task {tid}")
        return web.json_response(detail)

    async def _actor_detail(self, request):
        import asyncio

        from aiohttp import web

        from ..util.state import list_actors, list_tasks

        aid = request.match_info["actor_id"]

        def build():
            rows = [
                a for a in list_actors(limit=10_000)
                if a.get("actor_id", "") == aid
            ]
            tasks = [
                t for t in list_tasks(limit=10_000)
                if t.get("actor_id", "") == aid
            ]
            return {"actor": rows[0] if rows else None, "tasks": tasks}

        detail = await asyncio.to_thread(build)
        if detail["actor"] is None:
            return web.Response(status=404, text=f"no actor {aid}")
        return web.json_response(detail)

    # -------------------------------------------------------- prometheus
    async def _prometheus(self, request):
        import asyncio

        from aiohttp import web

        from ..util.metrics import (
            core_runtime_snapshot,
            get_metrics_snapshot,
            prometheus_text,
        )

        def scrape() -> str:
            snap = get_metrics_snapshot()
            try:
                snap.update(core_runtime_snapshot())
            except Exception:  # noqa: BLE001 - keep user metrics
                pass
            return prometheus_text(snap)

        return web.Response(
            text=await asyncio.to_thread(scrape),
            content_type="text/plain",
            charset="utf-8",
        )

    async def shutdown(self):
        if self._sampler:
            self._sampler.cancel()
        if self._runner:
            await self._runner.cleanup()


def start_dashboard(host: str = "127.0.0.1", port: int = 8265) -> str:
    """Start (or find) the dashboard actor on the head node, as upstream
    Ray runs its dashboard there; returns its URL."""
    import ray_tpu_torch
    from .._private.worker import head_node_id
    from ..util.scheduling_strategies import NodeAffinitySchedulingStrategy

    actor = (
        ray_tpu_torch.remote(DashboardActor)
        .options(name="RAY_TPU_TORCH_DASHBOARD", max_concurrency=16,
                 get_if_exists=True, num_cpus=0,
                 scheduling_strategy=NodeAffinitySchedulingStrategy(
                     node_id=head_node_id(), soft=False))
        .remote(host, port)
    )
    return ray_tpu_torch.get(actor.ready.remote())
