"""The port's CLI (reference: python/ray/scripts/scripts.py — ray
start/stop/status/list/timeline/memory/submit).

    python -m ray_tpu_torch start --head --num-cpus 8 --port 0  # standalone head
    python -m ray_tpu_torch start --address HOST:PORT --authkey KEY --num-gpus 8
    python -m ray_tpu_torch status
    python -m ray_tpu_torch list nodes
    python -m ray_tpu_torch summary tasks
    python -m ray_tpu_torch timeline -o trace.json
    python -m ray_tpu_torch memory
    python -m ray_tpu_torch submit --wait -- python my_job.py
    python -m ray_tpu_torch stop

The head writes its address and key to the port's session file
(``config.session_file()``, under the port's temp root), which
``init(address="auto")`` and every command here read.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

from .._private.config import session_file


def _connect():
    import ray_tpu_torch

    ray_tpu_torch.init(address="auto")
    return ray_tpu_torch


def cmd_start(args):
    if args.address:
        # Worker node: join an existing head over TCP as a node daemon
        # (reference: `ray start --address=<head>` starting a raylet).
        from ray_tpu_torch._private import raylet

        daemon_args = ["--address", args.address]
        if args.authkey:
            daemon_args += ["--authkey", args.authkey]
        if args.num_cpus is not None:
            daemon_args += ["--num-cpus", str(args.num_cpus)]
        if args.num_gpus is not None:
            daemon_args += ["--num-gpus", str(args.num_gpus)]
        raylet.main(daemon_args)
        return

    import ray_tpu_torch

    ray_tpu_torch.init(
        num_cpus=args.num_cpus, num_gpus=args.num_gpus, tcp_port=args.port
    )
    from ray_tpu_torch._private.worker import _global

    node = _global.node
    path = session_file()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(
            {
                "address": node.address,
                "tcp_address": node.tcp_address,
                "authkey": node.authkey.hex(),
                "pid": os.getpid(),
                "session_dir": node.session_dir,
            },
            f,
        )
    os.replace(tmp, path)  # atomic: readers never see partial JSON
    print(f"ray_tpu_torch head started: {node.address}", flush=True)
    if node.tcp_address:
        print(f"network address: {node.tcp_address}")
        print(
            "join a node with: python -m ray_tpu_torch start "
            f"--address={node.tcp_address} --authkey={node.authkey.hex()}"
        )
    print(f"session file: {path}")
    print("connect with: ray_tpu_torch.init(address='auto')", flush=True)
    stop = [False]

    def on_term(*_):
        stop[0] = True

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    try:
        while not stop[0]:
            time.sleep(0.5)
    finally:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        ray_tpu_torch.shutdown()
        print("head stopped", flush=True)


def cmd_stop(args):
    path = session_file()
    try:
        with open(path) as f:
            info = json.load(f)
    except FileNotFoundError:
        print("no running head")
        return
    try:
        os.kill(info["pid"], signal.SIGTERM)
        print(f"sent SIGTERM to head pid {info['pid']}")
    except ProcessLookupError:
        print("head already gone")
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


def cmd_status(args):
    rt = _connect()
    total = rt.cluster_resources()
    avail = rt.available_resources()
    from ray_tpu_torch.util.state import list_nodes, list_workers

    nodes = list_nodes()
    workers = list_workers()
    print("== Cluster status ==")
    for k in sorted(total):
        print(f"  {avail.get(k, 0):g}/{total[k]:g} {k}")
    print(f"  nodes: {sum(1 for n in nodes if n['alive'])} alive"
          f" / {len(nodes)} total")
    print(f"  workers: {len(workers)}")


def cmd_drain(args):
    rt = _connect()
    node_id = bytes.fromhex(args.node_id)
    ok = rt.drain_node(
        node_id, reason=args.reason, deadline_s=args.deadline_s
    )
    print("drain accepted" if ok else "drain rejected (no such node)")
    return 0 if ok else 1


def _print_table(items, columns):
    if not items:
        print("(none)")
        return
    widths = {
        c: max(len(c), *(len(str(i.get(c, ""))) for i in items))
        for c in columns
    }
    print("  ".join(c.ljust(widths[c]) for c in columns))
    for i in items:
        print("  ".join(str(i.get(c, "")).ljust(widths[c]) for c in columns))


def cmd_usage(args):
    import json as _json

    from ray_tpu_torch._private import usage_stats

    if not usage_stats.enabled():
        print("usage stats disabled (RAY_TPU_TORCH_USAGE_STATS_ENABLED=0)")
        return 0
    rows = usage_stats.read_all()
    if not rows:
        print("no usage records (sink: local JSONL, zero egress)")
        return 0
    for r in rows[-20:]:
        print(_json.dumps(r))
    return 0


def cmd_debug(args):
    _connect()
    from ray_tpu_torch.util import rpdb

    live = rpdb.sessions()
    if not live:
        print("no rpdb sessions waiting")
        return 1
    if args.session is None:
        if len(live) > 1:
            print("multiple sessions; pick one:")
            for name, addr in live:
                print(f"  {name}  {addr}")
            return 1
        name, addr = live[0]
    else:
        match = dict(live).get(args.session)
        if match is None:
            print(f"no session {args.session!r}; waiting: {live}")
            return 1
        name, addr = args.session, match
    print(f"attaching to {name} at {addr} (Ctrl-C to detach)")
    rpdb.bridge(addr)
    return 0


def cmd_list(args):
    _connect()
    from ray_tpu_torch.util import state as state_api

    fn = getattr(state_api, f"list_{args.kind}")
    items = fn(limit=args.limit)
    columns = {
        "actors": ["actor_id", "name", "state", "class_name"],
        "tasks": ["task_id", "name", "state", "worker_id"],
        "nodes": ["node_id", "alive", "label", "total", "health_score",
                  "quarantined"],
        "workers": ["worker_id", "state", "pid", "num_inflight"],
        "objects": ["object_id", "status", "size", "inline"],
        "placement_groups": ["placement_group_id", "state", "strategy"],
    }[args.kind]
    _print_table(items, columns)


def cmd_nodes(args):
    """Per-node gray-failure health: scorer EWMA, quarantine flag, and
    the hedge won/lost scoreboard."""
    _connect()
    from ray_tpu_torch.util.state import list_nodes

    items = list_nodes()
    for it in items:
        it["hedges_won_lost"] = (
            f"{it.get('hedges_won', 0)}/{it.get('hedges_lost', 0)}"
        )
    _print_table(
        items,
        ["node_id", "alive", "label", "health_score", "quarantined",
         "hedges_won_lost"],
    )


def cmd_summary(args):
    _connect()
    from ray_tpu_torch.util.state import summarize_tasks

    print(json.dumps(summarize_tasks(), indent=2))


def cmd_timeline(args):
    _connect()
    from ray_tpu_torch._private.state import timeline

    timeline(args.output)
    print(f"wrote {args.output} (open in chrome://tracing or perfetto)")


def cmd_events(args):
    """Flight-recorder transitions (submission → scheduling → lease →
    fork → exec → seal, plus worker/lease/object/transfer lifecycle)."""
    _connect()
    from ray_tpu_torch.util.state import list_cluster_events

    if args.record is not None:
        from ray_tpu_torch.util.state import set_events_recording

        set_events_recording(args.record == "on")
        print(f"flight recorder: recording {args.record}")
        return

    events = list_cluster_events(
        entity=args.task,
        category="task" if args.task else args.category,
        limit=args.limit,
    )
    if args.json:
        print(json.dumps(events, indent=2, default=str))
        return
    rows = [
        {
            "time": f"{e['timestamp']:.6f}",
            "category": e["category"],
            "event": e["event"],
            "entity": (e.get("entity") or "")[:16],
            "source": e.get("source", ""),
            "attrs": json.dumps(e.get("attrs") or {}, default=str),
        }
        for e in events
    ]
    _print_table(
        rows, ["time", "category", "event", "entity", "source", "attrs"]
    )


def cmd_memory(args):
    _connect()
    from ray_tpu_torch.util.state import list_objects

    items = list_objects(limit=args.limit)
    total = sum(i["size"] for i in items)
    _print_table(items, ["object_id", "status", "size", "inline"])
    print(f"total: {len(items)} objects, {total / 1e6:.1f} MB")


def cmd_metrics(args):
    _connect()
    from ray_tpu_torch.util.metrics import get_metrics_snapshot

    print(json.dumps(get_metrics_snapshot(), indent=2))


def cmd_dashboard(args):
    _connect()
    from ray_tpu_torch.dashboard import start_dashboard

    url = start_dashboard(port=args.port)
    print(f"dashboard running at {url} (actor lives in the cluster)")


def cmd_submit(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient()
    parts = args.entrypoint
    if parts and parts[0] == "--":  # argparse REMAINDER keeps the separator
        parts = parts[1:]
    entrypoint = " ".join(parts)
    runtime_env = json.loads(args.runtime_env_json) if args.runtime_env_json else None
    job_id = client.submit_job(entrypoint=entrypoint, runtime_env=runtime_env)
    print(f"submitted {job_id}: {entrypoint}", flush=True)
    if args.wait:
        status = client.wait_until_finish(job_id)
        print(client.get_job_logs(job_id), end="")
        print(f"job {job_id}: {status.value}")
        sys.exit(0 if status.value == "SUCCEEDED" else 1)


def cmd_jobs(args):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient()
    _print_table(client.list_jobs(), ["job_id", "status", "entrypoint"])


def cmd_logs(args):
    """Recent worker stdout/stderr from the cluster's log ring
    (reference: `ray logs`)."""
    import os

    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_client

    # No live log subscription: the ring snapshot below would duplicate
    # every line that also arrived as a push.
    os.environ["RAY_TPU_TORCH_LOG_TO_DRIVER"] = "0"
    ray_tpu_torch.init(address=args.address or "auto", ignore_reinit_error=True)
    reply = global_client().request(
        {
            "type": "get_logs",
            "worker_prefix": args.worker or "",
            "tail": args.tail,
        }
    )
    for node, worker_tag, line in reply.get("lines", []):
        print(f"({node} worker={worker_tag}) {line}")


def cmd_serve_deploy(args):
    """Declarative deploy (reference: `serve deploy config.yaml`)."""
    import os

    import ray_tpu_torch
    from ray_tpu_torch import serve

    sys.path.insert(0, os.getcwd())
    os.environ["RAY_TPU_TORCH_LOG_TO_DRIVER"] = "0"
    ray_tpu_torch.init(address=args.address or "auto", ignore_reinit_error=True)
    handles = serve.deploy_config(args.config)
    print(f"deployed {len(handles)} application(s) from {args.config}")


def cmd_serve_status(args):
    import os

    import ray_tpu_torch
    from ray_tpu_torch import serve

    os.environ["RAY_TPU_TORCH_LOG_TO_DRIVER"] = "0"
    ray_tpu_torch.init(address=args.address or "auto", ignore_reinit_error=True)
    for name, info in serve.status().items():
        deps = ", ".join(
            f"{d}: {s.status.value} x{s.num_replicas}"
            for d, s in info.deployments.items()
        )
        print(f"{name}: {info.status.value}  [{deps}]")


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m ray_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser(
        "start", help="start a head (--head) or join one (--address)"
    )
    sp.add_argument("--head", action="store_true")
    sp.add_argument(
        "--address", default=None, help="head host:port to join as a node"
    )
    sp.add_argument("--authkey", default=None, help="cluster auth key (hex)")
    sp.add_argument(
        "--port",
        type=int,
        default=None,
        help="TCP port for the head's network control plane (0 = any)",
    )
    sp.add_argument("--num-cpus", type=int, default=None)
    sp.add_argument(
        "--num-gpus", type=int, default=None,
        help="GPUs of this node (default: the cards it sees)",
    )
    sp.set_defaults(fn=cmd_start)

    sub.add_parser("stop", help="stop the head").set_defaults(fn=cmd_stop)
    sub.add_parser("status", help="cluster status").set_defaults(fn=cmd_status)

    sp = sub.add_parser("drain", help="gracefully drain a node")
    sp.add_argument("node_id", help="node id (hex, from `list nodes`)")
    sp.add_argument("--reason", default="manual drain")
    sp.add_argument("--deadline-s", type=float, default=30.0)
    sp.set_defaults(fn=cmd_drain)

    sp = sub.add_parser("list", help="list cluster state")
    sp.add_argument("kind", choices=["actors", "tasks", "nodes", "workers",
                                     "objects", "placement_groups"])
    sp.add_argument("--limit", type=int, default=100)
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser(
        "usage", help="show locally-recorded usage stats (never uploaded)"
    )
    sp.set_defaults(fn=cmd_usage)

    sp = sub.add_parser(
        "debug", help="attach to a waiting rpdb session (util/rpdb)"
    )
    sp.add_argument(
        "session", nargs="?", default=None,
        help="session name from the list (default: the only one)",
    )
    sp.set_defaults(fn=cmd_debug)

    sub.add_parser(
        "nodes", help="per-node health (gray-failure scorer)"
    ).set_defaults(fn=cmd_nodes)

    sp = sub.add_parser("summary", help="summarize tasks")
    sp.add_argument("kind", choices=["tasks"])
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("timeline", help="dump chrome trace")
    sp.add_argument("-o", "--output", default="ray_tpu_torch_timeline.json")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser(
        "events", help="flight-recorder runtime events"
    )
    sp.add_argument("--task", default=None, help="task id (hex) filter")
    sp.add_argument(
        "--category", default=None,
        help="category filter (task/worker/lease/object/transfer/sched)",
    )
    sp.add_argument("--limit", type=int, default=200)
    sp.add_argument("--json", action="store_true")
    sp.add_argument(
        "--record", choices=("on", "off"), default=None,
        help="toggle flight-recorder capture cluster-wide",
    )
    sp.set_defaults(fn=cmd_events)

    sp = sub.add_parser("memory", help="object store contents")
    sp.add_argument("--limit", type=int, default=100)
    sp.set_defaults(fn=cmd_memory)

    sub.add_parser("metrics", help="metrics snapshot").set_defaults(
        fn=cmd_metrics
    )

    sp = sub.add_parser("dashboard", help="start the dashboard")
    sp.add_argument("--port", type=int, default=8265)
    sp.set_defaults(fn=cmd_dashboard)

    sp = sub.add_parser("submit", help="submit a job")
    sp.add_argument("--wait", action="store_true")
    sp.add_argument(
        "--runtime-env-json", default=None,
        help='the job\'s runtime_env as JSON, e.g. \'{"env_vars": {"K": "V"}}\'',
    )
    sp.add_argument("entrypoint", nargs=argparse.REMAINDER)
    sp.set_defaults(fn=cmd_submit)

    sub.add_parser("jobs", help="list jobs").set_defaults(fn=cmd_jobs)

    sp = sub.add_parser("logs", help="recent worker logs")
    sp.add_argument("--worker", default=None, help="worker id prefix filter")
    sp.add_argument("--tail", type=int, default=1000)
    sp.add_argument("--address", default=None, help="cluster address")
    sp.set_defaults(fn=cmd_logs)

    sp = sub.add_parser("serve", help="serve control (deploy/status)")
    serve_sub = sp.add_subparsers(dest="serve_cmd", required=True)
    spd = serve_sub.add_parser("deploy", help="deploy a YAML config")
    spd.add_argument("config", help="path to serve config YAML")
    spd.add_argument("--address", default=None, help="cluster address")
    spd.set_defaults(fn=cmd_serve_deploy)
    sps = serve_sub.add_parser("status", help="application statuses")
    sps.add_argument("--address", default=None, help="cluster address")
    sps.set_defaults(fn=cmd_serve_status)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
