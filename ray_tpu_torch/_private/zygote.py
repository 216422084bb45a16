"""Fork-server worker spawning (zygote).

Reference behavior: the worker pool keeps prestarted idle workers so a
task/actor never pays interpreter cold-start
(src/ray/raylet/worker_pool.cc StartWorkerProcess + prestart). On a
loaded node the cold start is the dominant cost of actor creation
(~0.5 s of CPU per python+ray import); this zygote pays it once and
then forks warm children in ~5 ms.

Protocol (newline-delimited JSON over the zygote's stdin/stdout):

  request:  {"env": {...overrides}, "log": "/path/worker.out"}
  response: {"pid": 12345} | {"error": "..."}

The zygote is kept strictly single-threaded so fork() is safe, and it
never connects to anything — a forked child owns only its inherited
module imports. Child bootstrap: new session, stdio redirected to the
worker log, env overrides applied, then worker_main.main().

Fork-shared randomness: ids.py registers an os.register_at_fork hook
re-seeding its per-process unique-id prefix — without it every forked
worker would mint colliding task/object ids.
"""
from __future__ import annotations

import json
import os
import signal
import sys


def _child(env: dict, log_path: str) -> None:
    os.setsid()
    signal.signal(signal.SIGCHLD, signal.SIG_DFL)
    # stdio: control pipe must not leak into the worker.
    devnull = os.open(os.devnull, os.O_RDONLY)
    os.dup2(devnull, 0)
    os.close(devnull)
    out = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(out, 1)
    os.dup2(out, 2)
    os.close(out)
    os.environ.update(env)
    for k, v in list(env.items()):
        if v == "":
            os.environ.pop(k, None)
    # Line-buffer the redirected stdio like a fresh interpreter would.
    sys.stdout = os.fdopen(1, "w", buffering=1)
    sys.stderr = os.fdopen(2, "w", buffering=1)
    from . import worker_main

    try:
        worker_main.main()
    except SystemExit:
        raise
    except BaseException:  # noqa: BLE001
        import traceback

        traceback.print_exc()
        os._exit(1)
    os._exit(0)


def main() -> None:
    # Children are reaped automatically; the zygote never waits on them
    # (their lifecycle is tracked by the control plane via pid).
    signal.signal(signal.SIGCHLD, signal.SIG_IGN)
    # Warm the expensive imports ONCE, before any fork. worker_main
    # pulls in the whole ray_tpu_torch core (not torch — workers import
    # that lazily when a task needs it; nothing here may start CUDA,
    # which does not survive fork(), and GPU workers never come from
    # this process). The modules the BOOT path imports lazily must also
    # be warmed here: anything left out is re-imported — and
    # source-compiled — by every forked child, which was ~70% of
    # CoreClient.__init__ time in the boot profile.
    from . import worker_main  # noqa: F401
    from . import (  # noqa: F401
        native_store,
        object_store,
        object_transfer,
        ref_tracker,
        runtime_env,
        worker,
    )
    import ray_tpu_torch  # noqa: F401  (public API: tasks resolve through it)

    stdin = sys.stdin
    stdout = sys.stdout
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            pid = os.fork()
        except Exception as e:  # noqa: BLE001
            stdout.write(json.dumps({"error": str(e)}) + "\n")
            stdout.flush()
            continue
        if pid == 0:
            _child(req.get("env", {}), req["log"])
            os._exit(0)  # unreachable
        stdout.write(json.dumps({"pid": pid}) + "\n")
        stdout.flush()


if __name__ == "__main__":
    main()
