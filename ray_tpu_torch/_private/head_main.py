"""Standalone head process: session + GCS without a driver attached.

Reference: `ray start --head` launching the gcs_server process
(python/ray/scripts/scripts.py + src/ray/gcs/gcs_server_main.cc). Run
with a fixed --session-dir/--authkey/--tcp-port so a supervisor can
SIGKILL and relaunch it: the new head restores the persisted GCS tables
from the session dir, daemons rejoin on the same port, named/detached
actors restart from their creation specs, and queued tasks re-dispatch.

    python -m ray_tpu_torch._private.head_main \
        --session-dir /tmp/ray_tpu_torch/headsess --tcp-port 7421 \
        --authkey <hex> --num-cpus 0
"""
from __future__ import annotations

import argparse
import signal
import sys
import time


def main(argv=None) -> int:
    # Lock-order witness (RAY_TPU_TORCH_lock_witness=1, race-smoke): install
    # BEFORE the runtime constructs its locks so head-side lock
    # acquisition orders are witnessed too.
    from . import lock_witness

    lock_witness.maybe_install()
    parser = argparse.ArgumentParser(description="ray_tpu_torch standalone head")
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--tcp-port", type=int, required=True)
    parser.add_argument("--authkey", required=True, help="hex cluster key")
    parser.add_argument("--num-cpus", type=float, default=0.0)
    args = parser.parse_args(argv)

    # Chaos rule scoping (?role=head, kill:gcs.*) + rebuild the
    # schedule now that the role marker is set (the import-time install
    # saw "driver"). Workers this head spawns get their role pinned
    # back to "worker" in the spawn env (gcs._spawn_worker).
    import os

    os.environ["RAY_TPU_TORCH_CHAOS_ROLE"] = "head"
    from . import chaos as _chaos

    _chaos.refresh()

    from .node import Node

    node = Node(
        resources={"CPU": float(args.num_cpus)},
        tcp_port=args.tcp_port,
        session_dir=args.session_dir,
        authkey=bytes.fromhex(args.authkey),
    )
    sys.stderr.write(
        f"ray_tpu_torch head up: tcp={node.tcp_address} session={node.session_dir}\n"
    )
    sys.stderr.flush()

    stop = {"flag": False}

    def on_signal(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    while not stop["flag"]:
        time.sleep(0.2)
    node.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
