"""Runtime configuration, overridable via ``RAY_TPU_TORCH_<name>`` env vars.

Equivalent of the reference's RAY_CONFIG system
(reference: src/ray/common/ray_config_def.h — 217 entries, each
overridable by a RAY_<name> env var, plus a JSON _system_config).
We keep the same three-layer precedence: default < _system_config dict
passed to init() < environment variable.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict

_DEFAULTS: Dict[str, Any] = {
    # Objects at or below this size are carried inline through the control
    # plane instead of the shared-memory store (reference:
    # max_direct_call_object_size, ray_config_def.h).
    "max_inline_object_size": 100 * 1024,
    # Chunk size for node-to-node object transfer (reference: 5 MiB,
    # ray_config_def.h:345).
    "object_transfer_chunk_bytes": 5 * 1024 * 1024,
    # Worker pool sizing.
    "num_prestart_workers": 2,
    # Concurrent worker bootstraps per node: pipelined forks without a
    # cap let a 100-actor creation storm boot 100 interpreters at once,
    # thrashing small hosts (boot latency grew 0.5s -> 4.4s in the
    # storm profile). 0 = auto (max(4, cpu count)).
    "max_starting_workers_per_node": 0,
    # Sub-core actors (0 < num_cpus < 1, default env, serial) pack many
    # per worker process instead of paying a ~300ms interpreter boot
    # each: declaring "this actor needs 1% of a core" opts into dense
    # co-hosting. Actors with default resources (num_cpus=0) keep a
    # dedicated process (reference process-per-actor isolation).
    "max_actors_per_worker": 64,
    # Prefer opening another shared host (up to ~node CPU count) once
    # every existing host carries this many actors: dense packing saves
    # interpreter boots, spreading saves call-path parallelism.
    "actor_host_spread_threshold": 8,
    "worker_register_timeout_s": 30.0,
    "worker_idle_timeout_s": 300.0,
    # Health checking (reference: gcs_health_check_manager.h).
    "health_check_period_ms": 1000,
    "health_check_failure_threshold": 5,
    # Gray-failure tolerance (straggler layer). The scorer runs each
    # health sweep: per-node EWMA over the sweep's good/bad signals
    # (heartbeat inter-arrival jitter, lease-grant→ack transit, exec
    # overrun vs recorded percentiles, pull re-leads). Thresholds have
    # hysteresis built in: suspect below health_suspect_score,
    # quarantine below health_quarantine_score only via sustained EWMA
    # decay, readmission above health_readmit_score for
    # health_readmit_windows CONSECUTIVE sweeps.
    "health_score_alpha": 0.25,
    "health_suspect_score": 0.6,
    "health_quarantine_score": 0.35,
    "health_readmit_score": 0.85,
    "health_readmit_windows": 3,
    # A heartbeat gap above jitter_factor x health_check_period counts
    # as a bad signal; a grant→ack transit above grant_lat_s likewise.
    "health_hb_jitter_factor": 3.0,
    "health_grant_lat_s": 1.0,
    # Speculative (hedged) execution: a task running on a suspect/
    # quarantined node for longer than hedge_overrun_factor x its
    # name's recorded p99 (needs >= hedge_min_samples completions) gets
    # a duplicate lease on a healthy node; first done wins, the loser
    # is cancelled. 0 disables hedging.
    "hedge_overrun_factor": 3.0,
    "hedge_min_samples": 8,
    "hedge_max_inflight": 16,
    # Hedged pulls: an active chunk pull whose measured throughput
    # drops below the floor (bytes/s, after the grace window) aborts
    # the attempt and re-leads onto a re-resolved holder without
    # double-charging the in-flight byte budget. 0 disables.
    "pull_relead_floor_bytes_s": 0,
    "pull_relead_grace_s": 2.0,
    # Testing hook: skip the same-host shm pull shortcut so every pull
    # takes the chunked TCP path (the straggler soak throttles the
    # data plane at the PeerConn boundary, which shm copies bypass).
    "transfer_force_tcp": False,
    # Task scheduling.
    "max_pending_lease_requests_per_scheduling_class": 10,
    # Hybrid policy (reference: hybrid_scheduling_policy.h:29-49 +
    # ray_config_def.h scheduler_spread_threshold/top_k_fraction): pack
    # nodes while critical-resource utilization stays under the
    # threshold, then least-utilized-first; randomize among the best
    # ceil(top_k_fraction * num_nodes) to avoid thundering herds.
    "scheduler_spread_threshold": 0.5,
    "scheduler_top_k_fraction": 0.2,
    # Testing hook: inject a delay (us range "min:max") into control-plane
    # message handling, keyed by message type (reference:
    # RAY_testing_asio_delay_us, ray_config_def.h:832). Implemented as
    # always-firing delay rules of the chaos engine (_private/chaos.py).
    "testing_rpc_delay_us": "",
    # Chaos engine (reference: python/ray/tests/test_chaos.py): seeded
    # fault-injection rules applied at the transport boundary and named
    # process kill points — see chaos.py for the spec grammar. Same
    # seed ⇒ same injection sequence, so any red run replays with one
    # env var.
    "chaos_spec": "",
    "chaos_seed": 0,
    # Head failover (reference: gcs_rpc_client reconnect-with-backoff +
    # NotifyGCSRestart re-reporting). How long a client/worker keeps
    # retrying the head address after its control connection drops
    # before declaring the session dead. Raylets use
    # worker_register_timeout_s for the same budget (pre-existing).
    "gcs_reconnect_budget_s": 15.0,
    # How long a PENDING directory entry that exists ONLY because a
    # get/wait asked about an unknown object id may stay unclaimed (no
    # owner, no pins, no seal) before the head answers LOST. Normal
    # operation claims such entries within milliseconds (the submit or
    # done batch that races the get); one that never gains substance is
    # a producer lost in a head failover — LOST routes the parked
    # caller into lineage reconstruction instead of a wedged get.
    "pending_ghost_grace_s": 20.0,
    # Recovery grace window opened by a restarted head: reconnecting
    # owners re-advertise owned objects/borrow edges, workers re-claim
    # their actors and running tasks, and unacked done batches replay.
    # At window close, unclaimed soft state is swept through the
    # owner-death/lineage path (orphans reconstruct, they don't leak).
    "head_recovery_grace_s": 3.0,
    # How long a dead owner's promoted directory entries are held
    # before they become reclaimable: borrow edges buffered in the
    # borrower's unflushed ref_flush batch (or an in-flight retransmit)
    # must be able to land on the holder shadow before the head frees
    # the object (reference: the owner's reference table survives into
    # the failure callback, reference_count.h).
    "owner_death_grace_s": 2.0,
    # Object store.
    "object_store_memory_bytes": 0,  # 0 = auto-size the shm pool
    # Spill-to-disk for sealed objects under pool pressure (reference:
    # local_object_manager.h:41). "" = <session_dir>/spill.
    "object_spilling_directory": "",
    # Pool-utilization fraction that triggers background spilling of
    # cold sealed objects (reference: object_spilling_threshold).
    "object_spilling_threshold": 0.8,
    # Pull-manager admission control (reference: pull_manager.h — get >
    # wait > task-args priority classes under a bounded in-flight
    # budget). Total bytes of concurrently-active pulls per process;
    # 0 = auto (a quarter of the node pool, floor 4 transfer chunks).
    # Requests over budget queue by (class, FIFO) and activate as
    # completed/failed/cancelled pulls release budget.
    "pull_in_flight_bytes": 0,
    # How long a put (or task-arg inlining) blocks on a full pool
    # waiting for the spill ladder to free space before falling back
    # to per-object segments / raising OutOfMemoryError. Backpressure,
    # not a cliff: the spill rung gets this long to make room.
    "put_backpressure_timeout_s": 10.0,
    # Memory monitor (reference: memory_monitor.h:52 + the retriable-
    # FIFO worker killing policy): sample host memory every refresh; at
    # or above the usage threshold, kill the newest running retriable
    # task first (resubmitted), then non-retriable (OutOfMemoryError).
    "memory_monitor_refresh_ms": 250,
    "memory_usage_threshold": 0.95,
    # Testing hook: read the usage fraction from this file instead of
    # /proc/meminfo.
    "testing_memory_usage_file": "",
    # Object plane: number of head-side object-directory shards, each
    # with its own lock domain and refcount flush queue (reference:
    # ownership_based_object_directory.h — per-object consultation,
    # never one global table pass). More shards = less cross-client
    # contention; each costs one (lazily started) applier thread.
    "object_directory_shards": 8,
    # Metrics.
    "metrics_report_interval_ms": 1000,
    # Flight recorder (reference: task_event_buffer.h +
    # gcs_task_manager.h): always-on structured runtime events.
    # Recording is a single ring append per event; disable only to
    # A/B its overhead (the obs-smoke perf test does exactly that).
    "events_enabled": True,
    # Per-process ring capacity; overflow evicts oldest and counts the
    # drop (exported as ray_tpu_torch_flight_recorder_dropped_total).
    "event_buffer_size": 8192,
    # Head-side aggregator retention per job (submitting process).
    "event_retention_per_job": 50_000,
}


class _Config:
    def __init__(self):
        self._values = dict(_DEFAULTS)

    def initialize(self, system_config: Dict[str, Any] | None = None):
        self._values = dict(_DEFAULTS)
        if system_config:
            for k, v in system_config.items():
                if k not in _DEFAULTS:
                    raise ValueError(f"Unknown system config entry: {k}")
                self._values[k] = v
        for k in _DEFAULTS:
            env = os.environ.get(f"RAY_TPU_TORCH_{k}")
            if env is not None:
                default = _DEFAULTS[k]
                if isinstance(default, bool):
                    self._values[k] = env.lower() in ("1", "true", "yes")
                elif isinstance(default, int):
                    self._values[k] = int(env)
                elif isinstance(default, float):
                    self._values[k] = float(env)
                else:
                    self._values[k] = env

    def __getattr__(self, name: str):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name)

    def dump(self) -> str:
        return json.dumps(self._values)


RayConfig = _Config()
RayConfig.initialize()


def temp_root() -> str:
    """The directory the runtime writes under on this host: sessions,
    node daemons' logs, the usage-stats sink and trainers' default
    results. ``RAY_TPU_TORCH_TEMP_DIR`` overrides it; by default it is
    ``ray_tpu_torch`` in the process's temporary directory, so it
    follows ``TMPDIR``."""
    return os.environ.get("RAY_TPU_TORCH_TEMP_DIR") or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch")


def worker_socket(worker_id_hex: str) -> str:
    """The AF_UNIX path of a worker's direct-call listener. In /tmp, not
    the temp root: such a path is limited to about 107 bytes, and the
    name (the full id) is unique per worker. The worker unlinks it on a
    clean exit; the head (for the workers it forks) or the node daemon
    (for its own) unlinks it once a killed worker's process is gone."""
    return f"/tmp/rtpt-w-{worker_id_hex}.sock"


def unlink_worker_socket(path: str) -> None:
    """Removes a dead worker's socket, if it is still there."""
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def session_file() -> str:
    """The file a standalone head (``python -m ray_tpu_torch start
    --head``) writes its address and key to, and ``init(address="auto")``
    reads: ``latest_session.json`` under the temp root. The reference
    keeps its own under its own root, so the two never read each
    other's."""
    return os.path.join(temp_root(), "latest_session.json")
