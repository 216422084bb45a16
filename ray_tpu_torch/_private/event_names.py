"""Flight-recorder event-name registry: the checked taxonomy.

Every name passed to ``events.record(category, entity, name, attrs)``
and every name the timeline stitcher in ``state.py`` matches against
MUST appear here. raylint's ``event-taxonomy`` rule enforces both
directions statically, so a renamed or fat-fingered event cannot
silently vanish from ``ray_tpu_torch.timeline()`` / the state API — the lint
fails instead of the timeline quietly missing rows.

Standalone by design: no imports, constants only; ``events.py`` and
the tests import it normally.

To add an event: append the name to the right block below, emit it,
and (if the timeline should render it) teach ``state.py`` — the lint
keeps all three in sync from then on.
"""
from __future__ import annotations

#: Recorder categories (mirrors events.py's constants; the string
#: values are the wire/category names, the const names are what call
#: sites reference as ``_events.TASK`` etc.).
CATEGORIES = frozenset(
    {
        "task", "worker", "lease", "object", "transfer", "sched",
        "refs", "chaos", "head",
    }
)
CATEGORY_CONSTS = frozenset(
    {
        "TASK", "WORKER", "LEASE", "OBJECT", "TRANSFER", "SCHED",
        "REFS", "CHAOS", "HEAD",
    }
)

#: category name -> registered event names emitted under it.
EVENTS_BY_CATEGORY = {
    "task": frozenset(
        {
            # Canonical lifecycle transitions + the two span events
            # that carry them (events._SPAN_KEYS).
            "SUBMITTED", "QUEUED", "LEASED", "FORKED", "EXEC_START",
            "EXEC_END", "SEALED", "SUBMIT_SPAN", "EXEC_SPAN",
        }
    ),
    "worker": frozenset(
        {
            "BOOT", "REGISTERED", "SPAWN_REQUESTED", "FORK_REQUESTED",
            "FORKED", "FORK_FAILED",
        }
    ),
    "lease": frozenset({"GRANTED", "RETURNED"}),
    "object": frozenset(
        {
            "SEALED", "SPILLED", "FREED_BATCH", "PUT_BACKPRESSURE",
            # Shared-memory object plane: fire-and-forget put
            # advertisement, get served from the node segment with zero
            # RPCs, and the raylet's dead-client refcount sweep.
            "SHM_PUT_ADVERT", "SHM_GET_LOCAL", "SHM_SWEEP",
        }
    ),
    "transfer": frozenset(
        {
            "PULL", "PULL_RETRY", "PUSH",
            # Same-host pull served by mapping the provider's node
            # segment: one memcpy, zero data bytes over the socket.
            "SHM_PULL",
        }
    ),
    "sched": frozenset({"BLOCKED"}),
    "refs": frozenset(
        {
            "REF_FLUSH", "REF_REFLUSH", "SHARD_ENQUEUE", "SHARD_APPLY",
            "OWNER_FALLBACK", "SPILL_FAIL",
            "PULL_QUEUED", "PULL_ACTIVATE", "PULL_DONE", "PULL_CANCEL",
            # Hedged pulls (straggler layer): an active pull whose
            # throughput fell below the floor re-led onto another
            # holder (the in-flight byte budget is charged once).
            "PULL_RELEAD",
        }
    ),
    "chaos": frozenset(
        {
            # Injected faults + the lock-order witness's finding.
            "FAULT", "KILLED", "NODE_KILL", "LOCK_ORDER",
            # Partition primitive: link-cut window edges (begin on the
            # first blocked frame, heal on the first frame after).
            "PARTITION_BEGIN", "PARTITION_HEAL",
            # Sustained-degradation primitives: token-bucket link
            # throttle window edges and the first stretched execution.
            "THROTTLE_BEGIN", "THROTTLE_HEAL", "SLOWEXEC",
        }
    ),
    "head": frozenset(
        {
            "HEAD_DOWN", "HEAD_RECONNECT", "RECONCILE_BEGIN",
            "RECONCILE_CLAIM", "RECONCILE_END", "GHOSTS_LOST",
            "RESUBMITS_DROPPED",
            # A state read's barrier gave up on a worker whose results
            # the reader holds (gcs._barrier_flush_events).
            "READ_BARRIER_INCOMPLETE",
            # Membership fencing (incarnation/epoch protocol): a stale
            # node/client message rejected, a stale actor-epoch result
            # rejected, and a zombie raylet draining itself after
            # learning it was declared dead.
            "NODE_FENCED", "ACTOR_EPOCH_FENCED", "ZOMBIE_SELF_FENCE",
            # Gray-failure tolerance (straggler layer): per-sweep node
            # score, suspect/quarantine/readmit transitions, and the
            # speculative-execution hedge lifecycle.
            "HEALTH_SCORE", "NODE_SUSPECT", "NODE_QUARANTINE",
            "NODE_READMIT", "HEDGE_LAUNCH", "HEDGE_WIN", "HEDGE_CANCEL",
        }
    ),
}

#: Flat set: every registered recorder event name.
EVENT_NAMES = frozenset().union(*EVENTS_BY_CATEGORY.values())

#: GCS task-table states (gcs.py's task_events store — a separate
#: namespace from the flight recorder, but state.py's timeline matches
#: these literals too, so they are registered alongside).
TASK_TABLE_EVENTS = frozenset(
    {"PENDING", "RUNNING", "FINISHED", "FAILED"}
)


def is_registered(name: str) -> bool:
    return name in EVENT_NAMES


def category_of(name: str):
    """Categories a name is registered under (a name may legitimately
    appear in several, e.g. SEALED in task + object)."""
    return tuple(
        c for c, names in EVENTS_BY_CATEGORY.items() if name in names
    )
