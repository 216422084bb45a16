"""Owner-sharded object plane.

Reference: the ownership model of the reference's core worker —
``reference_count.h`` (each object's *owner*, the process that created
it, keeps the authoritative reference state: local instance counts plus
the set of remote borrowers) and
``ownership_based_object_directory.h`` (the directory is keyed by
object id and consulted per object, not serialized through one global
table lock).

Two cooperating pieces replace the centralized per-object bookkeeping
that previously rode the head's single dispatch loop:

- :mod:`.owner_refs` — owner-side reference counting in every client
  process. Local 0<->1 instance transitions for objects this process
  owns never cross the wire at all; only *ownership-edge* transitions
  (the owner's authoritative count draining to zero, borrow edges
  opening/closing, owner death) are batched to the head.

- :mod:`.pull_manager` — admission control over the transfer plane
  (``pull_manager.h``): pulls queue by priority class (get > wait >
  task-args) and activate under a bounded in-flight byte budget, so a
  bulk broadcast cannot starve concurrent gets.

- :mod:`.directory` — the head's object table sharded N ways, each
  shard with its own lock domain and flush queue. The dispatch loop
  only enqueues refcount batches; per-shard applier threads mutate
  holder state and nominate free candidates off the dispatch path.

Ownerless objects (refs constructed without an owner, stream items,
promoted entries after owner death) fall back to head-side holder
sets, preserving the pre-plane semantics exactly.
"""
from . import directory, owner_refs, pull_manager  # noqa: F401
