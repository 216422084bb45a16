"""Exception taxonomy (reference: python/ray/exceptions.py)."""
from __future__ import annotations

import traceback as _tb
from typing import Optional


class RayTpuError(Exception):
    """Base class for ray_tpu_torch errors."""


class RayTaskError(RayTpuError):
    """A task raised; re-raised at ``get`` with the remote traceback.

    Reference: exceptions.py RayTaskError — wraps the user exception and
    carries the remote stack so the driver sees where it failed.
    """

    def __init__(
        self,
        function_name: str,
        traceback_str: str,
        cause: Optional[BaseException] = None,
    ):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"{function_name} failed:\n{traceback_str}")

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException) -> "RayTaskError":
        return cls(function_name, "".join(_tb.format_exception(exc)), exc)

    def __reduce__(self):
        # The cause may not survive pickling (custom unpicklable exception);
        # degrade to traceback-only rather than fail the error report.
        import pickle

        cause = self.cause
        try:
            pickle.dumps(cause)
        except Exception:
            cause = None
        return (RayTaskError, (self.function_name, self.traceback_str, cause))

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is also an instance of the cause's type,
        so ``except UserError`` works across the task boundary."""
        if self.cause is None:
            return self
        cause_cls = type(self.cause)
        if issubclass(cause_cls, RayTaskError):
            return self
        try:
            derived = type(
                "RayTaskError(" + cause_cls.__name__ + ")",
                (RayTaskError, cause_cls),
                {},
            )
            instance = derived(self.function_name, self.traceback_str, self.cause)
            return instance
        except TypeError:
            return self


class RayActorError(RayTpuError):
    """The actor died before or during this method call
    (reference: exceptions.py:287)."""

    def __init__(self, actor_id=None, reason: str = "actor died"):
        self.actor_id = actor_id
        super().__init__(f"Actor {actor_id} unavailable: {reason}")


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    """The actor is temporarily unreachable (reference:
    exceptions.py ActorUnavailableError); the call may be retried."""


class ActorUnschedulableError(RayTpuError):
    pass


class BackPressureError(RayTpuError):
    """Too many queued requests (reference: serve
    BackPressureError) — the caller should shed load or retry later."""


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get`` timed out before the object was available."""


class ObjectLostError(RayTpuError):
    """All copies of the object are gone and it cannot be reconstructed
    (reference: exceptions.py:511)."""

    def __init__(self, object_id=None):
        self.object_id = object_id
        super().__init__(f"Object {object_id} lost")


class OutOfMemoryError(RayTpuError):
    """Task/actor killed by the memory monitor (reference: exceptions.py:483)."""


class TaskCancelledError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupSchedulingError(RayTpuError):
    pass


class TaskUnschedulableError(RayTpuError):
    """The task can never be scheduled (e.g. a hard NodeAffinity target
    that left the cluster). Reference: exceptions.py
    TaskUnschedulableError."""
