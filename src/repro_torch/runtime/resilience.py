"""The serving error types of ``repro.runtime.resilience``: what a
future or a generation handle of the port's servers resolves to when a
request is shed, expires or outlives its worker.

``FaultPlan``, ``FaultInjector``, ``RetryPolicy``, ``RestartPolicy``,
``retry_call`` and ``ServingSupervisor`` wait for ROADMAP A7; until
then ``AsyncWorkerLoop.configure_resilience`` refuses them.
"""
from __future__ import annotations

__all__ = ["WorkerCrashed", "DeadlineExceeded", "RejectedError",
           "QuarantinedError"]


class WorkerCrashed(RuntimeError):
    """Handed to every live future/handle when a serving worker thread
    died and the restart budget (if any) is exhausted — the guarantee
    that ``result()`` never hangs on a dead loop."""


class DeadlineExceeded(TimeoutError):
    """A request's deadline passed before it was dispatched (or, for a
    streaming generation, before it finished)."""


class RejectedError(RuntimeError):
    """Admission rejected: the bounded queue is full.  ``retry_after_s``
    is the server's hint for when capacity is likely to free up."""

    def __init__(self, msg: str, *, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class QuarantinedError(RuntimeError):
    """A work unit failed transiently more times than the retry budget
    allows and is quarantined: consumed, recorded, never requeued.
    ``attempts`` counts executions including the first; the last
    failure is chained as ``__cause__``."""

    def __init__(self, msg: str, *, attempts: int):
        super().__init__(msg)
        self.attempts = attempts
