"""Runtime of the port: serving resilience (``repro.runtime.resilience``
without the serving supervisor, which waits for ROADMAP A10 with
``straggler`` and ``elastic``); training's loop waits for A11."""
from repro_torch.runtime.resilience import (  # noqa: F401
    DeadlineExceeded, Fault, FaultInjector, FaultPlan, QuarantinedError,
    RejectedError, RestartPolicy, RetryPolicy, WorkerCrashed, retry_call)

__all__ = ["Fault", "FaultPlan", "FaultInjector", "RetryPolicy",
           "RestartPolicy", "retry_call", "DeadlineExceeded",
           "RejectedError", "QuarantinedError", "WorkerCrashed"]
