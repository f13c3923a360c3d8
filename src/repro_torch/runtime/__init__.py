"""Runtime of the port: the serving error types of
``repro.runtime.resilience``.  Fault injection, retry, restart and the
serving supervisor wait for ROADMAP A7; training's loop for A11."""
from repro_torch.runtime.resilience import (DeadlineExceeded,  # noqa: F401
                                            QuarantinedError, RejectedError,
                                            WorkerCrashed)

__all__ = ["DeadlineExceeded", "RejectedError", "QuarantinedError",
           "WorkerCrashed"]
