"""Runtime of the port (``repro.runtime``): the fault-tolerant training
loop, straggler detection, elastic mesh management, and serving
resilience with the serving supervisor."""
from repro_torch.runtime.elastic import ElasticMeshManager, HostSet  # noqa: F401
from repro_torch.runtime.loop import TrainLoop, TrainLoopConfig  # noqa: F401
from repro_torch.runtime.resilience import (  # noqa: F401
    DeadlineExceeded, Fault, FaultInjector, FaultPlan, QuarantinedError,
    RejectedError, RestartPolicy, RetryPolicy, ServingSupervisor,
    WorkerCrashed, retry_call)
from repro_torch.runtime.straggler import (StragglerConfig,  # noqa: F401
                                           StragglerMonitor)

__all__ = ["TrainLoop", "TrainLoopConfig", "StragglerConfig",
           "StragglerMonitor", "ElasticMeshManager", "HostSet",
           "Fault", "FaultPlan", "FaultInjector", "RetryPolicy",
           "RestartPolicy", "ServingSupervisor", "retry_call",
           "DeadlineExceeded", "RejectedError", "QuarantinedError",
           "WorkerCrashed"]
