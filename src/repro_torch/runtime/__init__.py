"""Runtime of the port: the sharding rules (``runtime.sharding``), the
collectives over ``torch.distributed`` (``runtime.collectives``) and fault
tolerance."""

from repro_torch.runtime.fault_tolerance import (
    ElasticPlan,
    StragglerMonitor,
    WorkerFailure,
    run_with_restart,
)

__all__ = ["ElasticPlan", "StragglerMonitor", "WorkerFailure", "run_with_restart"]
