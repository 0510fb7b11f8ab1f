"""Fault tolerance of the port (sharding and collectives: ROADMAP queue 1,
item 10)."""

from repro_torch.runtime.fault_tolerance import (
    ElasticPlan,
    StragglerMonitor,
    WorkerFailure,
    run_with_restart,
)

__all__ = ["ElasticPlan", "StragglerMonitor", "WorkerFailure", "run_with_restart"]
