"""Runtime of the port: the sharding rules (``runtime.sharding``), the
collectives over ``torch.distributed`` (``runtime.collectives``) and fault
tolerance."""

from repro_torch.runtime.sharding import (
    batch_pspec,
    cache_specs,
    data_axes,
    opt_state_specs,
    param_specs,
)
from repro_torch.runtime.fault_tolerance import (
    ElasticPlan,
    StragglerMonitor,
    WorkerFailure,
    run_with_restart,
)

__all__ = ["ElasticPlan", "StragglerMonitor", "WorkerFailure", "batch_pspec", "cache_specs",
           "data_axes", "opt_state_specs", "param_specs", "run_with_restart"]
