"""Continuous-batching serving of the port (slot and paged modes)."""

from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.policies import (
    BucketBatchedAdmission,
    BudgetOrEOSEviction,
    DeadlineAdmission,
    DeadlinePreemption,
    EnginePolicies,
    FIFOAdmission,
    NeverDefrag,
    NoPrefixReuse,
    PrefixAwareAdmission,
    PriorityAdmission,
    SharedPrefix,
    ThresholdDefrag,
)
from repro_torch.serving.request import Request, RequestCost, RequestState, default_detokenizer
from repro_torch.serving.sampling import (
    SamplingParams,
    greedy_tokens,
    request_key,
    sample_tokens,
)
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.slots import SlotCache

__all__ = ["BucketBatchedAdmission", "BudgetOrEOSEviction", "DeadlineAdmission",
           "DeadlinePreemption", "EngineConfig", "EngineMetrics", "EnginePolicies",
           "FIFOAdmission", "NeverDefrag", "NoPrefixReuse", "PrefixAwareAdmission",
           "PriorityAdmission", "Request", "RequestCost", "RequestState", "SamplingParams",
           "Scheduler", "ServingEngine", "SharedPrefix", "SlotCache", "ThresholdDefrag",
           "default_detokenizer", "greedy_tokens", "request_key", "sample_tokens"]
