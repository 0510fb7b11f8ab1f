"""Continuous-batching serving of the port (slot and paged modes)."""

from repro_torch.paging import PagedCache, PageManager
from repro_torch.prefix import PrefixCache, PrefixTree
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.policies import (
    AdmissionPolicy,
    BucketBatchedAdmission,
    BudgetOrEOSEviction,
    DeadlineAdmission,
    DeadlinePreemption,
    DefragPolicy,
    EnginePolicies,
    EvictionPolicy,
    FIFOAdmission,
    NeverDefrag,
    NoPrefixReuse,
    PrefixAwareAdmission,
    PrefixPolicy,
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
from repro_torch.serving.scheduler import FIFOScheduler, Scheduler
from repro_torch.serving.slots import SlotCache

__all__ = [
    "AdmissionPolicy",
    "BucketBatchedAdmission",
    "BudgetOrEOSEviction",
    "DeadlineAdmission",
    "DeadlinePreemption",
    "DefragPolicy",
    "EngineConfig",
    "EngineMetrics",
    "EnginePolicies",
    "EvictionPolicy",
    "FIFOAdmission",
    "FIFOScheduler",
    "NeverDefrag",
    "NoPrefixReuse",
    "PageManager",
    "PagedCache",
    "PrefixAwareAdmission",
    "PrefixCache",
    "PrefixPolicy",
    "PrefixTree",
    "PriorityAdmission",
    "Request",
    "RequestCost",
    "RequestState",
    "SamplingParams",
    "Scheduler",
    "ServingEngine",
    "SharedPrefix",
    "SlotCache",
    "ThresholdDefrag",
    "default_detokenizer",
    "greedy_tokens",
    "request_key",
    "sample_tokens",
]
