"""Continuous-batching serving of the port (slot and paged modes)."""

from repro_torch.serving.engine import EngineConfig, EngineMetrics, ServingEngine
from repro_torch.serving.request import Request, RequestState, default_detokenizer
from repro_torch.serving.sampling import SamplingParams, greedy_tokens
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.slots import SlotCache

__all__ = ["EngineConfig", "EngineMetrics", "Request", "RequestState",
           "SamplingParams", "Scheduler", "ServingEngine", "SlotCache", "default_detokenizer",
           "greedy_tokens"]
