"""Continuous-batching serving of the port (paged mode)."""

from repro_torch.serving.engine import EngineConfig, EngineMetrics, ServingEngine
from repro_torch.serving.request import Request, RequestState, default_detokenizer
from repro_torch.serving.sampling import SamplingParams, greedy_tokens
from repro_torch.serving.scheduler import Scheduler

__all__ = ["EngineConfig", "EngineMetrics", "Request", "RequestState",
           "SamplingParams", "Scheduler", "ServingEngine", "default_detokenizer",
           "greedy_tokens"]
