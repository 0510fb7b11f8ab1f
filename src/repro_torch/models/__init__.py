"""Model stack of the port: layers, attention, blocks and entry points."""

from repro_torch.models.model import (
    decode_step,
    init_cache,
    init_params,
    paged_cache_shapes,
    prefill,
)
from repro_torch.models.weights import params_from_jax

__all__ = ["decode_step", "init_cache", "init_params", "paged_cache_shapes",
           "params_from_jax", "prefill"]
