"""Model stack of the port: layers, attention, blocks and entry points."""

from repro_torch.models.model import (
    decode_step,
    forward,
    init_cache,
    init_params,
    lm_loss,
    paged_cache_shapes,
    prefill,
    verify_step,
)
from repro_torch.models.weights import opt_state_from_jax, params_from_jax

__all__ = ["decode_step", "forward", "init_cache", "init_params", "lm_loss", "opt_state_from_jax",
           "paged_cache_shapes", "params_from_jax", "prefill", "verify_step"]
