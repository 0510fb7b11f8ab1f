"""Optimizers of the port: AdamW, SGD, schedules and clipping."""

from repro_torch.optim.optimizers import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    make_schedule,
    sgd_init,
    sgd_update,
)

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm", "global_norm",
           "make_schedule", "sgd_init", "sgd_update"]
