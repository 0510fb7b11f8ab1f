"""Checkpoints of the port in the reference's on-disk format."""

from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint", "save_checkpoint"]
