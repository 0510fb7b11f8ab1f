"""Checkpoints of the port in the reference's on-disk format."""

from repro_torch.checkpoint.checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
