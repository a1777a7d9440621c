"""Checkpoints in the reference's on-disk layout."""

from .checkpoint import async_save, latest_step, load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "async_save"]
