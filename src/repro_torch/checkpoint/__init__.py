"""Checkpoints of the train state and their rotating, asynchronous
manager. Port of ``repro.checkpoint``, with its on-disk layout."""

from .checkpointer import (
    latest_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
)
from .manager import CheckpointManager

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step", "list_steps"]
