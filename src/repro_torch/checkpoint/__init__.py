"""Checkpoints of the port (counterpart of ``repro.checkpoint``)."""
from .manager import CheckpointManager, load_latest, save_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "load_latest"]
