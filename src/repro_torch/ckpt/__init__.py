"""Checkpointing: npz snapshots, atomic, restorable by either package.

The counterpart of ``repro.ckpt`` over the port's trees of tensors.
"""
from .manager import CheckpointManager, restore_latest, save_checkpoint

__all__ = ["CheckpointManager", "restore_latest", "save_checkpoint"]
