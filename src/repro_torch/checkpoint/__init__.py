"""Durable checkpoints of the port (twin of ``repro/checkpoint``)."""
from .checkpoint import (
    CheckpointCorruptError,
    CheckpointError,
    CheckpointMismatchError,
    all_steps,
    config_fingerprint,
    latest_step,
    latest_valid_step,
    restore_checkpoint,
    restore_latest_valid,
    save_checkpoint,
    valid_steps,
    verify_checkpoint,
)

__all__ = [
    "CheckpointCorruptError", "CheckpointError", "CheckpointMismatchError",
    "all_steps", "config_fingerprint", "latest_step", "latest_valid_step",
    "restore_checkpoint", "restore_latest_valid", "save_checkpoint",
    "valid_steps", "verify_checkpoint",
]
