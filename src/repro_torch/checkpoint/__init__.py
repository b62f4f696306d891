"""Checkpoints in the reference's on-disk format (``store``)."""
from repro_torch.checkpoint.store import (  # noqa: F401
    checkpoint_metadata, latest_step, restore_checkpoint, save_checkpoint,
)
