"""Checkpoints (port of ``repro/checkpoint``): the reference's on-disk
format, written and read with torch and numpy, and the manager that
rotates, retries and auto-resumes."""
from repro_torch.checkpoint.store import (  # noqa: F401
    CorruptCheckpointError, load_tree, save_tree,
)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
