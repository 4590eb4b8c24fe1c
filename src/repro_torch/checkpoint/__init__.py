"""Atomic, async, device-agnostic checkpoints (counterpart of
``repro.checkpoint``; the on-disk format is the reference's)."""

from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    from_host,
    read_manifest,
    restore_tree,
    save_tree,
    to_host,
)
