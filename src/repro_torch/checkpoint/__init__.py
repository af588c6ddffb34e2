"""Crash-safe, elastic checkpointing in the JAX package's on-disk format
(the port of ``repro.checkpoint``).

:mod:`repro_torch.checkpoint.io` holds the synchronous primitives (atomic
``save`` / ``latest_step`` / ``restore``, and ``restore_into`` for
replicas updated in place); ``CheckpointManager`` adds serialized async
saves with ``wait()`` semantics.
"""
from repro_torch.checkpoint.io import (MANIFEST_SCHEMA_ID, latest_step,
                                       restore, restore_into, save,
                                       validate_manifest)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = [
    "MANIFEST_SCHEMA_ID",
    "CheckpointManager",
    "latest_step",
    "restore",
    "restore_into",
    "save",
    "validate_manifest",
]
