"""Atomic checkpoints of tensor trees, in the JAX package's disk format
(mirrors ``repro.checkpoint``)."""

from .checkpoint import (  # noqa: F401
    save_checkpoint, restore_checkpoint, latest_step, AsyncCheckpointer,
)
