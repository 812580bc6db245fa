"""Atomic, asynchronous checkpoints of nested dict/list trees of tensors
(counterpart of ``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (Stacked, latest_step, leaves,
                                               restore, restore_into, save)

__all__ = ["Stacked", "latest_step", "leaves", "restore", "restore_into",
           "save"]
