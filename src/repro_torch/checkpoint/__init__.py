"""Checkpoints of the port: durable atomic saves, loads validated against a
template, retention, and a background writer (counterpart of
``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import (latest_step, load_checkpoint,
                                         save_checkpoint, sweep_orphans)
from repro_torch.checkpoint.manager import (AsyncCheckpointer,
                                            CheckpointManager)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "sweep_orphans", "CheckpointManager", "AsyncCheckpointer"]
