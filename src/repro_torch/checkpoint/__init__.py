"""Fault-tolerant checkpoints in the reference's on-disk format, on one
process or across the ranks of a run."""
from repro_torch.checkpoint.checkpoint import (latest_steps, read_manifest,
                                               restore, save, save_async,
                                               wait_pending)

__all__ = ["latest_steps", "read_manifest", "restore", "save", "save_async",
           "wait_pending"]
