"""Checkpoints (port of repro.checkpoint)."""
from repro_torch.checkpoint.store import (PreemptionHook, latest_step,
                                          restore_checkpoint, save_checkpoint)

__all__ = ["PreemptionHook", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
