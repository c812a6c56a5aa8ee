"""Optimizers (port of repro.optim's update rules)."""
from repro_torch.optim.optimizers import (OptState, Optimizer, adamw, chain,
                                          clip_by_global_norm, global_norm,
                                          tree_leaves, tree_map)

__all__ = ["OptState", "Optimizer", "adamw", "chain",
           "clip_by_global_norm", "global_norm", "tree_leaves", "tree_map"]
