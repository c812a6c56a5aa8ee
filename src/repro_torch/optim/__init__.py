"""Optimizers, learning-rate schedules and gradient accumulation (port of
repro.optim's update rules, ``schedules`` and ``accumulate``)."""
from repro_torch.optim import schedules
from repro_torch.optim.accumulate import gradient_accumulation, value_and_grad
from repro_torch.optim.optimizers import (OptState, Optimizer, adamw,
                                          averaged_params, chain,
                                          clip_by_global_norm, global_norm,
                                          nt_asgd, sgd, tree_leaves, tree_map,
                                          trigger_averaging)

__all__ = ["OptState", "Optimizer", "adamw", "averaged_params", "chain",
           "clip_by_global_norm", "global_norm", "gradient_accumulation",
           "nt_asgd", "schedules", "sgd", "tree_leaves", "tree_map",
           "trigger_averaging", "value_and_grad"]
