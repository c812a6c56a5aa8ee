"""Learning-rate schedules (port of repro.optim.schedules): each returns
``f(step) -> rate`` for an int step or a 0-d integer tensor, computed in
float32 as the reference's ``jnp`` arithmetic (``constant`` returns its
float)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def constant(lr: float):
    return lambda step: lr


def step_decay(lr: float, decay: float, every: int, start: int = 0):
    """Zaremba'14: constant for ``start`` epochs, then a factor ``decay``
    every ``every`` steps."""
    def f(step):
        k = torch.clamp(_step(step) - start, min=0) // every
        return lr * decay ** k
    return f


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_step(step) / total_steps, 0.0, 1.0)
        return lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + torch.cos(math.pi * t)))
    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine(lr, total_steps - warmup, final_frac)

    def f(step):
        s = _step(step)
        return torch.where(s < warmup, lr * s / max(warmup, 1), cos(s - warmup))
    return f
