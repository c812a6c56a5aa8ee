"""Optimizers as (init, update) pairs over parameter trees.

Port of ``repro.optim.optimizers``: ``update(grads, state, params) ->
(updates, state)`` followed by ``apply_updates``, with the reference's bias
correction and eps placement, so the port's update matches the reference's
(``torch.optim.AdamW`` places eps and weight decay differently). Trees are
nested dicts / lists / tuples of tensors; moments are kept in float32.
Updates are computed out of place; nothing on the host waits for the card.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


OptState = Any


def tree_map(fn, tree, *rest):
    """Map ``fn`` over matching leaves of dict/list/tuple trees (dict keys
    in sorted order, as JAX flattens them); a None subtree stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        g = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
        return tree_map(lambda x: x * scale, grads), state

    return Optimizer(init, update)


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": 0}

    def update(grads, state, params):
        step = state["step"] + 1
        rate = lr(step) if callable(lr) else lr
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        # bias corrections rounded to float32, as the reference computes them
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
        upd = tree_map(
            lambda m, v, p: -rate * ((m / c1) / (torch.sqrt(v / c2) + eps)
                                     + weight_decay * p.float()),
            m, v, params)
        return upd, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


def chain(*opts: Optimizer) -> Optimizer:
    """Compose transforms left to right (e.g. clip -> adamw)."""
    def init(params):
        return tuple(o.init(params) for o in opts)

    def update(grads, states, params):
        new_states = []
        for o, s in zip(opts, states):
            grads, s = o.update(grads, s, params)
            new_states.append(s)
        return grads, tuple(new_states)

    return Optimizer(init, update)
