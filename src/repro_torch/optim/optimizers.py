"""Optimizers as (init, update_) pairs over parameter trees.

Port of ``repro.optim.optimizers``, with the reference's bias correction and
eps placement, so the port's step matches the reference's
(``torch.optim.AdamW`` places eps and weight decay differently). Trees are
nested dicts / lists / tuples of tensors; moments are kept in float32.

Unlike the reference's out-of-place ``update`` + ``apply_updates``,
``update_(grads, state, params) -> state`` works in place, leaf by leaf: it
scales ``grads``, moves the moments and adds each leaf's update to
``params`` where they lie, so a step holds parameters, gradients and
moments plus one leaf's temporaries. A caller that needs the parameters
before the step clones them first. Nothing on the host waits for the card.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class Optimizer(NamedTuple):
    init: Callable
    update_: Callable


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


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def init(params):
        return ()

    def scale_of(grads):
        g = global_norm(grads)
        return torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)

    def update_(grads, state, params=None):
        scale = scale_of(grads)
        for x in tree_leaves(grads):
            x.mul_(scale)
        return state

    return Optimizer(init, update_)


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": 0}

    def constants(state):
        step = state["step"] + 1
        rate = lr(step) if callable(lr) else lr
        # bias corrections rounded to float32, as the reference computes them
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
        return step, rate, c1, c2

    def leaf_(g, m, v, p, rate, c1, c2):
        """Moves m and v in place and returns the leaf's update
        -rate * ((m / c1) / (sqrt(v / c2) + eps) + weight_decay * p)."""
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        u = m / c1
        d = torch.sqrt(v / c2).add_(eps)
        u.div_(d)
        del d
        return u.add_(weight_decay * p.float()).mul_(-rate)

    def update_(grads, state, params):
        step, rate, c1, c2 = constants(state)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            p.add_(leaf_(g, m, v, p, rate, c1, c2).to(p.dtype))
        return {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init, update_)


def chain(*opts: Optimizer) -> Optimizer:
    """Compose transforms left to right (e.g. clip -> adamw)."""
    def init(params):
        return tuple(o.init(params) for o in opts)

    def update_(grads, states, params):
        return tuple(o.update_(grads, s, params) for o, s in zip(opts, states))

    return Optimizer(init, update_)
