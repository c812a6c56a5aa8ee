"""Optimizers as (init, update_) pairs over parameter trees.

Port of ``repro.optim.optimizers`` (``clip_by_global_norm``, ``sgd``,
``adamw``, ``nt_asgd`` with ``trigger_averaging`` / ``averaged_params``,
``chain``), with the reference's bias correction and eps placement, so the
port's step matches the reference's (``torch.optim.AdamW`` places eps and
weight decay differently) and its learning-rate steps: ``sgd`` calls
``lr(step)`` with the step count before the increment, ``adamw`` and
``nt_asgd`` with the count after it. Trees are nested dicts / lists /
tuples of tensors; moments and averages are kept in float32, step counts
are Python ints.

Unlike the reference's out-of-place ``update`` + ``apply_updates``,
``update_(grads, state, params) -> state`` works in place, leaf by leaf: it
scales ``grads``, moves the moments and adds each leaf's update to
``params`` where they lie, so a step holds parameters, gradients and
moments plus one leaf's temporaries. A caller that needs the parameters
before the step clones them first. Nothing on the host waits for the card.

The clip follows the reference's dtypes: its scale is a float32 scalar,
and JAX promotes ``g * scale`` of a bfloat16 ``g`` to float32, so the
update reads the clipped gradient unrounded. ``chain`` therefore hands a
clip's scale to the next transform, whose leaf update computes ``g.float()
* scale`` as it reads each leaf (for float32 leaves the same bits as
scaling in place first); on its own, ``clip_by_global_norm`` scales the
leaves in place, in their dtypes.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch


class Optimizer(NamedTuple):
    init: Callable
    update_: Callable                       # (grads, state, params[, scale])
    grad_scale: Optional[Callable] = None   # a clip's: grads -> float32 scale


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
        s = scale_of(grads)
        for x in tree_leaves(grads):
            x.mul_(s)
        return state

    return Optimizer(init, update_, scale_of)


def _g32(g, scale):
    """A gradient leaf as the update reads it: float32, times the clip's
    scale where a chain passed one."""
    g = g.float()
    return g if scale is None else g * scale


def sgd(lr) -> Optimizer:
    """lr: float or callable(step) -> rate. State: the step count."""
    def init(params):
        return 0

    def update_(grads, step, params, scale=None):
        rate = lr(step) if callable(lr) else lr
        for g, p in zip(tree_leaves(grads), tree_leaves(params)):
            p.add_((-rate * _g32(g, scale)).to(p.dtype))
        return step + 1

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

    def leaf_(g, m, v, p, rate, c1, c2, scale):
        """Moves m and v in place and returns the leaf's update
        -rate * ((m / c1) / (sqrt(v / c2) + eps) + weight_decay * p)."""
        g = _g32(g, scale)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        u = m / c1
        d = torch.sqrt(v / c2).add_(eps)
        u.div_(d)
        del d
        return u.add_(weight_decay * p.float()).mul_(-rate)

    def update_(grads, state, params, scale=None):
        step, rate, c1, c2 = constants(state)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            p.add_(leaf_(g, m, v, p, rate, c1, c2, scale).to(p.dtype))
        return {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init, update_)


def nt_asgd(lr) -> Optimizer:
    """Non-monotonically-triggered ASGD (AWD-LSTM's optimizer).

    SGD until validation stops improving (the caller then switches the
    averaging on with ``trigger_averaging``), then iterate averaging of the
    parameters after each update. The float32 average lives in the state;
    ``averaged_params`` reads it out."""
    def init(params):
        return {"step": 0, "avg_on": False, "avg_start": 0,
                "avg": tree_map(lambda p: p.detach().float().clone(), params)}

    def update_(grads, state, params, scale=None):
        step = state["step"] + 1
        rate = lr(step) if callable(lr) else lr
        k = float(max(step - state["avg_start"], 1))
        for g, a, p in zip(tree_leaves(grads), tree_leaves(state["avg"]),
                           tree_leaves(params)):
            u = -rate * _g32(g, scale)
            moved = p.float() + u
            if state["avg_on"]:
                a.add_((moved - a) / k)
            else:
                a.copy_(moved)
            p.add_(u.to(p.dtype))
        return {**state, "step": step}

    return Optimizer(init, update_)


def trigger_averaging(state):
    """An ``nt_asgd`` state with averaging on from its current step."""
    return {**state, "avg_on": True, "avg_start": state["step"]}


def averaged_params(state, params):
    """The ``nt_asgd`` average, in the parameters' dtypes."""
    return tree_map(lambda a, p: a.to(p.dtype), state["avg"], params)


def chain(*opts: Optimizer) -> Optimizer:
    """Compose transforms left to right (e.g. clip -> adamw). A clip followed
    by another transform scales nothing in place: its scale goes on to the
    next transform's leaf updates."""
    def init(params):
        return tuple(o.init(params) for o in opts)

    def update_(grads, states, params, scale=None):
        out = []
        for i, (o, s) in enumerate(zip(opts, states)):
            if o.grad_scale is not None and i + 1 < len(opts):
                s_new = o.grad_scale(grads)
                scale = s_new if scale is None else scale * s_new
                out.append(s)
            else:
                kw = {} if scale is None else {"scale": scale}
                out.append(o.update_(grads, s, params, **kw))
        return tuple(out)

    return Optimizer(init, update_)
