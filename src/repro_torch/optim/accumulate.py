"""Loss and gradients through autograd, and gradient accumulation over
microbatches (port of repro.optim.accumulate).

``gradient_accumulation(loss_fn, n_micro)`` splits the leading batch dim of
every batch tensor into ``n_micro`` slices, in order, runs loss and
gradients on each and sums loss / n and float32 grads / n in that order, as
the reference's scan does; every microbatch gets the same keyword
arguments (``seed``, ``step``), as the reference passes one dropout key to
each. Activations shrink ~n_micro-fold; the optimizer update runs once.
"""
from __future__ import annotations

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map


def _paths(tree, pre=""):
    """The leaves' paths ("blocks/wk"), in ``tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{pre}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree) for p in _paths(x, f"{pre}{i}/")]
    return [pre[:-1]]


def value_and_grad(loss_fn, unused=()):
    """(params, batch, **kw) -> (loss, grads) with grads in params' tree.
    The subtrees whose paths ("enc_blocks", "blocks/wk") ``unused`` names
    may go unread by the loss (the encoder of the reference's
    encoder-decoder, whose training loss does not depend on it): their
    unread leaves get zeros, as JAX's grad gives them. Any other leaf the
    loss does not read raises."""
    def run(params, batch, **kw):
        req = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(req, batch, **kw)
        leaves = tree_leaves(req)
        grads = torch.autograd.grad(loss, leaves, allow_unused=bool(unused))
        if unused:
            bad = [p for p, g in zip(_paths(req), grads) if g is None and not any(
                p == u or p.startswith(u + "/") for u in unused)]
            if bad:
                raise RuntimeError(f"the loss does not read {bad}, and only "
                                   f"{sorted(unused)} may go unread")
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), req)
    return run


def gradient_accumulation(loss_fn, n_micro: int, unused=()):
    """loss_fn(params, batch, **kw) -> scalar. Returns a (loss, grads) fn;
    ``unused`` as ``value_and_grad``'s."""
    simple = value_and_grad(loss_fn, unused)
    if n_micro <= 1:
        return simple

    def accumulated(params, batch, **kw):
        for k, x in batch.items():
            if x.shape[0] % n_micro:
                raise ValueError(f"batch[{k!r}] has {x.shape[0]} rows, not a "
                                 f"multiple of n_micro={n_micro}")
        loss_acc, grad_acc = None, None
        for i in range(n_micro):
            mb = {k: x.reshape(n_micro, x.shape[0] // n_micro,
                               *x.shape[1:])[i] for k, x in batch.items()}
            loss, grads = simple(params, mb, **kw)
            if grad_acc is None:
                loss_acc = torch.zeros((), dtype=torch.float32,
                                       device=loss.device)
                grad_acc = tree_map(lambda g: torch.zeros(
                    g.shape, dtype=torch.float32, device=g.device), grads)
            loss_acc = loss_acc + loss / n_micro
            for a, g in zip(tree_leaves(grad_acc), tree_leaves(grads)):
                a.add_(g.float() / n_micro)
        return loss_acc, grad_acc

    return accumulated
