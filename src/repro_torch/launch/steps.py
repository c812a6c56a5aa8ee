"""Training-step factory (port of repro.launch.steps.make_train_step).

``make_train_step`` returns ``(params, opt_state, batch, step, seed) ->
(params, opt_state, loss)``: loss and grads through autograd (the
hand-written kernels' backward included), then the optimizer update, in
place and leaf by leaf (``Optimizer.update_``): the returned params and
state are the tensors passed in, updated. PyTorch runs eagerly, so there is
no jit or sharding here.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.configs import adapters
from repro_torch.configs.base import ArchSpec
from repro_torch.optim import tree_leaves, tree_map


def value_and_grad(loss_fn):
    """(params, batch, **kw) -> (loss, grads) with grads in params' tree."""
    def run(params, batch, **kw):
        req = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(req, batch, **kw)
        leaves = torch.autograd.grad(loss, tree_leaves(req))
        it = iter(leaves)
        return loss.detach(), tree_map(lambda _: next(it), req)
    return run


def make_train_step(spec: ArchSpec, cfg, opt: optim.Optimizer, *,
                    use_dropout: bool = True):
    """(params, opt_state, batch, step, seed, **loss_kw) -> (params,
    opt_state, loss); ``loss_kw`` goes to the loss (e.g. ``injected``)."""
    lfn = adapters.loss_fn(spec.kind)
    grad_fn = value_and_grad(lambda p, b, **kw: lfn(p, b, cfg, **kw))

    def train_step(params, opt_state, batch, step, seed, **loss_kw):
        loss, grads = grad_fn(params, batch,
                              seed=seed if use_dropout else None, step=step,
                              **loss_kw)
        with torch.no_grad():
            opt_state = opt.update_(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def default_opt(lr: float = 1e-3) -> optim.Optimizer:
    """clip(1.0) -> AdamW, as the reference trainer builds it."""
    return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(lr))
