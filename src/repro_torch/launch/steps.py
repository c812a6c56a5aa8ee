"""Training-step factory (port of repro.launch.steps.make_train_step).

``make_train_step`` returns ``(params, opt_state, batch, step, seed) ->
(params, opt_state, loss)``: loss and grads through autograd (the
hand-written kernels' backward included), over ``n_micro`` microbatches
(``optim.gradient_accumulation``), then the optimizer update, in
place and leaf by leaf (``Optimizer.update_``): the returned params and
state are the tensors passed in, updated. PyTorch runs eagerly, so there is
no jit or sharding here.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.configs import adapters
from repro_torch.configs.base import ArchSpec


def make_train_step(spec: ArchSpec, cfg, opt: optim.Optimizer, *,
                    n_micro: int = 1, use_dropout: bool = True):
    """(params, opt_state, batch, step, seed, **loss_kw) -> (params,
    opt_state, loss); ``loss_kw`` goes to the loss (e.g. ``injected``).
    ``n_micro`` > 1 splits the batch into that many microbatches and
    averages their losses and gradients before the one update."""
    lfn = adapters.loss_fn(spec.kind)
    grad_fn = optim.gradient_accumulation(
        lambda p, b, **kw: lfn(p, b, cfg, **kw), n_micro,
        adapters.unused_in_loss(spec.kind, cfg))

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
