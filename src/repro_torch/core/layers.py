"""Parameterized layers over plain parameter dicts (port of repro.core.layers).

Parameters are the reference's pytree leaves as tensors (``{"w": (in, out),
"b": (out,)}``), so they convert one to one. ``dense_sdrop`` is the paper's
plug-in replacement for ``dropout(x) @ W``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import sparse_matmul as sm
from repro_torch.core.sdrop import DropoutState


def uniform_init(generator: torch.Generator, shape, scale: float,
                 dtype=torch.float32, device="cpu") -> torch.Tensor:
    """U(-scale, scale) drawn on the generator's device, then moved."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return ((u * 2.0 - 1.0) * scale).to(device)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` (an embedding lookup). Indexing's gradient
    is an ordered, sort-based accumulation on the card (``index_put_`` with
    accumulate), so a step gives the same bits twice; ``F.embedding``'s
    backward adds by atomics once a lookup has more than 3072 ids."""
    return table[ids.long()]


def init_dense(generator, in_dim, out_dim, *, bias=True, scale=None,
               dtype=torch.float32, device="cpu"):
    if scale is None:
        scale = in_dim ** -0.5
    p = {"w": uniform_init(generator, (in_dim, out_dim), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def dense(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def dense_sdrop(params, x: torch.Tensor, drop: Optional[DropoutState], *,
                x_is_compact: bool = False) -> torch.Tensor:
    """Linear consuming x through (structured) dropout: structured ->
    compacted matmul, random -> mask-multiply then dense, inactive -> dense."""
    b = params.get("b")
    if drop is None or not drop.spec.active or drop.inactive:
        y = x @ params["w"]
        return y + b if b is not None else y
    if drop.structured:
        return sm.sdrop_matmul(x, params["w"], drop.keep_blocks,
                               rate=drop.spec.rate,
                               block_size=drop.spec.block_size,
                               x_is_compact=x_is_compact,
                               impl=drop.spec.impl, bias=b, scale=drop.scale)
    y = drop.apply(x) @ params["w"]
    return y + b if b is not None else y


def dense_sdrop_scheduled(params, x_seq: torch.Tensor, sched) -> torch.Tensor:
    """Time-batched linear over a (T, B, D) sequence consumed through a
    ``MaskSchedule`` (Phase A of the scheduled and fused engines)."""
    b = params.get("b")

    def plain(x):
        y = x @ params["w"]
        return y + b if b is not None else y

    if sched is None or sched.inactive:
        return plain(x_seq)
    if sched.structured:
        return sm.sdrop_matmul_scheduled(x_seq, params["w"],
                                         sched.keep_blocks,
                                         rate=sched.spec.rate,
                                         block_size=sched.spec.block_size,
                                         impl=sched.spec.impl, bias=b,
                                         scale=sched.scale)
    m = sched.dense_mask.expand(x_seq.shape[0], *sched.dense_mask.shape[1:])
    return plain(x_seq * m.to(x_seq.dtype) * sched.scale)
