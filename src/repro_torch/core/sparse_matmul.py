"""Structured-dropout-aware matmuls (paper §3.2, Fig. 2), in PyTorch.

Port of ``repro.core.sparse_matmul``. The three phases of a
``dropout(x) @ w`` under a structured mask all run compacted:

  FP  — y  = (x ⊙ m) @ W        → only the kept rows of W
  BP  — δx = (δy @ Wᵀ) ⊙ m      → only the kept columns of δx
  WG  — δW = (x ⊙ m)ᵀ @ δy      → only the kept rows of δW

Each ``custom_vjp`` of the reference is a ``torch.autograd.Function`` here.
``impl="pallas"`` routes FP/BP through the hand-written gather-matmul
kernels (kernels/gather_matmul.py: K1 for one mask, K2 for a (T, nk)
table); ``impl="xla"`` is plain torch. WG stays plain torch in both, as the
reference does it outside Pallas: a compact product, scattered (or, for a
per-step table, ``index_add_``-ed) into the kept rows of δW. Residuals are
stored compact (B x k, not B x H).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import masks as _masks
from repro_torch.core.sdrop import scale_as
from repro_torch.kernels import gather_matmul as _gm


def _unit_ids(keep_blocks: torch.Tensor, block_size: int) -> torch.Tensor:
    return _masks.keep_blocks_to_unit_ids(keep_blocks, block_size).long()


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def _wg(a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """scale * (a @ b) (batched for 3-D operands), the float32 sums scaled
    before their one rounding (``addmm``'s alpha), as the reference scales
    its float32 product and then casts."""
    mm = torch.baddbmm if a.dim() == 3 else torch.addmm
    return mm(a.new_zeros(()), a, b, beta=0, alpha=scale)


# ---------------------------------------------------------------------------
# direction="in": y = scale * (x ⊙ mask) @ w, via compaction.
# ---------------------------------------------------------------------------


class _SdropMatmulIn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, keep_blocks, scale, block_size, x_is_compact, impl):
        ids = _unit_ids(keep_blocks, block_size)
        x_c = x if x_is_compact else x.index_select(-1, ids)
        if impl == "pallas":
            y = _gm.gather_matmul(_flat(x_c).contiguous(), w, keep_blocks,
                                  block_size=block_size, a_is_compact=True,
                                  alpha=scale)
            y = y.reshape(*x.shape[:-1], w.shape[-1])
        else:
            y = x_c @ w[ids]
            y = y * scale_as(scale, y.dtype)
        ctx.save_for_backward(x_c, w, keep_blocks)
        ctx.cfg = (scale, block_size, x_is_compact, impl, x.shape[-1])
        return y

    @staticmethod
    def backward(ctx, dy):
        x_c, w, keep_blocks = ctx.saved_tensors
        scale, block_size, x_is_compact, impl, in_dim = ctx.cfg
        ids = _unit_ids(keep_blocks, block_size)
        dy2 = _flat(dy).contiguous()
        # BP (output sparsity): only the kept columns of δx are computed.
        if impl == "pallas":
            dx_c = _gm.gather_matmul(dy2, w, keep_blocks,
                                     block_size=block_size,
                                     a_is_compact=True, transpose_b=True,
                                     alpha=scale)
            dx_c = dx_c.reshape(*dy.shape[:-1], x_c.shape[-1])
        else:
            dx_c = dy @ w[ids].t()
            dx_c = dx_c * scale_as(scale, dx_c.dtype)
        if x_is_compact:
            dx = dx_c
        else:
            dx = dy.new_zeros((*dy.shape[:-1], in_dim)).index_copy_(
                dy.ndim - 1, ids, dx_c)
        # WG (row sparsity): a compact (k, N) product into the kept rows.
        dw_c = _wg(_flat(x_c).t(), dy2, scale)
        dw = torch.zeros_like(w).index_copy_(0, ids, dw_c)
        return dx, dw, None, None, None, None, None


# ---------------------------------------------------------------------------
# scheduled: x (T, B, D) with a (T, nk) ids table, step t its own mask.
#   "pallas": K2 FP/BP at compact FLOPs, x compacted per step first;
#   "xla":    one masked-dense (T·B, D) @ (D, N) product.
# ---------------------------------------------------------------------------


class _SdropMatmulSched(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, kb_table, scale, block_size, impl):
        ctx.cfg = (scale, block_size, impl)
        if impl == "pallas":
            ids = _unit_ids(kb_table, block_size)              # (T, k)
            T, B, _ = x.shape
            x_c = torch.gather(x, 2, ids[:, None, :].expand(T, B, ids.shape[1]))
            y = _gm.gather_matmul_stepped(x_c.contiguous(), w, kb_table,
                                          block_size=block_size,
                                          a_is_compact=True, alpha=scale)
            ctx.save_for_backward(x_c, w, kb_table)
            return y
        m = _masks.keep_blocks_to_mask(kb_table, x.shape[-1], block_size)  # (T, D)
        xm = x * m[:, None, :].to(x.dtype) * scale_as(scale, x.dtype)
        ctx.save_for_backward(xm, w, kb_table)
        return xm @ w

    @staticmethod
    def backward(ctx, dy):
        scale, block_size, impl = ctx.cfg
        dy = dy.contiguous()
        if impl == "pallas":
            x_c, w, kb_table = ctx.saved_tensors
            ids = _unit_ids(kb_table, block_size)
            T, B, k = x_c.shape
            # BP: only each step's kept columns of δx.
            dx_c = _gm.gather_matmul_stepped(dy, w, kb_table,
                                             block_size=block_size,
                                             transpose_b=True, alpha=scale)
            dx = dy.new_zeros((T, B, w.shape[0])).scatter_(
                2, ids[:, None, :].expand(T, B, k), dx_c)
            # WG: per-step compact (k, N) products summed into the kept
            # rows (rows kept at several steps accumulate; on CUDA the
            # index_add_ order is not deterministic).
            dw_c = _wg(x_c.transpose(1, 2), dy, scale)             # (T, k, N)
            dw = torch.zeros_like(w).index_add_(
                0, ids.reshape(-1), dw_c.reshape(T * k, -1))
            return dx, dw, None, None, None, None
        xm, w, kb_table = ctx.saved_tensors
        m = _masks.keep_blocks_to_mask(kb_table, w.shape[0], block_size)
        dx = (dy @ w.t()) * m[:, None, :].to(dy.dtype) * scale_as(scale, dy.dtype)
        dw = _flat(xm).t() @ _flat(dy)
        return dx, dw, None, None, None, None


# ---------------------------------------------------------------------------
# direction="out": y_c = scale * (x @ w)[:, kept] (compact output).
# ---------------------------------------------------------------------------


class _SdropMatmulOut(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, keep_blocks, scale, block_size, impl):
        ids = _unit_ids(keep_blocks, block_size)
        if impl == "pallas":
            y_c = _gm.gather_matmul(_flat(x).contiguous(), w, keep_blocks,
                                    block_size=block_size, gather="b_cols",
                                    alpha=scale)
            y_c = y_c.reshape(*x.shape[:-1], y_c.shape[-1])
        else:
            y_c = x @ w[:, ids]
            y_c = y_c * scale_as(scale, y_c.dtype)
        ctx.save_for_backward(x, w, keep_blocks)
        ctx.cfg = (scale, block_size)
        return y_c

    @staticmethod
    def backward(ctx, dy_c):
        x, w, keep_blocks = ctx.saved_tensors
        scale, block_size = ctx.cfg
        ids = _unit_ids(keep_blocks, block_size)
        w_c = w[:, ids]
        dx = (dy_c @ w_c.t()) * scale_as(scale, dy_c.dtype)
        dw_c = _wg(_flat(x).t(), _flat(dy_c), scale)
        dw = torch.zeros_like(w).index_copy_(1, ids, dw_c)
        return dx, dw, None, None, None, None


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def sdrop_matmul(x: torch.Tensor, w: torch.Tensor,
                 keep_blocks: Optional[torch.Tensor], *, rate: float,
                 block_size: int = 1, x_is_compact: bool = False,
                 impl: str = "xla", bias: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """``dropout(x) @ w (+ bias)`` with structured-sparsity reclamation;
    ``keep_blocks=None`` or ``rate=0`` is a dense matmul."""
    if keep_blocks is None or rate <= 0.0:
        y = x @ w
    else:
        if scale is None:
            scale = _masks.inverted_scale(rate, w.shape[0], block_size)
        y = _SdropMatmulIn.apply(x, w, keep_blocks, float(scale),
                                 int(block_size), bool(x_is_compact), impl)
    if bias is not None:
        y = y + bias
    return y


def sdrop_matmul_scheduled(x: torch.Tensor, w: torch.Tensor,
                           keep_blocks: Optional[torch.Tensor], *,
                           rate: float, block_size: int = 1,
                           impl: str = "xla",
                           bias: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Time-batched ``dropout(x_t) @ w`` for a (T, nk) schedule; a (1, nk)
    FIXED table delegates to ``sdrop_matmul`` (one shared compaction)."""
    if keep_blocks is None or rate <= 0.0:
        y = x @ w
    else:
        if scale is None:
            scale = _masks.inverted_scale(rate, w.shape[0], block_size)
        if keep_blocks.ndim != 2:
            raise ValueError(f"scheduled keep_blocks must be (T, nk), got "
                             f"{tuple(keep_blocks.shape)}")
        if keep_blocks.shape[0] == 1:
            return sdrop_matmul(x, w, keep_blocks[0], rate=rate,
                                block_size=block_size, impl=impl, bias=bias,
                                scale=scale)
        y = _SdropMatmulSched.apply(x, w, keep_blocks, float(scale),
                                    int(block_size), impl)
    if bias is not None:
        y = y + bias
    return y


def sdrop_matmul_out(x: torch.Tensor, w: torch.Tensor,
                     keep_blocks: Optional[torch.Tensor], *, rate: float,
                     block_size: int = 1, impl: str = "xla",
                     bias: Optional[torch.Tensor] = None,
                     scale: float = 1.0) -> torch.Tensor:
    """Only the kept output columns of ``x @ w`` (compact result)."""
    if keep_blocks is None or rate <= 0.0:
        y = x @ w
        return y + bias if bias is not None else y
    y = _SdropMatmulOut.apply(x, w, keep_blocks, float(scale),
                              int(block_size), impl)
    if bias is not None:
        y = y + bias[_unit_ids(keep_blocks, block_size)]
    return y
