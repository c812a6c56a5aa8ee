"""Cell-parametric fused recurrence (the engine="fused" core), in PyTorch.

Port of ``repro.kernels.cell_scan``. A ``CellSpec`` supplies one cell's
pointwise math (``pointwise_fwd``/``pointwise_bwd``) and, optionally, the
CUDA launches of its fused persistent-scan kernels (``kernel_fwd`` /
``kernel_bwd``; the LSTM's live in kernels/lstm_scan.py). Everything else
— the plain forward, the plain hand-written reverse-time backward, and the
``torch.autograd.Function`` that ties them together — lives here.

Shapes are head-parametric, as in the reference: gx ``(T, B, NH, G)``,
u ``(NH, dh, G)``, h0 and every state ``(B, NH, dh)``, with ``NH``
recurrence blocks (heads) of ``dh`` units and ``G`` the per-head gate
width (4 dh for both cells). The LSTM is the one-head case
(kernels/lstm_scan.py); the sLSTM uses its block-diagonal R directly
(kernels/slstm_scan.py). ``plain_fwd``/``plain_bwd`` also take the
one-head form without its head axis (``(T, B, G)``, ``(H, G)``, ``(B, H)``).

RH dropout over dh, shared across heads: ``keep_blocks`` ``(T|1, nk)``
structured ids table (compact gathers) OR ``dense_mask`` ``(T|1, B, 1|NH,
dh)``, with the inverted-dropout ``scale``; a leading 1 is the FIXED time
pattern. ``lengths`` (B,) int32 freezes each row past its length: forward
carries t-1's state through, backward routes the carry cotangents straight
through with zero dgates.

Dtypes follow the reference's contract: gx and u may be bfloat16 beside
float32 h0 and states. All products and pointwise math run in float32
(bfloat16 operands widen exactly); hs comes back in h0's dtype, each state
sequence in its state's, and the gates residual in gx's, rounded there as
the reference stores it; the backward reads that rounded residual. Every
cotangent carries its primal's dtype, and du is summed from the float32
dgates before it is rounded to u's dtype.

``impl="pallas"`` runs the cell's CUDA kernels for CUDA tensors (raising if
the cell has none) and the plain version for CPU tensors; ``impl="xla"``
always runs the plain version (the reference's ``_xla_fwd``/``_xla_bwd``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.masks import keep_blocks_to_unit_ids


@dataclasses.dataclass(frozen=True)
class CellSpec:
    name: str
    num_states: int
    pointwise_fwd: Callable     # (gates, states) -> (h_new, states_new)
    pointwise_bwd: Callable     # (gates, st_prev, st_new, dh, dst)
                                # -> (dgates, dst_prev)
    kernel_fwd: Optional[Callable] = None  # CUDA: same args as plain_fwd
    kernel_bwd: Optional[Callable] = None  # CUDA: same args as plain_bwd


def _row(table, t):
    return table[0] if table.shape[0] == 1 else table[t]


def _headed(gx, u, h0, states0, mask):
    """Give the one-head ``(T, B, G)`` / ``(H, G)`` / ``(B, H)`` form its
    head axis (heads = 1); the headed form passes through."""
    if gx.dim() == 4:
        return gx, u, h0, tuple(states0), mask
    return (gx[:, :, None], u[None], h0[:, None],
            tuple(s[:, None] for s in states0),
            None if mask is None else mask[:, :, None])


def _wide(x):
    """x in float32 or wider: bfloat16 widens (exactly), float64 stays."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _bmm(x, w):
    """(B, NH, K) x (NH, K, G) -> (B, NH, G), one product per head."""
    return torch.matmul(x.transpose(0, 1), w).transpose(0, 1)


def plain_fwd(cell: CellSpec, gx, u, h0, states0, ids, mask, lengths,
              scale: float):
    """Plain forward: per-step compact gathers (structured), mask-multiply
    (dense) or a dense product, per head. ``ids`` are unit ids (rows, k)
    over dh. Takes the headed layout or the one-head 3-D one.

    Returns (hs (T, B, NH, dh), gates (T, B, NH, G), state sequences), 3-D
    for 3-D inputs."""
    squeeze = gx.dim() == 3
    gx, u, h0, states0, mask = _headed(gx, u, h0, states0, mask)
    T = gx.shape[0]
    u = _wide(u)
    h, sts = h0, tuple(states0)
    fixed_u = None
    if ids is not None and ids.shape[0] == 1:
        fixed_u = u.index_select(1, ids[0].long())
    hs, gates_seq, st_seqs = [], [], [[] for _ in sts]
    for t in range(T):
        if ids is not None:
            ids_t = _row(ids, t).long()
            u_c = fixed_u if fixed_u is not None else u.index_select(1, ids_t)
            r = _bmm(_wide(h.index_select(2, ids_t)), u_c) * scale
        elif mask is not None:
            r = _bmm(_wide(h * _row(mask, t) * scale), u)
        else:
            r = _bmm(_wide(h), u)
        gates = _wide(gx[t]) + r
        h2, st2 = cell.pointwise_fwd(gates, tuple(_wide(s) for s in sts))
        h2 = h2.to(h0.dtype)
        st2 = tuple(v.to(s.dtype) for v, s in zip(st2, sts))
        if lengths is not None:
            act = (t < lengths)[:, None, None]
            h2 = torch.where(act, h2, h)
            st2 = tuple(torch.where(act, v, s) for v, s in zip(st2, sts))
        h, sts = h2, st2
        hs.append(h)
        gates_seq.append(gates.to(gx.dtype))
        for seq, v in zip(st_seqs, sts):
            seq.append(v)
    out = (torch.stack(hs), torch.stack(gates_seq),
           tuple(torch.stack(s) for s in st_seqs))
    if squeeze:
        out = (out[0][:, :, 0], out[1][:, :, 0],
               tuple(s[:, :, 0] for s in out[2]))
    return out


def plain_bwd(cell: CellSpec, dy, dstT, gates, st_seqs, states0, hs, h0, u,
              ids, mask, lengths, scale: float):
    """Plain hand-written reverse-time backward.

    dy (T, B, NH, dh) is dL/dhs with dL/dh_T already added at T-1; dstT the
    final states' cotangents. Frozen (ragged) steps give exactly zero
    dgates. Takes the headed layout or the one-head 3-D one. Returns
    (dgx, du, dh0, dstates0)."""
    squeeze = gates.dim() == 3
    _, u, h0, states0, mask = _headed(gates, u, h0, states0, mask)
    if squeeze:
        dy, hs, gates = dy[:, :, None], hs[:, :, None], gates[:, :, None]
        dstT = tuple(d[:, None] for d in dstT)
        st_seqs = tuple(s[:, :, None] for s in st_seqs)
    T, B, NH, _ = gates.shape
    dh_dim = u.shape[1]
    acc = torch.promote_types(h0.dtype, torch.float32)
    u = _wide(u)
    fixed = ids is not None and ids.shape[0] == 1
    if fixed:
        ids0 = ids[0].long()
        u_c0 = u.index_select(1, ids0)
        du = u.new_zeros((NH, ids0.shape[0], u.shape[2]))  # compact until the end
    else:
        du = torch.zeros_like(u)
    dh_next = h0.new_zeros((B, NH, dh_dim), dtype=acc)
    dst_next = tuple(_wide(d) for d in dstT)
    dgx = []
    for t in range(T - 1, -1, -1):
        dh = _wide(dy[t]) + dh_next
        if lengths is not None:
            act = (t < lengths)[:, None, None]
            dh_c = torch.where(act, dh, torch.zeros_like(dh))
            dst_c = tuple(torch.where(act, d, torch.zeros_like(d))
                          for d in dst_next)
        else:
            dh_c, dst_c = dh, dst_next
        st_prev = tuple(_wide(s0 if t == 0 else seq[t - 1])
                        for s0, seq in zip(states0, st_seqs))
        st_new = tuple(_wide(seq[t]) for seq in st_seqs)
        h_prev = _wide(h0 if t == 0 else hs[t - 1])
        dgates, dst_prev = cell.pointwise_bwd(_wide(gates[t]), st_prev,
                                              st_new, dh_c, dst_c)
        if lengths is not None:
            # exactly zero, also where the cell's arithmetic on a frozen
            # step's stored values is not finite (0 x inf)
            dgates = torch.where(act, dgates, torch.zeros_like(dgates))
        if ids is not None:
            ids_t = ids0 if fixed else ids[t].long()
            u_c = u_c0 if fixed else u.index_select(1, ids_t)
            # BP: only the kept columns of dh_{t-1} get a contribution.
            dh_prev = h0.new_zeros((B, NH, dh_dim), dtype=acc).index_copy_(
                2, ids_t, _bmm(dgates, u_c.transpose(1, 2)) * scale)
            # WG: compact (NH, k, G) product into the kept rows.
            contrib = torch.matmul(
                h_prev.index_select(2, ids_t).permute(1, 2, 0),
                dgates.transpose(0, 1)) * scale
            du = du + contrib if fixed else du.index_add_(1, ids_t, contrib)
        elif mask is not None:
            m_t = _row(mask, t)
            dh_prev = _bmm(dgates, u.transpose(1, 2)) * m_t * scale
            du = du + torch.matmul((h_prev * m_t * scale).permute(1, 2, 0),
                                   dgates.transpose(0, 1))
        else:
            dh_prev = _bmm(dgates, u.transpose(1, 2))
            du = du + torch.matmul(h_prev.permute(1, 2, 0),
                                   dgates.transpose(0, 1))
        if lengths is not None:
            dh_prev = dh_prev + torch.where(act, torch.zeros_like(dh), dh)
            dst_prev = tuple(p + torch.where(act, torch.zeros_like(d), d)
                             for p, d in zip(dst_prev, dst_next))
        dh_next, dst_next = dh_prev, dst_prev
        dgx.append(dgates)
    if fixed:
        du = torch.zeros_like(u).index_copy_(1, ids0, du)
    dgx = torch.stack(dgx[::-1])
    if squeeze:
        return (dgx[:, :, 0], du[0], dh_next[:, 0],
                tuple(d[:, 0] for d in dst_next))
    return dgx, du, dh_next, tuple(dst_next)


class _CellScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cell, scale, use_kernel, ids, mask, lengths, gx, u, h0,
                *states0):
        if use_kernel:
            if cell.kernel_fwd is None:
                raise NotImplementedError(f"cell {cell.name!r} has no CUDA kernel")
            hs, gates, st_seqs = cell.kernel_fwd(gx, u, h0, states0, ids, mask,
                                                 lengths, scale)
        else:
            hs, gates, st_seqs = plain_fwd(cell, gx, u, h0, states0, ids,
                                           mask, lengths, scale)
        ctx.cfg = (cell, scale, use_kernel, len(states0))
        ctx.save_for_backward(gates, hs, u, h0, ids, mask, lengths,
                              *st_seqs, *states0)
        return (hs, hs[-1], *(s[-1] for s in st_seqs))

    @staticmethod
    def backward(ctx, dhs, dh_fin, *dst_fin):
        cell, scale, use_kernel, ns = ctx.cfg
        saved = ctx.saved_tensors
        gates, hs, u, h0, ids, mask, lengths = saved[:7]
        st_seqs, states0 = saved[7:7 + ns], saved[7 + ns:]
        dy = torch.zeros_like(hs) if dhs is None else dhs.clone()
        if dh_fin is not None:
            dy[-1] += dh_fin
        dstT = tuple(torch.zeros_like(s0) if d is None else d.contiguous()
                     for d, s0 in zip(dst_fin, states0))
        run = cell.kernel_bwd if use_kernel else (
            lambda *a: plain_bwd(cell, *a))
        if run is None:
            raise NotImplementedError(f"cell {cell.name!r} has no CUDA kernel")
        dgx, du, dh0, dst0 = run(dy.contiguous(), dstT, gates, st_seqs,
                                 states0, hs, h0, u, ids, mask, lengths, scale)
        return (None, None, None, None, None, None, dgx.to(gates.dtype),
                du.to(u.dtype), dh0.to(h0.dtype),
                *(d.to(s0.dtype) for d, s0 in zip(dst0, states0)))


def cell_scan(gx: torch.Tensor, u: torch.Tensor, h0: torch.Tensor,
              states0: Tuple[torch.Tensor, ...], *, cell: CellSpec,
              keep_blocks: Optional[torch.Tensor] = None,
              dense_mask: Optional[torch.Tensor] = None,
              block_size: int = 1, scale: float = 1.0, impl: str = "pallas",
              lengths: Optional[torch.Tensor] = None):
    """Run one cell's full Phase-B recurrence in one fused pass.

    gx (T, B, NH, G), u (NH, dh, G), h0 and states0 (B, NH, dh). Returns
    ``(hs (T, B, NH, dh), (h_fin, states_fin))``, differentiable w.r.t.
    (gx, u, h0, states0) through the fused reverse-time backward."""
    if keep_blocks is not None and dense_mask is not None:
        raise ValueError("give at most one of keep_blocks / dense_mask")
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    ids = None
    if keep_blocks is not None:
        ids = keep_blocks_to_unit_ids(keep_blocks, block_size).to(
            torch.int32).contiguous()
    if lengths is not None:
        lengths = lengths.to(device=gx.device, dtype=torch.int32)
    if dense_mask is not None:
        dense_mask = dense_mask.to(torch.float32).contiguous()
    use_kernel = impl == "pallas" and gx.is_cuda
    outs = _CellScan.apply(cell, float(scale), use_kernel, ids, dense_mask,
                           lengths, gx.contiguous(), u.contiguous(),
                           h0.contiguous(), *(s.contiguous() for s in states0))
    return outs[0], (outs[1], tuple(outs[2:]))
