"""Fused persistent-scan sLSTM — the xLSTM-cell instance of cell_scan.

Port of ``repro.kernels.slstm_scan``. The sLSTM (arXiv:2405.04517) keeps a
true h -> h recurrence with a per-head block-diagonal R ``(NH, dh, 4dh)``,
exponential input gating, a log-sigmoid forget gate, a running stabilizer
``m_t = max(lf_t + m_{t-1}, gi_t)`` and a normalizer ``n`` with output
``h = o * c / max(n, 1e-6)``; the carried states are (c, n, m). Gate order
(i, f, z, o) per head; xg ``(T, B, NH, 4dh)`` with the bias folded in.

The whole T-step recurrence runs in one launch of a hand-written
persistent CUDA kernel (``csrc/slstm_scan.cu``: K6 forward and
reverse-time backward, whose weight gradient dR runs after the scan as a
second kernel over the kept (step, unit block) pairs) for CUDA tensors,
and as cell_scan's plain forward / plain hand-written reverse with this
cell's pointwise math for CPU tensors and for ``impl="xla"``.

Dtypes are the reference's (``repro.kernels.cell_scan``): xg and R float32
or bfloat16 (the same), h0 and the states float32. The arithmetic is float32
throughout; the gates residual comes back in xg's dtype and hs and the state
sequences in float32; the cotangents carry their primals' dtypes, and dR is
summed from the float32 dgates, not from the rounded dgx. The wrappers
raise on other dtypes, on tensors of mixed devices, and on a non-zero CUDA
status after the launch. ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.cell_scan import CellSpec, cell_scan
from repro_torch.kernels.lstm_scan import _check, _ptr

LAUNCHES = {"slstm_scan_fwd": 0, "slstm_scan_bwd": 0, "slstm_wg": 0}

WG_UNITS = 64   # units (rows of R) a WG tile covers: csrc/slstm_scan.cu WU

_EPS = 1e-6      # normalizer floor, as models/xlstm.py slstm_step


def _pointwise_fwd(gates, states):
    """Exponential-gating sLSTM update. gates order (i, f, z, o) per head."""
    c, n, m = states
    gi, gf, gz, go = gates.chunk(4, dim=-1)
    lf = F.logsigmoid(gf)
    m_new = torch.maximum(lf + m, gi)                # stabilizer
    i = torch.exp(gi - m_new)
    f = torch.exp(lf + m - m_new)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * (c_new / torch.clamp(n_new, min=_EPS))
    return h_new, (c_new, n_new, m_new)


def _pointwise_bwd(gates, states_prev, states_new, dh, dstates):
    """Reverse of _pointwise_fwd from the pre-activation gates and the state
    sequences; dstates carries (dc, dn, dm) from step t+1, dh is the total
    dL/dh_t. The stabilizer's max sends its subgradient to the forget branch
    where ``lf + m_prev >= gi`` (ties to forget), else to the input gate."""
    c_prev, n_prev, m_prev = states_prev
    c, n, m = states_new                             # m == m_new
    dc_in, dn_in, dm_in = dstates
    gi, gf, gz, go = gates.chunk(4, dim=-1)
    lf = F.logsigmoid(gf)
    i = torch.exp(gi - m)
    f = torch.exp(lf + m_prev - m)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    inv = 1.0 / torch.clamp(n, min=_EPS)
    do = dh * c * inv
    dc_t = dc_in + dh * o * inv
    # d h / d n flows only where the floor is not active
    zero = torch.zeros_like(dh)
    dn_t = dn_in - torch.where(n > _EPS, dh * o * c * inv * inv, zero)
    df = dc_t * c_prev + dn_t * n_prev
    di = dc_t * z + dn_t
    dz = dc_t * i
    # i and f both divide by exp(m_new): the total goes into the stabilizer,
    # then through the max to its selected branch
    dm_t = dm_in - di * i - df * f
    sel = (lf + m_prev) >= gi
    dgi = di * i + torch.where(sel, zero, dm_t)
    dlf = df * f + torch.where(sel, dm_t, zero)
    dgates = torch.cat([dgi, dlf * torch.sigmoid(-gf), dz * (1.0 - z * z),
                        do * o * (1.0 - o)], dim=-1)
    return dgates, (dc_t * f, dn_t * f, dlf)


# ---------------------------------------------------------------------------
# CUDA launches (K6)
# ---------------------------------------------------------------------------


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _lib():
    lib = _build.load("slstm_scan")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for sfx in _SUFFIX.values():
            fwd = getattr(lib, f"slstm_scan_fwd_{sfx}")
            fwd.argtypes = [p] * 15 + [i] * 10 + [f, p]
            bwd = getattr(lib, f"slstm_scan_bwd_{sfx}")
            # bfloat16: the float32 dgates buffer after dgx
            bwd.argtypes = [p] * (21 if sfx == "f32" else 22) + [i] * 10 + [f, p]
            wg = getattr(lib, f"slstm_wg_{sfx}")
            wg.argtypes = [p] * 9 + [i] * 8 + [f, p]
            fwd.restype = bwd.restype = wg.restype = i
        lib.slstm_scan_ring_words.argtypes = [i] * 4
        lib.slstm_scan_ring_words.restype = ctypes.c_longlong
        lib.slstm_scan_units.argtypes = [i, i, p, p]
        lib.slstm_scan_units.restype = None
        lib._typed = True
    return lib


def _shapes(gx, u):
    T, B, NH, G = gx.shape
    dh = u.shape[1]
    if G != 4 * dh or tuple(u.shape) != (NH, dh, G):
        raise ValueError(f"xg {tuple(gx.shape)} / R {tuple(u.shape)} mismatch")
    return T, B, NH, dh


def _in_dtype(gx):
    """xg's dtype, the one of R, the gates residual and dgx: float32 or
    bfloat16."""
    if gx.dtype not in _SUFFIX:
        raise TypeError(f"xg must be float32 or bfloat16, got {gx.dtype}")
    return gx.dtype


def _mode_args(ids, mask, T, B, NH, dh):
    """(mode, k, ids_rows, mask_rows, mask_heads) of the C interface."""
    if ids is not None:
        if ids.dim() != 2 or ids.shape[0] not in (1, T):
            raise ValueError(f"ids table {tuple(ids.shape)} for T={T}")
        return 1, ids.shape[1], ids.shape[0], 1, 1
    if mask is not None:
        if (mask.dim() != 4 or mask.shape[0] not in (1, T)
                or mask.shape[2] not in (1, NH)
                or (mask.shape[1], mask.shape[3]) != (B, dh)):
            raise ValueError(f"dense mask {tuple(mask.shape)} for T={T}, "
                             f"B={B}, heads={NH}, dh={dh}")
        return 2, 0, 1, mask.shape[0], mask.shape[2]
    return 0, 0, 1, 1, 1


def _ring(lib, direction, B, NH, dh, device):
    """The zeroed exchange ring of one scan launch (64-bit tagged words)."""
    n = lib.slstm_scan_ring_words(direction, B, NH, dh)
    return torch.zeros(n, dtype=torch.int64, device=device)


def slstm_scan_fwd_cuda(gx, u, h0, states0, ids, mask, lengths, scale):
    """K6 forward: the whole recurrence in one persistent launch."""
    c0, n0, m0 = states0
    T, B, NH, dh = _shapes(gx, u)
    dt, f32, i32 = _in_dtype(gx), torch.float32, torch.int32
    _check(gx, {"xg": (gx, dt), "R": (u, dt), "h0": (h0, f32),
                "c0": (c0, f32), "n0": (n0, f32), "m0": (m0, f32),
                "ids": (ids, i32), "mask": (mask, f32),
                "lengths": (lengths, i32)})
    mode, k, ids_rows, mask_rows, mask_heads = _mode_args(ids, mask, T, B,
                                                          NH, dh)
    st = lambda: torch.empty((T, B, NH, dh), dtype=f32, device=gx.device)
    hs, cs, ns, ms = st(), st(), st(), st()
    gates = torch.empty((T, B, NH, 4 * dh), dtype=dt, device=gx.device)
    lib = _lib()
    ring = _ring(lib, 0, B, NH, dh, gx.device)
    code = getattr(lib, f"slstm_scan_fwd_{_SUFFIX[dt]}")(
        gx.data_ptr(), u.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        n0.data_ptr(), m0.data_ptr(), _ptr(ids), _ptr(mask), _ptr(lengths),
        hs.data_ptr(), gates.data_ptr(), cs.data_ptr(), ns.data_ptr(),
        ms.data_ptr(), ring.data_ptr(), T, B, NH, dh, mode, k, ids_rows,
        mask_rows, mask_heads, int(lengths is not None), float(scale),
        torch.cuda.current_stream(gx.device).cuda_stream)
    _build.check(lib, code, "slstm_scan forward")
    LAUNCHES["slstm_scan_fwd"] += 1
    return hs, gates, (cs, ns, ms)


def slstm_scan_bwd_cuda(dy, dstT, gates, st_seqs, states0, hs, h0, u, ids,
                        mask, lengths, scale):
    """K6 backward: the reverse-time recurrence in one persistent launch
    (dgx in the gates' dtype, dh0, dc0, dn0, dm0), then dR in R's dtype from
    the WG kernel over the float32 dgates."""
    (dcT, dnT, dmT), (cs, ns, ms), (c0, n0, m0) = dstT, st_seqs, states0
    T, B, NH, dh = _shapes(gates, u)
    dt, f32, i32 = _in_dtype(gates), torch.float32, torch.int32
    _check(dy, {"dy": (dy, f32), "dcT": (dcT, f32), "dnT": (dnT, f32),
                "dmT": (dmT, f32), "gates": (gates, dt), "cs": (cs, f32),
                "ns": (ns, f32), "ms": (ms, f32), "c0": (c0, f32),
                "n0": (n0, f32), "m0": (m0, f32), "hs": (hs, f32),
                "h0": (h0, f32), "R": (u, dt), "ids": (ids, i32),
                "mask": (mask, f32), "lengths": (lengths, i32)})
    mode, k, ids_rows, mask_rows, mask_heads = _mode_args(ids, mask, T, B,
                                                          NH, dh)
    dgx = torch.empty_like(gates)
    # bfloat16: the float32 dgates WG sums dR from
    dg32 = dgx if dt == f32 else torch.empty(dgx.shape, dtype=f32,
                                             device=dy.device)
    st = lambda: torch.empty((B, NH, dh), dtype=f32, device=dy.device)
    dh0, dc0, dn0, dm0 = st(), st(), st(), st()
    lib = _lib()
    ring = _ring(lib, 1, B, NH, dh, dy.device)
    extra = () if dt == f32 else (dg32.data_ptr(),)
    code = getattr(lib, f"slstm_scan_bwd_{_SUFFIX[dt]}")(
        dy.data_ptr(), dcT.data_ptr(), dnT.data_ptr(), dmT.data_ptr(),
        gates.data_ptr(), cs.data_ptr(), ns.data_ptr(), ms.data_ptr(),
        c0.data_ptr(), n0.data_ptr(), m0.data_ptr(), u.data_ptr(), _ptr(ids),
        _ptr(mask), _ptr(lengths), dgx.data_ptr(), *extra, dh0.data_ptr(),
        dc0.data_ptr(), dn0.data_ptr(), dm0.data_ptr(), ring.data_ptr(), T,
        B, NH, dh, mode, k, ids_rows, mask_rows, mask_heads,
        int(lengths is not None), float(scale),
        torch.cuda.current_stream(dy.device).cuda_stream)
    _build.check(lib, code, "slstm_scan backward")
    LAUNCHES["slstm_scan_bwd"] += 1
    du = slstm_wg(dg32, hs, h0, wg_tables(ids, T, dh, dy.device), mask,
                  scale, out_dtype=dt)
    return dgx, du, dh0, (dc0, dn0, dm0)


def wg_tables(ids, T, dh, device):
    """The WG kernel's index tables, built with tensor ops on ``device``:
    ``steps`` (nblk, T) int32, each block of WG_UNITS units' active steps (a
    unit of the block kept there) ascending, padded with T; ``counts``
    (nblk,) int32; ``keep`` (rows, dh) float32, 1 for a kept unit; and
    ``partial`` (nblk,) int32, 1 where an active step keeps only part of the
    block (the kernel applies ``keep`` there alone). ``keep`` and
    ``partial`` are None without an ids table (dense, off: every step
    active)."""
    nblk = -(-dh // WG_UNITS)
    dev = device
    t_idx = torch.arange(T, dtype=torch.int32, device=dev)
    if ids is None:
        return (t_idx.expand(nblk, T).contiguous(),
                torch.full((nblk,), T, dtype=torch.int32, device=dev), None, None)
    rows = ids.shape[0]
    keep = torch.zeros((rows, dh), dtype=torch.float32, device=dev)
    keep.scatter_(1, ids.long(), 1.0)
    pad = nblk * WG_UNITS - dh
    act = F.pad(keep, (0, pad)).view(rows, nblk, WG_UNITS).amax(-1) > 0
    some_dropped = F.pad(keep, (0, pad), value=1.0).view(rows, nblk, WG_UNITS).amin(-1) == 0
    partial = (act & some_dropped).any(0).to(torch.int32)
    act = act.expand(T, nblk).t()                          # (nblk, T)
    steps = torch.where(act, t_idx, T).sort(dim=1).values
    return (steps.to(torch.int32).contiguous(),
            act.sum(1).to(torch.int32), keep, partial)


def plain_wg(dgx, hs, h0, tables, mask, scale):
    """dR (NH, dh, 4dh) = sc * sum over each unit block's active steps t and
    rows b of (h_{t-1} x keep or mask x scale)[t, b, hd, u] dgx[t, b, hd, :]
    (sc = scale with a keep table, else 1): the WG kernel's plain version,
    in dgx's dtype."""
    steps, counts, keep, _ = tables
    T, B, NH, G = dgx.shape
    dh = G // 4
    hp = torch.cat([h0[None], hs[:-1]])                   # h_{t-1}
    if keep is not None:
        hp = hp * keep[:, None, None, :]
    elif mask is not None:
        hp = hp * (mask * scale)
    du = dgx.new_zeros((NH, dh, G))
    for blk in range(steps.shape[0]):
        ts = steps[blk, :int(counts[blk])].long()
        lo, hi = blk * WG_UNITS, min(dh, (blk + 1) * WG_UNITS)
        du[:, lo:hi] = torch.einsum("tbhu,tbhc->huc", hp[ts, :, :, lo:hi],
                                    dgx[ts])
    return du * scale if keep is not None else du


def slstm_wg(dgx, hs, h0, tables, mask, scale, out_dtype=torch.float32):
    """dR in ``out_dtype`` (float32 or bfloat16) from the float32 dgates
    ``dgx`` and the forward's hs: the WG kernel for CUDA tensors, its plain
    version (``plain_wg``, rounded once at the end) for CPU tensors."""
    if not dgx.is_cuda:
        return plain_wg(dgx, hs, h0, tables, mask, scale).to(out_dtype)
    steps, counts, keep, partial = tables
    T, B, NH, G = dgx.shape
    dh = G // 4
    f32, i32 = torch.float32, torch.int32
    _check(dgx, {"dgx": (dgx, f32), "hs": (hs, f32), "h0": (h0, f32),
                 "steps": (steps, i32), "counts": (counts, i32),
                 "partial": (partial, i32), "keep": (keep, f32),
                 "mask": (mask, f32)})
    mode = 1 if keep is not None else 2 if mask is not None else 0
    if out_dtype not in _SUFFIX:
        raise TypeError(f"dR must be float32 or bfloat16, got {out_dtype}")
    du = torch.empty((NH, dh, G), dtype=out_dtype, device=dgx.device)
    lib = _lib()
    code = getattr(lib, f"slstm_wg_{_SUFFIX[out_dtype]}")(
        hs.data_ptr(), h0.data_ptr(), dgx.data_ptr(), steps.data_ptr(),
        counts.data_ptr(), _ptr(partial), _ptr(keep), _ptr(mask),
        du.data_ptr(), T, B, NH,
        dh, mode, 1 if keep is None else keep.shape[0],
        1 if mask is None else mask.shape[0],
        1 if mask is None else mask.shape[2], float(scale),
        torch.cuda.current_stream(dgx.device).cuda_stream)
    _build.check(lib, code, "slstm_scan WG")
    LAUNCHES["slstm_wg"] += 1
    return du


SLSTM_CELL = CellSpec(name="slstm", num_states=3,
                      pointwise_fwd=_pointwise_fwd,
                      pointwise_bwd=_pointwise_bwd,
                      kernel_fwd=slstm_scan_fwd_cuda,
                      kernel_bwd=slstm_scan_bwd_cuda)


def slstm_scan(xg: torch.Tensor, r: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor, *,
               keep_blocks: Optional[torch.Tensor] = None,
               dense_mask: Optional[torch.Tensor] = None,
               block_size: int = 1, scale: float = 1.0, impl: str = "pallas",
               lengths: Optional[torch.Tensor] = None):
    """Run the full sLSTM time recurrence in one fused pass.

    xg (T, B, NH, 4dh) gate inputs ``x_t @ W + b`` in (i, f, z, o)-per-head
    layout; r (NH, dh, 4dh); h0/c0/n0/m0 (B, NH, dh) (fresh start: zeros,
    zeros, zeros, -1e30). RH dropout over dh, shared across heads:
    ``keep_blocks`` (T|1, nk) OR ``dense_mask`` (T|1, B, 1|NH, dh) with
    ``scale``; a leading 1 is FIXED. ``lengths`` (B,) int32 freezes row b's
    (h, c, n, m) after step ``lengths[b]``. Returns ``(hs (T, B, NH, dh),
    (h_fin, (c_fin, n_fin, m_fin)))``, differentiable w.r.t. all six
    inputs.
    """
    return cell_scan(xg, r, h0, (c0, n0, m0), cell=SLSTM_CELL,
                     keep_blocks=keep_blocks, dense_mask=dense_mask,
                     block_size=block_size, scale=scale, impl=impl,
                     lengths=lengths)
