"""Fused persistent-scan LSTM — the vanilla-cell instance of cell_scan.

Port of ``repro.kernels.lstm_scan``. The whole T-step Phase-B recurrence
(``gates_t = gx_t + drop(h_{t-1}) @ U``, then the pointwise update) runs in
one launch of a hand-written cooperative CUDA kernel
(``csrc/lstm_scan.cu``: K3 forward, K4 reverse-time backward) for CUDA
tensors, and as the plain forward / plain hand-written reverse of
kernels/cell_scan.py for CPU tensors. Gate order i, f, g, o; layouts as the
reference: gx (T, B, 4H) with the bias folded in, U (H, 4H), h0/c0 (B, H),
run through the headed cell_scan as its one-head case.

The kernels take float32 only; the wrappers raise on anything else, on
tensors of mixed devices, and on a non-zero CUDA status after the launch.
Both run on a grid of thread-block clusters (csrc/scan_exchange.cuh) and
pass their state between clusters through a zeroed ring of tagged words
that the wrapper allocates: K3 its h_t (``fwd_cluster_plan``,
``fwd_ring_words``), K4 its BP partial sums (``cluster_plan``,
``ring_words``); a shape whose plan does not fit the card raises.
``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cell_scan import CellSpec, cell_scan

LAUNCHES = {"lstm_scan_fwd": 0, "lstm_scan_bwd": 0}


def _pointwise_fwd(gates, states, *, forget_bias):
    """Gate nonlinearities + state update. gates order i,f,g,o."""
    (c_prev,) = states
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + forget_bias) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (c,)


def _pointwise_bwd(gates, states_prev, states_new, dh, dstates, *,
                   forget_bias):
    """Reverse of _pointwise_fwd from pre-activation gates; dstates carries
    dL/dc_t through c_{t+1}, dh the total dL/dh_t."""
    (c_prev,), (c,) = states_prev, states_new
    (dc_in,) = dstates
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    i = torch.sigmoid(gi)
    f = torch.sigmoid(gf + forget_bias)
    g = torch.tanh(gg)
    o = torch.sigmoid(go)
    tc = torch.tanh(c)
    do = dh * tc
    dc = dc_in + dh * o * (1.0 - tc * tc)
    dgates = torch.cat([
        (dc * g) * i * (1.0 - i),
        (dc * c_prev) * f * (1.0 - f),
        (dc * i) * (1.0 - g * g),
        do * o * (1.0 - o),
    ], dim=-1)
    return dgates, (dc * f,)


# ---------------------------------------------------------------------------
# CUDA launches (K3, K4)
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("lstm_scan")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lstm_scan_bwd_f32.argtypes = [p] * 16 + [i] * 10 + [f, f, p]
        lib.lstm_scan_bwd_f32.restype = i
        ip = ctypes.POINTER(i)
        lib.lstm_scan_bwd_clusters.argtypes = [i] * 6 + [ip] * 3
        lib.lstm_scan_bwd_clusters.restype = i
        lib.lstm_scan_fwd_f32.argtypes = [p] * 11 + [i] * 10 + [f, f, p]
        lib.lstm_scan_fwd_f32.restype = i
        lib.lstm_scan_fwd_clusters.argtypes = [i] * 6 + [ip] * 4
        lib.lstm_scan_fwd_clusters.restype = i
        lib._typed = True
    return lib


CLUSTER_SIZES = (8, 4, 2, 1)


def n_clusters(H: int, J: int, Q: int) -> int:
    """P, the clusters of Q CTAs of J units each that cover H units:
    ceil(ceil(H / J) / Q)."""
    return -(-(-(-H // J)) // Q)


def cluster_plan(H: int, sms: int, fits) -> Tuple[int, int, int]:
    """(Q, J, P) of K4's / K8's backward grid: P clusters of Q CTAs, J
    hidden units a CTA (csrc/scan_exchange.cuh). The largest cluster size
    of ``CLUSTER_SIZES``, then the fewest units a CTA, J from ceil(H / SMs)
    up to twice that, for which ``fits(Q, J)`` (all P = ceil(ceil(H / J) /
    Q) clusters resident at once, the shared-memory plan within the card's)
    holds."""
    j0 = -(-H // sms)
    for q in CLUSTER_SIZES:
        for j in range(j0, 2 * j0 + 1):
            if fits(q, j):
                return q, j, n_clusters(H, j, q)
    raise ValueError(f"no cluster plan fits H={H} on {sms} SMs")


FWD_ROWS = 64     # a K3 plan that chunks the batch takes at least this many rows a chunk


def fwd_cluster_plan(H: int, B: int, sms: int, query) -> Tuple[int, int, int]:
    """(Q, J, P) of K3's grid: ``cluster_plan`` over the
    plans that ``query(Q, J)`` -> (all clusters resident, rows a chunk)
    finds resident, first among those that take min(B, FWD_ROWS) rows (B
    rounded up to 4) a chunk, then among those that take any."""
    def takes(least):
        def fits(q, j):
            resident, rows = query(q, j)
            return resident and rows >= least
        return fits

    for least in (min(-(-B // 4) * 4, FWD_ROWS), 4):
        try:
            return cluster_plan(H, sms, takes(least))
        except ValueError:
            pass
    raise ValueError(f"no forward cluster plan fits H={H}, B={B} on {sms} SMs")


def fwd_ring_words(Q: int, J: int, P: int, B: int, H: int) -> int:
    """64-bit words of the zeroed exchange a K3 launch needs: two slots of
    B x H tagged h values, then a sentinel for each of the P x Q CTAs."""
    return 2 * B * H + P * Q


def ring_words(Q: int, J: int, P: int, B: int, H: int, keep_rows: int = 0) -> int:
    """64-bit words of the zeroed exchange a backward launch needs: two
    slots of B x H partials from each of the P clusters, two sentinels for
    each of the P x Q CTAs, the barrier counter (two words, so what follows
    stays 16-byte aligned), and a (keep_rows, H) float keep table."""
    return 2 * P * B * H + 2 * P * Q + 2 + -(-keep_rows * H // 2)


@functools.lru_cache(maxsize=None)
def _bwd_plan(device_index: int, B: int, H: int, mode: int, k: int):
    lib = _lib()
    sms = _sms(device_index)

    def fits(q, j):
        mc, res, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device_index):
            code = lib.lstm_scan_bwd_clusters(B, H, mode, k, q, j, ctypes.byref(mc),
                                              ctypes.byref(res), ctypes.byref(smem))
        _build.check(lib, code, "lstm_scan backward plan")
        return mc.value >= n_clusters(H, j, q)
    return cluster_plan(H, sms, fits)


def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _fwd_plan(device_index: int, B: int, H: int, mode: int, k: int):
    lib = _lib()

    def query(q, j):
        mc, res, smem, rows = (ctypes.c_int() for _ in range(4))
        with torch.cuda.device(device_index):
            code = lib.lstm_scan_fwd_clusters(B, H, mode, k, q, j, ctypes.byref(mc),
                                              ctypes.byref(res), ctypes.byref(smem),
                                              ctypes.byref(rows))
        _build.check(lib, code, "lstm_scan forward plan")
        return mc.value >= n_clusters(H, j, q), rows.value
    return fwd_cluster_plan(H, B, _sms(device_index), query)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _check(ref: torch.Tensor, named: dict) -> None:
    for name, (x, dt) in named.items():
        if x is None:
            continue
        if x.device != ref.device:
            raise ValueError(f"{name} on {x.device}, gx on {ref.device}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _mode_args(ids, mask, T, B, H):
    if ids is not None:
        if ids.shape[0] not in (1, T):
            raise ValueError(f"ids table has {ids.shape[0]} rows for T={T}")
        return 1, ids.shape[1], ids.shape[0], 1
    if mask is not None:
        if mask.shape[0] not in (1, T) or tuple(mask.shape[1:]) != (B, H):
            raise ValueError(f"dense mask {tuple(mask.shape)} for T={T}, "
                             f"B={B}, H={H}")
        return 2, 0, 1, mask.shape[0]
    return 0, 0, 1, 1


def lstm_scan_fwd_cuda(gx, u, h0, states0, ids, mask, lengths, scale, *,
                       forget_bias):
    """K3: the whole forward recurrence in one cooperative launch of
    clusters."""
    (c0,) = states0
    T, B, G = gx.shape
    H = u.shape[0]
    if G != 4 * H or tuple(u.shape) != (H, G):
        raise ValueError(f"gx {tuple(gx.shape)} / U {tuple(u.shape)} mismatch")
    f32, i32 = torch.float32, torch.int32
    _check(gx, {"gx": (gx, f32), "U": (u, f32), "h0": (h0, f32),
                "c0": (c0, f32), "ids": (ids, i32), "mask": (mask, f32),
                "lengths": (lengths, i32)})
    mode, k, ids_rows, mask_rows = _mode_args(ids, mask, T, B, H)
    hs = torch.empty((T, B, H), dtype=f32, device=gx.device)
    cs = torch.empty((T, B, H), dtype=f32, device=gx.device)
    gates = torch.empty((T, B, G), dtype=f32, device=gx.device)
    lib = _lib()
    q, j, p = _fwd_plan(gx.device.index or 0, B, H, mode, k)
    ring = torch.zeros(fwd_ring_words(q, j, p, B, H), dtype=torch.int64, device=gx.device)
    code = lib.lstm_scan_fwd_f32(
        gx.data_ptr(), u.data_ptr(), h0.data_ptr(), c0.data_ptr(), _ptr(ids),
        _ptr(mask), _ptr(lengths), hs.data_ptr(), gates.data_ptr(),
        cs.data_ptr(), ring.data_ptr(), T, B, H, mode, k, ids_rows, mask_rows,
        int(lengths is not None), q, j, float(scale), float(forget_bias),
        torch.cuda.current_stream(gx.device).cuda_stream)
    _build.check(lib, code, "lstm_scan forward")
    LAUNCHES["lstm_scan_fwd"] += 1
    return hs, gates, (cs,)


def lstm_scan_bwd_cuda(dy, dstT, gates, st_seqs, states0, hs, h0, u, ids,
                       mask, lengths, scale, *, forget_bias):
    """K4: the whole reverse-time backward in one cooperative launch."""
    (dcT,), (cs,), (c0,) = dstT, st_seqs, states0
    T, B, G = gates.shape
    H = u.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check(dy, {"dy": (dy, f32), "dcT": (dcT, f32), "gates": (gates, f32),
                "cs": (cs, f32), "c0": (c0, f32), "hs": (hs, f32),
                "h0": (h0, f32), "U": (u, f32), "ids": (ids, i32),
                "mask": (mask, f32), "lengths": (lengths, i32)})
    mode, k, ids_rows, mask_rows = _mode_args(ids, mask, T, B, H)
    dgx = torch.empty((T, B, G), dtype=f32, device=dy.device)
    du = torch.empty((H, G), dtype=f32, device=dy.device)
    dh0 = torch.empty((B, H), dtype=f32, device=dy.device)
    dc0 = torch.empty((B, H), dtype=f32, device=dy.device)
    lib = _lib()
    q, j, p = _bwd_plan(dy.device.index or 0, B, H, mode, k)
    ring = torch.zeros(ring_words(q, j, p, B, H, ids_rows if mode == 1 else 0),
                       dtype=torch.int64, device=dy.device)
    code = lib.lstm_scan_bwd_f32(
        dy.data_ptr(), dcT.data_ptr(), gates.data_ptr(), cs.data_ptr(),
        c0.data_ptr(), hs.data_ptr(), h0.data_ptr(), u.data_ptr(), _ptr(ids),
        _ptr(mask), _ptr(lengths), dgx.data_ptr(), du.data_ptr(),
        dh0.data_ptr(), dc0.data_ptr(), ring.data_ptr(), T, B, H, mode, k,
        ids_rows, mask_rows, int(lengths is not None), q, j, float(scale),
        float(forget_bias), torch.cuda.current_stream(dy.device).cuda_stream)
    _build.check(lib, code, "lstm_scan backward")
    LAUNCHES["lstm_scan_bwd"] += 1
    return dgx, du, dh0, (dc0,)


def _one_head_fwd(gx, u, h0, states0, ids, mask, lengths, scale, *,
                  forget_bias):
    """K3 on cell_scan's headed layout (heads = 1)."""
    hs, gates, (cs,) = lstm_scan_fwd_cuda(
        gx[:, :, 0], u[0], h0[:, 0], (states0[0][:, 0],), ids,
        None if mask is None else mask[:, :, 0], lengths, scale,
        forget_bias=forget_bias)
    return hs[:, :, None], gates[:, :, None], (cs[:, :, None],)


def _one_head_bwd(dy, dstT, gates, st_seqs, states0, hs, h0, u, ids, mask,
                  lengths, scale, *, forget_bias):
    """K4 on cell_scan's headed layout (heads = 1)."""
    dgx, du, dh0, (dc0,) = lstm_scan_bwd_cuda(
        dy[:, :, 0], (dstT[0][:, 0],), gates[:, :, 0], (st_seqs[0][:, :, 0],),
        (states0[0][:, 0],), hs[:, :, 0], h0[:, 0], u[0], ids,
        None if mask is None else mask[:, :, 0], lengths, scale,
        forget_bias=forget_bias)
    return dgx[:, :, None], du[None], dh0[:, None], (dc0[:, None],)


@functools.lru_cache(maxsize=None)
def lstm_cell_spec(forget_bias: float = 0.0) -> CellSpec:
    """The vanilla LSTM as a CellSpec, with its CUDA kernels."""
    fb = dict(forget_bias=forget_bias)
    return CellSpec(
        name="lstm", num_states=1,
        pointwise_fwd=functools.partial(_pointwise_fwd, **fb),
        pointwise_bwd=functools.partial(_pointwise_bwd, **fb),
        kernel_fwd=functools.partial(_one_head_fwd, **fb),
        kernel_bwd=functools.partial(_one_head_bwd, **fb))


def lstm_scan(gx: torch.Tensor, u: torch.Tensor, h0: torch.Tensor,
              c0: torch.Tensor, *, keep_blocks: Optional[torch.Tensor] = None,
              dense_mask: Optional[torch.Tensor] = None, block_size: int = 1,
              scale: float = 1.0, forget_bias: float = 0.0,
              impl: str = "pallas", lengths: Optional[torch.Tensor] = None):
    """Run the full Phase-B LSTM recurrence in one fused pass.

    gx (T, B, 4H) = ``x_t @ W + b``; u (H, 4H); h0/c0 (B, H). RH dropout:
    ``keep_blocks`` (T|1, nk) OR ``dense_mask`` (T|1, B, H) with ``scale``.
    Returns ``(hs (T, B, H), (h_fin, c_fin))``.
    """
    hs, (h_fin, (c_fin,)) = cell_scan(
        gx[:, :, None], u[None], h0[:, None], (c0[:, None],),
        cell=lstm_cell_spec(float(forget_bias)), keep_blocks=keep_blocks,
        dense_mask=None if dense_mask is None else dense_mask[:, :, None],
        block_size=block_size, scale=scale, impl=impl, lengths=lengths)
    return hs[:, :, 0], (h_fin[:, 0], c_fin[:, 0])
