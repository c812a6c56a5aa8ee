"""Fused two-pass seq2seq decoder recurrence (the NMT engine="fused" core).

Port of ``repro.kernels.decoder_scan``. Luong input feeding splits the
decoder's layer-0 NR matmul into a hoisted ``embed_t @ W_x`` (Phase A,
time-batched outside) and a recurrent ``h~_{t-1} @ W_feed``; this module
runs everything that stays recurrent, per decoder step t (nl stacked LSTM
layers, states (h_l, c_l), feed h~):

    gates_0 = gx0_t + drop(h~_{t-1}) @ W_feed + drop(h_{0,t-1}) @ U_0
    gates_l = drop(h_{l-1,t}) @ W_l + b_l + drop(h_{l,t-1}) @ U_l   (l >= 1)
    h_l, c_l = lstm_pointwise(gates_l, c_l)
    scores   = h_top @ enc_proj^T + score_bias        (additive -1e30 mask)
    alpha    = softmax(scores);  ctx = alpha @ enc_out
    h~_t     = tanh([ctx ; h_top] @ w_comb)

Canonical site order (the ``sites`` argument, 2*nl entries):
``[feed, rh_0 .. rh_{nl-1}, nr_1 .. nr_{nl-1}]``, each ``(keep_blocks
(rows, nk) | None, dense_mask (rows, B, H) | None, block_size, scale)``
with rows in {1, T} (1 = FIXED, one mask for every step).

The backward is the reference's hand-derived reverse-time pass: compact
BP/WG on kept units (FIXED keeps the accumulators compact until one final
scatter), the attention backward through the softmax jacobian from the
stored alpha rows, dgx0 out to Phase A's autograd.

**Ragged batches**: ``lengths`` (B,) freezes every carry (h_l, c_l, feed)
of a row past its length; h~ repeats the last valid readout. The in-step
math of a frozen row still runs on the unfrozen values (as the reference
does) and its cotangents are zeroed into the step and passed through.

``impl="pallas"`` launches the hand-written CUDA kernels
(``csrc/decoder_scan.cu``: K7 forward, K8 backward) for CUDA tensors and
runs the plain version (``plain_fwd``/``plain_bwd``, the reference's
``_xla_fwd``/``_xla_bwd``) for CPU tensors; ``impl="xla"`` always runs the
plain version. The kernels take float32 and nl = 2 layers only; the
wrappers raise on other dtypes and depths, on mixed devices, on shapes
whose plan does not fit, and on a non-zero CUDA status after a launch. K8
runs on K4's grid of thread-block clusters (``lstm_scan.cluster_plan``)
with a zeroed exchange ring and scratch that the wrapper allocates
(``bwd_ring_words``).

In K7 (``dec_fwd_tma``) every carry is published by its owner in its
consumer's compact layout through inverse maps (``consumer_maps``, built on
the device once a launch), read by TMA multicast over clusters of CTAs
into a ring, its gate products on the TF32 tensor cores in split
precision; ``plain_fwd_published`` is that dataflow in plain PyTorch. Its
plan (``_tma_plan``) takes at most 4 units a CTA, so H up to 4 x the SMs.
``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence

import torch

from repro_torch.core.masks import keep_blocks_to_unit_ids
from repro_torch.kernels import _build
from repro_torch.kernels.lstm_scan import (_pointwise_bwd, _pointwise_fwd,
                                           cluster_plan, n_clusters, ring_words)

LAUNCHES = {"decoder_scan_fwd": 0, "decoder_scan_bwd": 0}

KERNEL_LAYERS = 2         # csrc/decoder_scan.cu: NL, the only depth K7/K8 take
_MODES = {"off": 0, "structured": 1, "dense": 2}


def _pw_fwd(gates, c_prev):
    h, (c,) = _pointwise_fwd(gates, (c_prev,), forget_bias=0.0)
    return h, c


def _pw_bwd(gates, c_prev, c_new, dh, dc):
    dgates, (dc_prev,) = _pointwise_bwd(gates, (c_prev,), (c_new,), dh, (dc,),
                                        forget_bias=0.0)
    return dgates, dc_prev


@dataclasses.dataclass(frozen=True)
class SiteDesc:
    """Static per-site dropout descriptor (block ids are expanded to unit
    ids in the site's table, so no block size is kept)."""
    mode: str          # "structured" | "dense" | "off"
    fixed: bool        # one mask row reused for all T steps
    scale: float


def _mk_site(kb, mask, block_size, scale):
    """(desc, table): table is the (rows, nk*bs) int32 unit-ids table of a
    structured site, the (rows, B, H) float mask of a dense one, or None."""
    if kb is not None and mask is not None:
        raise ValueError("a site takes at most one of keep_blocks / dense_mask")
    mode = "structured" if kb is not None else (
        "dense" if mask is not None else "off")
    table = None
    if mode == "structured":
        table = keep_blocks_to_unit_ids(kb, int(block_size)).to(torch.int32)
    elif mode == "dense":
        table = mask
    fixed = table is not None and table.shape[0] == 1
    return SiteDesc(mode, fixed, float(scale)), table


def _site_weights(nl, us, ws, w_feed):
    """Canonical site index -> the weight it drops into.

    0 -> w_feed, 1+l -> us[l] (l in [0, nl)), nl+l -> ws[l-1] (l in [1, nl)).
    """
    return [w_feed] + list(us) + list(ws)


def _row(table, d: SiteDesc, t):
    return table[0] if d.fixed else table[t]


class _Sites:
    """Per-site helpers of the plain passes: compact gathers off the
    unit-ids rows, FIXED compact weights hoisted out of the time loop."""

    def __init__(self, descs, tables, weights):
        self.d, self.tab, self.w = descs, tables, weights
        self.wc0 = [w.index_select(0, tab[0].long())
                    if d.mode == "structured" and d.fixed else None
                    for d, tab, w in zip(descs, tables, weights)]

    def _ids_w(self, i, t):
        ids = _row(self.tab[i], self.d[i], t).long()
        w_c = self.wc0[i] if self.wc0[i] is not None else \
            self.w[i].index_select(0, ids)
        return ids, w_c

    def mm(self, x, i, t):
        """drop(x) @ w_i at step t."""
        d = self.d[i]
        if d.mode == "off":
            return x @ self.w[i]
        if d.mode == "structured":
            ids, w_c = self._ids_w(i, t)
            return (x.index_select(1, ids) @ w_c) * d.scale
        return (x * _row(self.tab[i], d, t) * d.scale) @ self.w[i]

    def bp(self, dg, i, t):
        """Input grad through site i (compact where structured)."""
        d = self.d[i]
        if d.mode == "off":
            return dg @ self.w[i].t()
        if d.mode == "structured":
            ids, w_c = self._ids_w(i, t)
            out = dg.new_zeros((dg.shape[0], self.w[i].shape[0]))
            return out.index_copy_(1, ids, (dg @ w_c.t()) * d.scale)
        return (dg @ self.w[i].t()) * _row(self.tab[i], d, t) * d.scale

    def wg_init(self, i):
        d, w = self.d[i], self.w[i]
        if d.mode == "structured" and d.fixed:
            return w.new_zeros((self.tab[i].shape[1], w.shape[1]))
        return torch.zeros_like(w)

    def wg_add(self, acc, x, dg, i, t):
        d = self.d[i]
        if d.mode == "off":
            return acc + x.t() @ dg
        if d.mode == "structured":
            ids = _row(self.tab[i], d, t).long()
            contrib = (x.index_select(1, ids).t() @ dg) * d.scale
            return acc + contrib if d.fixed else acc.index_add_(0, ids, contrib)
        return acc + (x * _row(self.tab[i], d, t) * d.scale).t() @ dg

    def wg_fin(self, acc, i):
        d = self.d[i]
        if d.mode == "structured" and d.fixed:
            return torch.zeros_like(self.w[i]).index_copy_(
                0, self.tab[i][0].long(), acc)
        return acc


def _freeze(act, new, old):
    return new if act is None else torch.where(act, new, old)


def plain_fwd(descs, tables, gx0, us, ws, bs, w_feed, w_comb, enc_proj,
              enc_out, score_bias, h0, c0, feed0, lengths):
    """Plain forward (the reference's ``_xla_fwd``).

    Returns (htil (T, B, H), gates (nl, T, B, G), hs (nl, T, B, H),
    cs (nl, T, B, H), alpha (T, B, S)); hs/cs/htil are the frozen carries,
    gates/alpha the step's own values."""
    nl = len(us)
    T = gx0.shape[0]
    H = w_feed.shape[0]
    st = _Sites(descs, tables, _site_weights(nl, us, ws, w_feed))
    hs, cs, feed = list(h0.unbind(0)), list(c0.unbind(0)), feed0
    o_htil, o_alpha = [], []
    o_g, o_h, o_c = [[] for _ in range(nl)], [[] for _ in range(nl)], \
        [[] for _ in range(nl)]
    for t in range(T):
        act = None if lengths is None else (t < lengths)[:, None]
        g = gx0[t] + st.mm(feed, 0, t) + st.mm(hs[0], 1, t)
        cur = None
        for l in range(nl):
            if l > 0:
                g = st.mm(cur, nl + l, t) + bs[l - 1] + st.mm(hs[l], 1 + l, t)
            h, c = _pw_fwd(g, cs[l])
            o_g[l].append(g)
            cur = h
            hs[l], cs[l] = _freeze(act, h, hs[l]), _freeze(act, c, cs[l])
            o_h[l].append(hs[l])
            o_c[l].append(cs[l])
        scores = torch.einsum("bh,bsh->bs", cur, enc_proj) + score_bias
        alpha = torch.softmax(scores, dim=-1)
        ctxv = torch.einsum("bs,bsh->bh", alpha, enc_out)
        htil = torch.tanh(ctxv @ w_comb[:H] + cur @ w_comb[H:])
        feed = _freeze(act, htil, feed)
        o_htil.append(feed)
        o_alpha.append(alpha)
    stack2 = lambda seqs: torch.stack([torch.stack(s) for s in seqs])
    return (torch.stack(o_htil), stack2(o_g), stack2(o_h), stack2(o_c),
            torch.stack(o_alpha))


def plain_bwd(descs, tables, res, dout, us, ws, w_feed, w_comb, enc_proj,
              enc_out, h0, c0, feed0, lengths):
    """Plain reverse-time backward (the reference's ``_xla_bwd``).

    ``res`` = (htil, gates, hs, cs, alpha) of the forward; ``dout`` =
    (d_htil (T, B, H), d_hfin (nl, B, H), d_cfin, d_ffin (B, H)). Returns
    (dgx0, dw_feed, dus [nl], dws [nl-1], dbs [nl-1], dw_comb, denc_proj,
    denc_out, dh0, dc0, dfeed0)."""
    htil_seq, gates, hs, cs, alpha_seq = res
    d_htil, d_hfin, d_cfin, d_ffin = dout
    nl = len(us)
    T = gates.shape[1]
    H = w_feed.shape[0]
    st = _Sites(descs, tables, _site_weights(nl, us, ws, w_feed))
    accs = [st.wg_init(i) for i in range(2 * nl)]
    dbs = [gates.new_zeros(gates.shape[-1]) for _ in range(nl - 1)]
    dwcomb = torch.zeros_like(w_comb)
    dep, deo = torch.zeros_like(enc_proj), torch.zeros_like(enc_out)
    dh, dc, dfeed = list(d_hfin.unbind(0)), list(d_cfin.unbind(0)), d_ffin
    dgx = [None] * T
    for t in range(T - 1, -1, -1):
        act = None if lengths is None else (t < lengths)[:, None]
        zero = lambda v: v if act is None else torch.where(act, v, 0.0)
        passthru = lambda v: 0.0 if act is None else torch.where(act, 0.0, v)
        dhtil = d_htil[t] + dfeed
        dpre = zero(dhtil) * (1.0 - htil_seq[t] * htil_seq[t])
        cur = hs[nl - 1, t]
        alpha = alpha_seq[t]
        ctxv = torch.einsum("bs,bsh->bh", alpha, enc_out)
        dwcomb = dwcomb + torch.cat([ctxv, cur], -1).t() @ dpre
        dcat = dpre @ w_comb.t()
        dctx, dcur = dcat[:, :H], dcat[:, H:]
        dalpha = torch.einsum("bh,bsh->bs", dctx, enc_out)
        deo = deo + torch.einsum("bs,bh->bsh", alpha, dctx)
        dscores = alpha * (dalpha - (alpha * dalpha).sum(-1, keepdim=True))
        dcur = dcur + torch.einsum("bs,bsh->bh", dscores, enc_proj)
        dep = dep + torch.einsum("bs,bh->bsh", dscores, cur)
        dh_cur = list(dh)
        dh_cur[nl - 1] = dh_cur[nl - 1] + dcur
        new_dh, new_dc = [None] * nl, [None] * nl
        for l in reversed(range(nl)):
            c_prev = c0[l] if t == 0 else cs[l, t - 1]
            h_prev = h0[l] if t == 0 else hs[l, t - 1]
            dg, dc_prev = _pw_bwd(gates[l, t], c_prev, cs[l, t],
                                  zero(dh_cur[l]), zero(dc[l]))
            new_dh[l] = st.bp(dg, 1 + l, t) + passthru(dh_cur[l])
            accs[1 + l] = st.wg_add(accs[1 + l], h_prev, dg, 1 + l, t)
            new_dc[l] = dc_prev + passthru(dc[l])
            if l > 0:
                dh_cur[l - 1] = dh_cur[l - 1] + st.bp(dg, nl + l, t)
                accs[nl + l] = st.wg_add(accs[nl + l], hs[l - 1, t], dg,
                                         nl + l, t)
                dbs[l - 1] = dbs[l - 1] + dg.sum(0)
            else:
                dgx[t] = dg
                f_prev = feed0 if t == 0 else htil_seq[t - 1]
                dfeed = st.bp(dg, 0, t) + passthru(dhtil)
                accs[0] = st.wg_add(accs[0], f_prev, dg, 0, t)
        dh, dc = new_dh, new_dc
    accs = [st.wg_fin(a, i) for i, a in enumerate(accs)]
    return (torch.stack(dgx), accs[0], accs[1:1 + nl], accs[1 + nl:], dbs,
            dwcomb, dep, deo, torch.stack(dh), torch.stack(dc), dfeed)


# ---------------------------------------------------------------------------
# K7's dataflow: every carry published in its consumer's layout
# ---------------------------------------------------------------------------


def _pad4(n: int) -> int:
    return -(-max(n, 1) // 4) * 4


def _kp(d: SiteDesc, table, H: int) -> int:
    """A site's published row width: k, or H for a dense or off site,
    rounded up to 4 floats."""
    return _pad4(table.shape[1] if d.mode == "structured" else H)


def consumer_maps(descs, tables, H, buf=None):
    """Per site, ``(inv, kp)``: ``inv`` (rows, H) int32 on the table's
    device, 1 + the column of each kept unit in the site's compact row and
    0 for a dropped one (None for a dense or off site, whose row is the
    dense one); ``kp`` the row's width (k, or H) rounded up to 4 floats, the
    16-byte row stride TMA needs (the padding stays zero). ``buf``, a zeroed
    int32 tensor of ``inv_words`` words, holds the maps if given (the
    kernel's wrapper carves it from its one zeroed scratch allocation)."""
    out, at, cols = [], 0, None
    for d, tab in zip(descs, tables):
        if d.mode != "structured":
            out.append((None, _kp(d, tab, H)))
            continue
        rows, k = tab.shape
        if cols is None:
            cols = torch.arange(1, H + 1, dtype=torch.int32, device=tab.device)
        if buf is None:
            inv = torch.zeros((rows, H), dtype=torch.int32, device=tab.device)
        else:
            inv = buf[at:at + rows * H].view(rows, H)
            at += _pad4(rows * H)
        out.append((inv.scatter_(1, tab.long(), cols[:k].expand(rows, k)), _kp(d, tab, H)))
    return out


def inv_words(descs, tables, H) -> int:
    """int32 words of ``consumer_maps``' inverse maps in one buffer."""
    return sum(_pad4(tab.shape[0] * H) for d, tab in zip(descs, tables)
               if d.mode == "structured")


def publish(x, d: SiteDesc, table, inv, kp, t):
    """The (B, kp) block that the owners of x's units (x (B, H)) write for
    site (d, table) to read at step t: drop(x) compacted, each unit placed
    through the inverse map ``inv`` (K7's publishing)."""
    B, H = x.shape
    out = x.new_zeros((B, kp))
    if d.mode == "off":
        out[:, :H] = x
    elif d.mode == "dense":
        out[:, :H] = x * (_row(table, d, t) * d.scale)
    else:
        col = _row(inv, d, t).long() - 1
        kept = col >= 0
        out[:, col[kept]] = x[:, kept] * d.scale
    return out


def plain_fwd_published(descs, tables, gx0, us, ws, bs, w_feed, w_comb,
                        enc_proj, enc_out, score_bias, h0, c0, feed0, lengths):
    """``plain_fwd`` (nl = 2) on K7's dataflow: each carry is
    published by its owner in its consumer's layout (``publish``, a slot
    per step parity) and each product reads that block: the unfrozen h_0
    for nr_1 at step t; the frozen h_0, h_1 and h~ for rh_0, rh_1 and the
    feed at t + 1. Same outputs as ``plain_fwd``."""
    _check_depth(len(us))
    T = gx0.shape[0]
    H = w_feed.shape[0]
    maps = consumer_maps(descs, tables, H)
    wts = _site_weights(KERNEL_LAYERS, us, ws, w_feed)

    def pub(i, x, t):
        return publish(x, descs[i], tables[i], maps[i][0], maps[i][1], t)

    def mm(i, block, t):
        if descs[i].mode != "structured":
            return block[:, :H] @ wts[i]
        ids = _row(tables[i], descs[i], t).long()
        return block[:, :ids.numel()] @ wts[i].index_select(0, ids)

    slots = [[pub(0, feed0, 0), None], [pub(1, h0[0], 0), None],
             [pub(2, h0[1], 0), None], [None, None]]
    hs, cs, feed = list(h0.unbind(0)), list(c0.unbind(0)), feed0
    o_htil, o_alpha = [], []
    o_g, o_h, o_c = [[], []], [[], []], [[], []]
    for t in range(T):
        act = None if lengths is None else (t < lengths)[:, None]
        p = t & 1
        cur = None
        for l, (sa, sb) in enumerate(((0, 1), (3, 2))):
            if l == 1:
                slots[3][p] = pub(3, cur, t)
            g = (gx0[t] if l == 0 else bs[0]) + mm(sa, slots[sa][p], t) + \
                mm(sb, slots[sb][p], t)
            h, c = _pw_fwd(g, cs[l])
            o_g[l].append(g)
            cur = h
            hs[l], cs[l] = _freeze(act, h, hs[l]), _freeze(act, c, cs[l])
            o_h[l].append(hs[l])
            o_c[l].append(cs[l])
            if t + 1 < T:
                slots[1 + l][1 - p] = pub(1 + l, hs[l], t + 1)
        scores = torch.einsum("bh,bsh->bs", cur, enc_proj) + score_bias
        alpha = torch.softmax(scores, dim=-1)
        ctxv = torch.einsum("bs,bsh->bh", alpha, enc_out)
        feed = _freeze(act, torch.tanh(ctxv @ w_comb[:H] + cur @ w_comb[H:]), feed)
        if t + 1 < T:
            slots[0][1 - p] = pub(0, feed, t + 1)
        o_htil.append(feed)
        o_alpha.append(alpha)
    stack2 = lambda seqs: torch.stack([torch.stack(s) for s in seqs])
    return (torch.stack(o_htil), stack2(o_g), stack2(o_h), stack2(o_c),
            torch.stack(o_alpha))


# ---------------------------------------------------------------------------
# CUDA launches (K7, K8). The C entry points take one argument struct each.
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _SiteArg(ctypes.Structure):
    _fields_ = [("mode", _I), ("k", _I), ("rows", _I), ("scale", _F),
                ("ids", _P), ("mask", _P)]


class _FwdArgs(ctypes.Structure):
    _fields_ = ([(n, _I) for n in ("T", "B", "H", "S", "nl", "ragged")]
                + [(n, _P) for n in ("gx0", "us", "ws", "bs", "wf", "wc", "ep",
                                     "eo", "sb", "h0", "c0", "f0", "lens")]
                + [("sites", _SiteArg * (2 * KERNEL_LAYERS))]
                + [(n, _P) for n in ("htil", "alpha", "gates", "hs", "cs")])


class _TmaArgs(ctypes.Structure):
    _fields_ = [("f", _FwdArgs), ("inv", _P * (2 * KERNEL_LAYERS)),
                ("pub", _P * (2 * KERNEL_LAYERS)), ("kp", _I * (2 * KERNEL_LAYERS)),
                ("rdx", _P), ("bar", _P), ("Q", _I), ("J", _I), ("NS", _I)]


class _BwdArgs(ctypes.Structure):
    _fields_ = ([(n, _I) for n in ("T", "B", "H", "S", "nl", "ragged")]
                + [(n, _P) for n in ("dy", "dhT", "dcT", "dfT", "gates", "hs",
                                     "cs", "htil", "alpha", "h0", "c0", "f0",
                                     "us", "ws", "wf", "wc", "ep", "eo",
                                     "lens")]
                + [("sites", _SiteArg * (2 * KERNEL_LAYERS))]
                + [(n, _P) for n in ("dgx0", "dus", "dws", "dbs", "dwf", "dwc",
                                     "dep", "deo", "dh0", "dc0", "df0", "dgs",
                                     "dpre", "dctx", "dcur", "dss", "ctxs",
                                     "ring")]
                + [("Q", _I), ("J", _I)])


def _lib():
    lib = _build.load("decoder_scan")
    if not getattr(lib, "_typed", False):
        lib.decoder_scan_fwd_tma_f32.argtypes = [ctypes.POINTER(_TmaArgs), _P]
        lib.decoder_scan_fwd_tma_f32.restype = _I
        lib.decoder_scan_fwd_tma_plan.argtypes = [_I] * 3 + [ctypes.POINTER(_I)] * 4
        lib.decoder_scan_fwd_tma_plan.restype = _I
        lib.decoder_scan_bwd_f32.argtypes = [ctypes.POINTER(_BwdArgs), _P]
        lib.decoder_scan_bwd_f32.restype = _I
        ip = ctypes.POINTER(_I)
        lib.decoder_scan_bwd_clusters.argtypes = [_I] * 5 + [ip] * 3
        lib.decoder_scan_bwd_clusters.restype = _I
        lib._typed = True
    return lib


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None or x.numel() == 0 else x.data_ptr()


def _check(ref: torch.Tensor, named: dict) -> None:
    for name, x in named.items():
        if x is None:
            continue
        want = torch.int32 if name in ("lengths", "ids") else torch.float32
        if x.device != ref.device:
            raise ValueError(f"{name} on {x.device}, gx0 on {ref.device}")
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.numel() and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _site_args(descs, tables, T, B, H, gx0):
    out = (_SiteArg * (2 * KERNEL_LAYERS))()
    for i, (d, tab) in enumerate(zip(descs, tables)):
        _check(gx0, {"ids" if d.mode == "structured" else "mask": tab})
        if tab is not None and tab.shape[0] not in (1, T):
            raise ValueError(f"site {i}: table has {tab.shape[0]} rows for T={T}")
        if d.mode == "dense" and tuple(tab.shape[1:]) != (B, H):
            raise ValueError(f"site {i}: dense mask {tuple(tab.shape)}, "
                             f"want (rows, {B}, {H})")
        out[i] = _SiteArg(_MODES[d.mode],
                          tab.shape[1] if d.mode == "structured" else 0,
                          1 if tab is None else tab.shape[0], d.scale,
                          _ptr(tab) if d.mode == "structured" else None,
                          _ptr(tab) if d.mode == "dense" else None)
    return out


def _check_depth(nl: int) -> None:
    if nl != KERNEL_LAYERS:
        raise ValueError(f"decoder_scan kernels take {KERNEL_LAYERS} layers, got {nl}")


def _stack(ts: Sequence[torch.Tensor], like: torch.Tensor, shape):
    return torch.stack(list(ts)).contiguous() if len(ts) else \
        like.new_zeros((0, *shape))


@functools.lru_cache(maxsize=None)
def _tma_plan(device_index: int, B: int, H: int, S: int):
    """K7's plan on this device, (Q, J, NS): clusters of Q CTAs, J units a
    CTA, NS ring stages. Raises the CUDA error where no plan fits or the
    card's occupancy query fails."""
    lib = _lib()
    q, j, ns, smem = _I(), _I(), _I(), _I()
    with torch.cuda.device(device_index):
        code = lib.decoder_scan_fwd_tma_plan(B, H, S, *(ctypes.byref(x) for x in (q, j, ns, smem)))
    _build.check(lib, code, "decoder_scan forward plan")
    return q.value, j.value, ns.value


def kernel_fwd(descs, tables, gx0, us, ws, bs, w_feed, w_comb, enc_proj,
               enc_out, score_bias, h0, c0, feed0, lengths):
    """K7: the whole forward in one launch; same outputs as ``plain_fwd``."""
    nl = len(us)
    T, B, G = gx0.shape
    H = w_feed.shape[0]
    S = enc_out.shape[1]
    _check_depth(nl)
    if G != 4 * H or tuple(w_comb.shape) != (2 * H, H) or \
            tuple(enc_out.shape) != (B, S, H):
        raise ValueError("decoder_scan: inconsistent shapes")
    u_st = _stack(us, gx0, (H, G))
    w_st = _stack(ws, gx0, (H, G))
    b_st = _stack(bs, gx0, (G,))
    named = dict(gx0=gx0, us=u_st, ws=w_st, bs=b_st, w_feed=w_feed,
                 w_comb=w_comb, enc_proj=enc_proj, enc_out=enc_out,
                 score_bias=score_bias, h0=h0, c0=c0, feed0=feed0,
                 lengths=lengths)
    _check(gx0, named)
    f32 = dict(dtype=torch.float32, device=gx0.device)
    htil = torch.empty((T, B, H), **f32)
    alpha = torch.empty((T, B, S), **f32)
    gates = torch.empty((nl, T, B, G), **f32)
    hs = torch.empty((nl, T, B, H), **f32)
    cs = torch.empty((nl, T, B, H), **f32)
    q, j, ns = _tma_plan(gx0.device.index or 0, B, H, S)
    a = _FwdArgs(T, B, H, S, nl, int(lengths is not None),
                 *(_ptr(x) for x in (gx0, u_st, w_st, b_st, w_feed, w_comb,
                                     enc_proj, enc_out, score_bias, h0, c0,
                                     feed0, lengths)),
                 _site_args(descs, tables, T, B, H, gx0),
                 *(_ptr(x) for x in (htil, alpha, gates, hs, cs)))
    # one zeroed allocation: each site's two published slots (2, B, kp),
    # rdx = [h_top | ctx] (B, 2 Hq), the barrier word, the inverse maps
    kps = [_kp(d, tab, H) for d, tab in zip(descs, tables)]
    sizes = [2 * B * kp for kp in kps] + [B * 2 * (-(-H // 32) * 32), 4]
    offs = [0]
    for n_ in sizes:
        offs.append(offs[-1] + n_)
    scratch = torch.zeros(offs[-1] + inv_words(descs, tables, H), **f32)
    pubs = [scratch[offs[i]:offs[i + 1]] for i in range(len(kps))]
    rdx, bar = scratch[offs[-3]:offs[-2]], scratch[offs[-2]:offs[-1]]
    maps = consumer_maps(descs, tables, H, scratch[offs[-1]:].view(torch.int32))
    n = 2 * KERNEL_LAYERS
    ta = _TmaArgs(a, (_P * n)(*(_ptr(m[0]) for m in maps)),
                  (_P * n)(*(_ptr(p) for p in pubs)), (_I * n)(*(kp for _, kp in maps)),
                  _ptr(rdx), _ptr(bar), q, j, ns)
    lib = _lib()
    code = lib.decoder_scan_fwd_tma_f32(ctypes.byref(ta),
                                        torch.cuda.current_stream(gx0.device).cuda_stream)
    _build.check(lib, code, "decoder_scan forward")
    LAUNCHES["decoder_scan_fwd"] += 1
    return htil, gates, hs, cs, alpha


@functools.lru_cache(maxsize=None)
def _bwd_plan(device_index: int, B: int, H: int, S: int):
    """K8's grid (Q, J, P) on this device (``lstm_scan.cluster_plan``)."""
    lib = _lib()
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count

    def fits(q, j):
        mc, smem, pre = _I(), _I(), _I()
        with torch.cuda.device(device_index):
            code = lib.decoder_scan_bwd_clusters(B, H, S, q, j, ctypes.byref(mc),
                                                 ctypes.byref(smem), ctypes.byref(pre))
        _build.check(lib, code, "decoder_scan backward plan")
        return mc.value >= n_clusters(H, j, q)
    return cluster_plan(H, sms, fits)


def bwd_ring_words(Q: int, J: int, P: int, B: int, H: int, T: int) -> int:
    """64-bit words of K8's zeroed exchange: four channels (U_0, U_1, W_1,
    W_feed partials) of two slots of B x H words from each of P clusters,
    then ``lstm_scan.ring_words``'s sentinels and barrier counter, and a
    (4 sites x T, H) float keep table."""
    return 3 * 2 * P * B * H + ring_words(Q, J, P, B, H, 4 * T)


def kernel_bwd(descs, tables, res, dout, us, ws, w_feed, w_comb, enc_proj,
               enc_out, h0, c0, feed0, lengths):
    """K8: the whole reverse-time backward in one cooperative launch; same
    outputs as ``plain_bwd``."""
    htil, gates, hs, cs, alpha = res
    d_htil, d_hfin, d_cfin, d_ffin = dout
    nl = len(us)
    _, T, B, G = gates.shape
    H = w_feed.shape[0]
    S = enc_out.shape[1]
    _check_depth(nl)
    sms = torch.cuda.get_device_properties(d_htil.device).multi_processor_count
    if H % 4 or B > 256 or H > 4 * sms:
        raise ValueError(f"decoder_scan backward kernel takes H % 4 == 0, B <= 256 "
                         f"and H <= 4 x {sms} SMs; got H={H}, B={B}")
    u_st = _stack(us, d_htil, (H, G))
    w_st = _stack(ws, d_htil, (H, G))
    _check(d_htil, dict(d_htil=d_htil, d_hfin=d_hfin, d_cfin=d_cfin,
                        d_ffin=d_ffin, gates=gates, hs=hs, cs=cs, htil=htil,
                        alpha=alpha, h0=h0, c0=c0, feed0=feed0, us=u_st,
                        ws=w_st, w_feed=w_feed, w_comb=w_comb,
                        enc_proj=enc_proj, enc_out=enc_out, lengths=lengths))
    f32 = dict(dtype=torch.float32, device=d_htil.device)
    dgx0 = torch.empty((T, B, G), **f32)
    dus = torch.empty((nl, H, G), **f32)
    dws = torch.empty((nl - 1, H, G), **f32)
    dbs = torch.empty((nl - 1, G), **f32)
    dwf = torch.empty((H, G), **f32)
    dwc = torch.empty((2 * H, H), **f32)
    dep = torch.empty((B, S, H), **f32)
    deo = torch.empty((B, S, H), **f32)
    dh0 = torch.empty((nl, B, H), **f32)
    dc0 = torch.empty((nl, B, H), **f32)
    df0 = torch.empty((B, H), **f32)
    dgs = torch.empty((T, B, G), **f32)     # scratch: layer 1's dgates
    dpre = torch.empty((T, B, H), **f32)    # scratch: the readout's cotangent
    dctx = torch.empty((T, B, H), **f32)
    dcur = torch.empty((B, H), **f32)
    dss = torch.empty((T, B, S), **f32)     # scratch: the scores' cotangent
    ctxs = torch.empty((T, B, H), **f32)    # scratch: the contexts, recomputed
    lib = _lib()
    q, j, p = _bwd_plan(d_htil.device.index or 0, B, H, S)
    ring = torch.zeros(bwd_ring_words(q, j, p, B, H, T), dtype=torch.int64,
                       device=d_htil.device)
    a = _BwdArgs(T, B, H, S, nl, int(lengths is not None),
                 *(_ptr(x) for x in (d_htil, d_hfin, d_cfin, d_ffin, gates, hs,
                                     cs, htil, alpha, h0, c0, feed0, u_st,
                                     w_st, w_feed, w_comb, enc_proj, enc_out,
                                     lengths)),
                 _site_args(descs, tables, T, B, H, d_htil),
                 *(_ptr(x) for x in (dgx0, dus, dws, dbs, dwf, dwc, dep, deo,
                                     dh0, dc0, df0, dgs, dpre, dctx, dcur, dss,
                                     ctxs, ring)), q, j)
    code = lib.decoder_scan_bwd_f32(ctypes.byref(a),
                                    torch.cuda.current_stream(d_htil.device).cuda_stream)
    _build.check(lib, code, "decoder_scan backward")
    LAUNCHES["decoder_scan_bwd"] += 1
    return (dgx0, dwf, list(dus.unbind(0)), list(dws.unbind(0)),
            list(dbs.unbind(0)), dwc, dep, deo, dh0, dc0, df0)


# ---------------------------------------------------------------------------
# autograd.Function and the public wrapper
# ---------------------------------------------------------------------------


class _DecoderScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, descs, nl, use_kernel, lengths, tables, gx0, w_feed,
                w_comb, enc_proj, enc_out, score_bias, h0, c0, feed0, *wts):
        us, ws, bs = wts[:nl], wts[nl:2 * nl - 1], wts[2 * nl - 1:]
        run = kernel_fwd if use_kernel else plain_fwd
        htil, gates, hs, cs, alpha = run(
            descs, tables, gx0, us, ws, bs, w_feed, w_comb, enc_proj, enc_out,
            score_bias, h0, c0, feed0, lengths)
        ctx.cfg = (descs, nl, use_kernel, tables, lengths)
        ctx.save_for_backward(htil, gates, hs, cs, alpha, w_feed, w_comb,
                              enc_proj, enc_out, h0, c0, feed0, *us, *ws)
        return htil, hs[:, -1].clone(), cs[:, -1].clone(), htil[-1].clone()

    @staticmethod
    def backward(ctx, d_htil, d_hfin, d_cfin, d_ffin):
        descs, nl, use_kernel, tables, lengths = ctx.cfg
        (htil, gates, hs, cs, alpha, w_feed, w_comb, enc_proj, enc_out, h0,
         c0, feed0, *wts) = ctx.saved_tensors
        us, ws = wts[:nl], wts[nl:]
        z = lambda d, like: torch.zeros_like(like) if d is None else d.contiguous()
        dout = (z(d_htil, htil), z(d_hfin, h0), z(d_cfin, c0), z(d_ffin, feed0))
        run = kernel_bwd if use_kernel else plain_bwd
        (dgx0, dwf, dus, dws, dbs, dwc, dep, deo, dh0, dc0,
         df0) = run(descs, tables, (htil, gates, hs, cs, alpha), dout, us, ws,
                    w_feed, w_comb, enc_proj, enc_out, h0, c0, feed0, lengths)
        dsb = None
        if ctx.needs_input_grad[10]:
            dsb = torch.zeros((enc_proj.shape[0], enc_proj.shape[1]),
                              dtype=enc_proj.dtype, device=enc_proj.device)
        return (None, None, None, None, None, dgx0, dwf, dwc, dep, deo, dsb,
                dh0, dc0, df0, *dus, *dws, *dbs)


def decoder_scan(gx0: torch.Tensor, us: Sequence[torch.Tensor],
                 ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                 w_feed: torch.Tensor, w_comb: torch.Tensor,
                 enc_proj: torch.Tensor, enc_out: torch.Tensor,
                 score_bias: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                 feed0: torch.Tensor, *, sites, impl: str = "xla",
                 lengths: Optional[torch.Tensor] = None):
    """Run the full teacher-forced decoder recurrence in one fused pass.

    gx0: (T, B, 4H) Phase-A gate inputs (bias folded in); us: nl recurrent
    weights (H, 4H); ws/bs: the nl-1 upper-layer input weights / biases;
    w_feed: (H, 4H); w_comb: (2H, H); enc_proj = enc_out @ w_att and
    enc_out: (B, S, H); score_bias: (B, S) additive attention mask (0 kept /
    -1e30 padded); h0/c0: (nl, B, H); feed0: (B, H). ``sites``: the 2*nl
    in-scan dropout sites in canonical order (module docstring). Returns
    ``(h_tildes (T, B, H), (h_fin (nl, B, H), c_fin, feed_fin (B, H)))``,
    differentiable w.r.t. every tensor input (score_bias gets a zero
    cotangent). ``lengths`` (B,) int32 makes the target batch ragged.
    """
    nl = len(us)
    if len(sites) != 2 * nl:
        raise ValueError(f"need {2 * nl} site entries, got {len(sites)}")
    if len(ws) != nl - 1 or len(bs) != nl - 1:
        raise ValueError(f"need {nl - 1} upper-layer weights and biases")
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    pairs = [_mk_site(*s) for s in sites]
    descs = tuple(p[0] for p in pairs)
    dev = gx0.device
    tables: List[Optional[torch.Tensor]] = []
    for d, tab in pairs:
        if tab is not None:
            tab = tab.to(dev)
            tab = tab.contiguous() if d.mode == "structured" else \
                tab.to(gx0.dtype).contiguous()
        tables.append(tab)
    if lengths is not None:
        lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    use_kernel = impl == "pallas" and gx0.is_cuda
    c = lambda x: x.contiguous()
    htil, h_fin, c_fin, f_fin = _DecoderScan.apply(
        descs, nl, use_kernel, lengths, tuple(tables), c(gx0), c(w_feed),
        c(w_comb), c(enc_proj), c(enc_out), c(score_bias), c(h0), c(c0),
        c(feed0), *map(c, us), *map(c, ws), *map(c, bs))
    return htil, (h_fin, c_fin, f_fin)
