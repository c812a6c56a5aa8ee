"""K7/K8 fused NMT decoder scan: the port's plain ``decoder_scan`` against
the reference's ``decoder_scan(impl="xla")`` and against
``kernels/ref.py:decoder_scan_ref`` under ``jax.grad``.

Sweeps the in-scan site modes (structured / dense / off / a mixed
assignment) x time pattern (per-step / FIXED one-row) x ragged target
``lengths``, with non-zero cotangents on every output, final states
included: the forward (h~ sequence, h/c/feed finals) and the gradients of
every differentiable operand. ``decoder_scan_ref`` has no ``lengths``, so
ragged cases are held to the reference's ``xla`` impl only. One tiny case
runs the reference's Pallas kernels in interpret mode. K7's dataflow is
held on the CPU: the blocks its owners publish in
each consumer's compact layout (``consumer_maps``, ``publish``) equal a
plain gather at every step, and ``plain_fwd_published`` equals
``plain_fwd`` in float64. The ``cuda``-marked tests (skipped without a
GPU) hold the CUDA kernels to the plain version.

Tolerances (float32, same arithmetic in a different summation order):
forward and gradients rtol 1e-4 with atol 1e-6. Kernel vs plain on the
card, per element: rtol 1e-4 with atol 1e-5 x max(1, max|ref|) over the
tensor, which implies ``chip_smoke.py``'s gate of 1e-3 x max(1, |ref|).
It was set from the card's readings at luong-nmt width: largest error
4.96e-5 in K8's gradients, whose largest element is ~95 (5.2e-7 of it);
K7 1.19e-6. So a dropped contribution of more than ~1e-5 of a tensor's
scale fails.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import decoder_scan as t_ds
from repro_torch.testing import require_cuda

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-6)
NL = 2
DIFF = ("gx0", "us", "ws", "bs", "w_feed", "w_comb", "enc_proj", "enc_out",
        "h0", "c0", "feed0")


def _inputs(T, B, S, H, seed=0, w_std=0.3):
    rng = np.random.default_rng(seed)
    G = 4 * H

    def m(shape, std=w_std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    sb = np.where(np.arange(S) < S - 1, 0.0, -1e30).astype(np.float32)
    return dict(gx0=m((T, B, G)), us=[m((H, G)) for _ in range(NL)],
                ws=[m((H, G)) for _ in range(NL - 1)],
                bs=[m((G,)) for _ in range(NL - 1)], w_feed=m((H, G)),
                w_comb=m((2 * H, H)), enc_proj=m((B, S, H)),
                enc_out=m((B, S, H)),
                score_bias=np.broadcast_to(sb, (B, S)).copy(),
                h0=m((NL, B, H), 0.5), c0=m((NL, B, H), 0.5),
                feed0=m((B, H), 0.5))


def _sites(kind, T, B, H, bs=4, seed=1):
    """2*NL numpy sites (keep_blocks | None, mask | None, bs, scale)."""
    rng = np.random.default_rng(seed)
    sites = []
    for i in range(2 * NL):
        k = ("off", "sf", "sp", "dp")[i % 4] if kind == "mixed" else kind
        if k == "off":
            sites.append((None, None, 1, 1.0))
        elif k in ("sf", "sp"):
            nb = H // bs
            rows = 1 if k == "sf" else T
            kb = np.stack([np.sort(rng.permutation(nb)[:nb // 2])
                           for _ in range(rows)]).astype(np.int32)
            sites.append((kb, None, bs, 2.0))
        else:
            rows = 1 if k == "df" else T
            dm = (rng.random((rows, B, H)) > 0.5).astype(np.float32)
            sites.append((None, dm, 1, 2.0))
    return sites


def _cotangents(T, B, H, seed=2):
    rng = np.random.default_rng(seed)
    return dict(wy=rng.standard_normal((T, B, H)).astype(np.float32),
                wh=rng.standard_normal((NL, B, H)).astype(np.float32),
                wc=rng.standard_normal((NL, B, H)).astype(np.float32),
                wf=rng.standard_normal((B, H)).astype(np.float32))


def _flat(d):
    out = []
    for k in DIFF:
        v = d[k]
        out.extend(v if isinstance(v, (list, tuple)) else [v])
    return out


def _port(args, sites, cot, lengths=None, impl="xla", device="cpu"):
    """Forward outputs and the grads of every DIFF operand, as numpy."""
    t = {k: ([torch.from_numpy(x).to(device).requires_grad_(k in DIFF) for x in v]
             if isinstance(v, list) else
             torch.from_numpy(v).to(device).requires_grad_(k in DIFF))
         for k, v in args.items()}
    ts = [(None if kb is None else torch.from_numpy(kb).to(device),
           None if dm is None else torch.from_numpy(dm).to(device), bs, sc)
          for kb, dm, bs, sc in sites]
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    htil, (hf, cf, ff) = t_ds.decoder_scan(**t, sites=ts, impl=impl, lengths=lens)
    c = {k: torch.from_numpy(v).to(device) for k, v in cot.items()}
    loss = ((htil * c["wy"]).sum() + (hf * c["wh"]).sum() + (cf * c["wc"]).sum()
            + (ff * c["wf"]).sum())
    grads = torch.autograd.grad(loss, _flat(t))
    as_np = lambda x: x.detach().cpu().numpy()
    return [as_np(x) for x in (htil, hf, cf, ff)], [as_np(g) for g in grads]


def _reference(args, sites, cot, lengths=None, fn="xla", interpret=None):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels import ops, ref
    J = lambda v: [jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v)
    a = {k: J(v) for k, v in args.items()}
    for k in ("us", "ws", "bs"):
        a[k] = tuple(a[k])
    js = tuple((None if kb is None else jnp.asarray(kb),
                None if dm is None else jnp.asarray(dm), bs, sc)
               for kb, dm, bs, sc in sites)
    if fn == "ref":
        run = lambda **kw: ref.decoder_scan_ref(**kw, sites=js)
    else:
        kw_l = {} if lengths is None else dict(
            lengths=jnp.asarray(np.asarray(lengths, np.int32)))
        run = lambda **kw: ops.decoder_scan(**kw, sites=js, impl=fn,
                                            interpret=interpret, **kw_l)
    c = {k: jnp.asarray(v) for k, v in cot.items()}

    def loss(d):
        htil, (hf, cf, ff) = run(**{**a, **d})
        return (jnp.sum(htil * c["wy"]) + jnp.sum(hf * c["wh"])
                + jnp.sum(cf * c["wc"]) + jnp.sum(ff * c["wf"]))

    d0 = {k: a[k] for k in DIFF}
    htil, (hf, cf, ff) = run(**a)
    g = jax.grad(loss)(d0)
    grads = []
    for k in DIFF:
        v = g[k]
        grads.extend(v if isinstance(v, tuple) else [v])
    return ([np.asarray(x) for x in (htil, hf, cf, ff)],
            [np.asarray(x) for x in grads])


def _names():
    out = []
    for k in DIFF:
        n = {"us": NL, "ws": NL - 1, "bs": NL - 1}.get(k)
        out.extend([k] if n is None else [f"{k}[{i}]" for i in range(n)])
    return out


def _assert_close(got, want, what, tol=TOL):
    (fo, gr), (fo_r, gr_r) = got, want
    for a, b, n in zip(fo, fo_r, ("htil", "h_fin", "c_fin", "feed_fin")):
        np.testing.assert_allclose(a, b, err_msg=f"{what} {n}", **tol)
    for a, b, n in zip(gr, gr_r, _names()):
        assert a.shape == b.shape, n
        np.testing.assert_allclose(a, b, err_msg=f"{what} d{n}", **tol)


T, B, S, H = 6, 3, 5, 16
KINDS = ["off", "sf", "sp", "df", "dp", "mixed"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_reference(kind):
    args, sites, cot = _inputs(T, B, S, H), _sites(kind, T, B, H), _cotangents(T, B, H)
    got = _port(args, sites, cot)
    _assert_close(got, _reference(args, sites, cot, fn="xla"), f"{kind} vs xla")
    _assert_close(got, _reference(args, sites, cot, fn="ref"), f"{kind} vs ref")


@pytest.mark.parametrize("kind", ["sp", "sf", "dp", "mixed"])
def test_plain_ragged_matches_reference(kind):
    args, sites, cot = _inputs(T, B, S, H, seed=3), _sites(kind, T, B, H, seed=4), \
        _cotangents(T, B, H, seed=5)
    lengths = [T, 3, 0]
    got = _port(args, sites, cot, lengths)
    _assert_close(got, _reference(args, sites, cot, lengths, fn="xla"),
                  f"{kind} ragged vs xla")


def test_ragged_full_lengths_equal_rectangular():
    args, sites, cot = _inputs(T, B, S, H, seed=6), _sites("mixed", T, B, H), \
        _cotangents(T, B, H)
    a = _port(args, sites, cot, [T] * B)
    b = _port(args, sites, cot)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        np.testing.assert_array_equal(x, y)


def test_plain_matches_pallas_interpret():
    """One tiny case against the reference's Pallas kernels (interpret)."""
    T_, B_, S_, H_ = 3, 2, 4, 8
    args, sites, cot = _inputs(T_, B_, S_, H_, seed=7), \
        _sites("mixed", T_, B_, H_), _cotangents(T_, B_, H_)
    _assert_close(_port(args, sites, cot),
                  _reference(args, sites, cot, fn="pallas", interpret=True),
                  "mixed vs pallas interpret")


def test_site_count_and_table_checks():
    args = _inputs(3, 2, 4, 8)
    t = {k: ([torch.from_numpy(x) for x in v] if isinstance(v, list)
             else torch.from_numpy(v)) for k, v in args.items()}
    with pytest.raises(ValueError, match="site entries"):
        t_ds.decoder_scan(**t, sites=[(None, None, 1, 1.0)] * 3)
    kb = torch.zeros((1, 1), dtype=torch.int32)
    dm = torch.ones((1, 2, 8))
    with pytest.raises(ValueError, match="at most one"):
        t_ds.decoder_scan(**t, sites=[(kb, dm, 1, 1.0)] * 4)
    with pytest.raises(ValueError, match="impl"):
        t_ds.decoder_scan(**t, sites=[(None, None, 1, 1.0)] * 4, impl="cuda")


@pytest.mark.parametrize("nl", [1, 3])
def test_kernels_reject_other_depths(nl):
    """K7/K8 take nl = 2 only: other depths raise before any launch."""
    T_, B_, S_, H_ = 2, 2, 3, 8
    G = 4 * H_
    z = lambda *shape: torch.zeros(shape)
    us, ws, bs = [z(H_, G)] * nl, [z(H_, G)] * (nl - 1), [z(G)] * (nl - 1)
    descs = [t_ds.SiteDesc("off", False, 1.0)] * (2 * nl)
    tables = [None] * (2 * nl)
    w_feed, w_comb, enc = z(H_, G), z(2 * H_, H_), z(B_, S_, H_)
    h0, c0, f0 = z(nl, B_, H_), z(nl, B_, H_), z(B_, H_)
    with pytest.raises(ValueError, match="take 2 layers"):
        t_ds.kernel_fwd(descs, tables, z(T_, B_, G), us, ws, bs, w_feed, w_comb,
                        enc, enc, z(B_, S_), h0, c0, f0, None)
    res = (z(T_, B_, H_), z(nl, T_, B_, G), z(nl, T_, B_, H_),
           z(nl, T_, B_, H_), z(T_, B_, S_))
    dout = (z(T_, B_, H_), h0, c0, f0)
    with pytest.raises(ValueError, match="take 2 layers"):
        t_ds.kernel_bwd(descs, tables, res, dout, us, ws, w_feed, w_comb, enc,
                        enc, h0, c0, f0, None)


# ---------------------------------------------------------------------------
# K7's dataflow: the consumer layouts its owners publish (CPU)
# ---------------------------------------------------------------------------


# (kind, lengths, H, block size): every site mode, PER_STEP and FIXED,
# mixed, ragged; H = 18 at block size 1 pads both the compact (k = 9) and
# the dense (H) rows to 4 floats
PUBLISHED = [(k, None, H, 4) for k in KINDS] + [("mixed", [T, 2, 0], H, 4),
                                                 ("sp", [T, 2, 0], 18, 1),
                                                 ("dp", None, 18, 1)]


@pytest.mark.parametrize("kind,lengths,H_,bs", PUBLISHED)
def test_published_layout_is_the_gather_and_feeds_the_plain_forward(kind, lengths, H_, bs):
    """``publish`` through ``consumer_maps``' inverse maps (alone or in one
    buffer) gives each site's
    compact row at every step: a plain gather of x[:, ids[t]] x scale
    (dense x mask x scale, off x), zeros past it; and the plain forward fed
    from those blocks (``plain_fwd_published``) equals ``plain_fwd`` in
    float64."""
    d64 = lambda v: [torch.from_numpy(x).double() for x in v] if isinstance(v, list) \
        else torch.from_numpy(v).double()
    args = {k: d64(v) for k, v in _inputs(T, B, S, H_, seed=41).items()}
    pairs = [t_ds._mk_site(None if kb is None else torch.from_numpy(kb),
                           None if dm is None else torch.from_numpy(dm).double(), b, sc)
             for kb, dm, b, sc in _sites(kind, T, B, H_, bs=bs, seed=42)]
    descs = tuple(p[0] for p in pairs)
    tables = tuple(p[1] for p in pairs)
    maps = t_ds.consumer_maps(descs, tables, H_)
    # the same maps built into one zeroed buffer, as the kernel's wrapper does
    buf = torch.zeros(t_ds.inv_words(descs, tables, H_), dtype=torch.int32)
    for (inv, kp), (inv2, kp2) in zip(maps, t_ds.consumer_maps(descs, tables, H_, buf)):
        assert kp == kp2 and (inv is None) == (inv2 is None)
        assert inv is None or torch.equal(inv, inv2)
    x = torch.from_numpy(np.random.default_rng(43).standard_normal((B, H_)))
    for i, (d, tab, (inv, kp)) in enumerate(zip(descs, tables, maps)):
        assert kp % 4 == 0
        for t in range(T):
            row = 0 if d.fixed else t
            if d.mode == "structured":
                want = x[:, tab[row].long()] * d.scale
            else:
                want = x * (tab[row] * d.scale if d.mode == "dense" else 1.0)
            got = t_ds.publish(x, d, tab, inv, kp, t)
            assert got.shape == (B, kp), (i, t)
            torch.testing.assert_close(got[:, :want.shape[1]], want, rtol=0, atol=0)
            assert not got[:, want.shape[1]:].any(), (i, t)
    keys = ("gx0", "us", "ws", "bs", "w_feed", "w_comb", "enc_proj", "enc_out",
            "score_bias", "h0", "c0", "feed0")
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    fargs = (descs, tables, *(args[k] for k in keys), lens)
    for g, w, n in zip(t_ds.plain_fwd_published(*fargs), t_ds.plain_fwd(*fargs),
                       ("htil", "gates", "hs", "cs", "alpha")):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12, msg=n)


# ---------------------------------------------------------------------------
# CUDA kernels (K7/K8) against the plain version, on the card
# ---------------------------------------------------------------------------


def _kernel_vs_plain(kind, T_, B_, S_, H_, bs, lengths=None, rate=0.5):
    dev = require_cuda()
    args = _inputs(T_, B_, S_, H_, seed=11, w_std=0.05)
    rng = np.random.default_rng(12)
    sites = []
    for i, k in enumerate(_sites(kind, T_, B_, H_, bs=bs, seed=13)):
        if k[0] is not None and rate != 0.5:          # exact-k at ``rate``
            nb = H_ // bs
            kept = nb - int(np.ceil(rate * nb))
            kb = np.stack([np.sort(rng.permutation(nb)[:kept])
                           for _ in range(k[0].shape[0])]).astype(np.int32)
            k = (kb, None, bs, nb / kept)
        sites.append(k)
    cot = _cotangents(T_, B_, H_, seed=14)
    kern = _port(args, sites, cot, lengths, impl="pallas", device=dev)
    plain = _port(args, sites, cot, lengths, impl="xla", device=dev)
    names = ["htil", "h_fin", "c_fin", "feed_fin"] + [f"d{n}" for n in _names()]
    for a, b, n in zip(kern[0] + kern[1], plain[0] + plain[1], names):
        np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=f"{kind} {n}",
                                   atol=1e-5 * max(1.0, float(np.abs(b).max())))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_kernels_small(kind):
    _kernel_vs_plain(kind, 7, 5, 6, 40, bs=4)


@pytest.mark.cuda
def test_cuda_kernels_small_ragged():
    _kernel_vs_plain("mixed", 7, 5, 6, 40, bs=4, lengths=[7, 3, 0, 5, 1])


@pytest.mark.cuda
def test_cuda_kernels_at_luong_nmt_width():
    """T=S=50, B=64, H=512, nl=2, structured per-step at p=0.3, bs=1."""
    _kernel_vs_plain("sp", 50, 64, 50, 512, bs=1, rate=0.3)


# ---------------------------------------------------------------------------
# K8's exchange: the host-side sizes; bits, float64 and the cluster layout's
# edge cases on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Q,J,P,B_,H_,T_", [(8, 5, 13, 64, 512, 50), (8, 1, 5, 5, 40, 7),
                                            (4, 2, 9, 6, 68, 1)])
def test_bwd_ring_words_hold_four_channels_and_four_keep_tables(Q, J, P, B_, H_, T_):
    from repro_torch.kernels import lstm_scan as t_ls
    words = t_ds.bwd_ring_words(Q, J, P, B_, H_, T_)
    channels = 4 * 2 * P * B_ * H_
    assert words == channels + 2 * P * Q + 2 + 2 * T_ * H_
    assert words == 3 * 2 * P * B_ * H_ + t_ls.ring_words(Q, J, P, B_, H_, 4 * T_)


def _k8_case(dev, kind, T_, B_, S_, H_, lengths=None, bs=1, rate=0.3, drop_low_at=None,
             seed=21):
    """K8's operands on the card (the plain forward's residuals): sites of
    ``kind`` at ``rate`` (structured ones keep an exact count a row; row
    ``drop_low_at`` keeps none of the units below H/2), callables for the
    kernel and the plain reverse in float32 and float64 (flat outputs)."""
    args = _inputs(T_, B_, S_, H_, seed=seed, w_std=0.05)
    rng = np.random.default_rng(seed + 1)
    sites = []
    for k in _sites(kind, T_, B_, H_, bs=bs, seed=seed + 2):
        if k[0] is not None:
            nb = H_ // bs
            kept = nb - int(np.ceil(rate * nb))
            kb = np.stack([np.sort(rng.permutation(nb)[:kept]) for _ in range(k[0].shape[0])])
            if drop_low_at is not None and kept <= nb // 2:
                kb[min(drop_low_at, len(kb) - 1)] = np.arange(nb - kept, nb)
            k = (kb.astype(np.int32), None, bs, nb / kept)
        sites.append(k)
    tt = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    o = {k: [tt(x) for x in v] if isinstance(v, list) else tt(v) for k, v in args.items()}
    pairs = [t_ds._mk_site(None if kb is None else tt(kb), None if dm is None else tt(dm), b, sc)
             for kb, dm, b, sc in sites]
    descs = tuple(p[0] for p in pairs)
    tables = tuple(None if p[1] is None else p[1].contiguous() for p in pairs)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
    res = t_ds.plain_fwd(descs, tables, o["gx0"], o["us"], o["ws"], o["bs"], o["w_feed"],
                         o["w_comb"], o["enc_proj"], o["enc_out"], o["score_bias"], o["h0"],
                         o["c0"], o["feed0"], lens)
    c = _cotangents(T_, B_, H_, seed=seed + 3)
    dout = tuple(tt(c[k]) for k in ("wy", "wh", "wc", "wf"))
    rest = (o["us"], o["ws"], o["w_feed"], o["w_comb"], o["enc_proj"], o["enc_out"], o["h0"],
            o["c0"], o["feed0"], lens)
    flat = lambda g: [x for v in g for x in (v if isinstance(v, list) else [v])]
    d = lambda v: [x.double() for x in v] if isinstance(v, (list, tuple)) else v.double()
    rest64 = tuple(d(x) if torch.is_tensor(x) or isinstance(x, list) else x
                   for x in rest[:-1]) + (lens,)
    return dict(kernel=lambda: flat(t_ds.kernel_bwd(descs, tables, res, dout, *rest)),
                plain=lambda: flat(t_ds.plain_bwd(descs, tables, res, dout, *rest)),
                f64=lambda: flat(t_ds.plain_bwd(descs, tables, tuple(d(res)), tuple(d(dout)),
                                                *rest64)))


def _assert_k8_matches_plain(case):
    for g, w, n in zip(case["kernel"](), case["plain"](), [f"d{n}" for n in _names()]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-4, err_msg=n,
                                   atol=1e-5 * max(1.0, w.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T_,B_,S_,H_", [("mixed", 7, 5, 6, 40), ("sp", 50, 64, 50, 512)])
def test_cuda_second_launch_gives_the_same_bits(kind, T_, B_, S_, H_):
    case = _k8_case(require_cuda(), kind, T_, B_, S_, H_)
    first, again = case["kernel"](), case["kernel"]()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T_,B_,S_,H_", [("mixed", 7, 5, 6, 40), ("dp", 7, 5, 6, 40),
                                              ("sp", 50, 64, 50, 512)])
def test_cuda_kernel_within_ten_times_plain_float32_of_float64(kind, T_, B_, S_, H_):
    """K6's gate: K8's distance to a float64 run of the plain reverse (on
    the same float32 residuals), max |err| / max(1, |ref|) over every
    output, within 10 x the float32 plain version's + 1e-6."""
    case = _k8_case(require_cuda(), kind, T_, B_, S_, H_)
    ref = case["f64"]()
    dist = lambda xs: max((x.double() - r).abs().max().item() / max(1.0, r.abs().max().item())
                          for x, r in zip(xs, ref))
    dk, dp = dist(case["kernel"]()), dist(case["plain"]())
    assert dk <= 10 * dp + 1e-6, (dk, dp)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(kind="mixed", T_=5, B_=6, S_=4, H_=48, lengths=[0, 5, 2, 5, 0, 1]),
    dict(kind="sp", T_=6, B_=4, S_=5, H_=516, drop_low_at=2, rate=0.5, lengths=[6, 0, 3, 6]),
    dict(kind="sf", T_=5, B_=3, S_=4, H_=516, drop_low_at=0, rate=0.5),
    dict(kind="dp", T_=5, B_=3, S_=4, H_=44, lengths=[5, 1, 0]),
])
def test_cuda_kernel_edge_cases_match_plain(kw):
    """Ragged rows of length 0 and T, a step that keeps no unit of half the
    CTAs, H not a multiple of the units a CTA (516 = 5 x 103 + 1)."""
    _assert_k8_matches_plain(_k8_case(require_cuda(), **kw))


def _k8_plan(dev, B_, H_, S_):
    """K8's launch plan: (Q, J, P) and whether it prefetches the residuals."""
    q, j, p = t_ds._bwd_plan(dev.index or 0, B_, H_, S_)
    mc, smem, pre = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    assert t_ds._lib().decoder_scan_bwd_clusters(B_, H_, S_, q, j, ctypes.byref(mc),
                                                 ctypes.byref(smem), ctypes.byref(pre)) == 0
    return (q, j, p), bool(pre.value)


@pytest.mark.cuda
@pytest.mark.parametrize("B_,want", [
    (192, lambda plan, pre: plan[0] == 8 and not pre),   # residuals read from global memory
    (256, lambda plan, pre: plan[0] < 8 and not pre),    # and smaller clusters
], ids=["q8_no_prefetch", "smaller_clusters_no_prefetch"])
def test_cuda_kernel_at_large_batch_plans(B_, want):
    """At H=512 a large batch leaves no room for the residual prefetch
    buffers (and at B=256 for clusters of 8): the kernel still matches the
    plain reverse and gives the same bits again."""
    dev = require_cuda()
    plan, pre = _k8_plan(dev, B_, 512, 8)
    assert want(plan, pre), (plan, pre)
    case = _k8_case(dev, "sp", 5, B_, 8, 512)
    _assert_k8_matches_plain(case)
    first, again = case["kernel"](), case["kernel"]()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K7 on the card: bits, float64 and edge cases
# ---------------------------------------------------------------------------


def _k7_case(dev, kind, T_, B_, S_, H_, lengths=None, bs=1, rate=0.3, drop_low_at=None,
             seed=31):
    """K7's operands on the card: sites of ``kind`` at ``rate`` (structured
    ones keep an exact count a row; row ``drop_low_at`` keeps none of the
    units below H/2), callables for the kernel and the plain
    forward in float32 and float64 (flat outputs: htil, gates, hs, cs,
    alpha)."""
    args = _inputs(T_, B_, S_, H_, seed=seed, w_std=0.05)
    rng = np.random.default_rng(seed + 1)
    sites = []
    for k in _sites(kind, T_, B_, H_, bs=bs, seed=seed + 2):
        if k[0] is not None:
            nb = H_ // bs
            kept = nb - int(np.ceil(rate * nb))
            kb = np.stack([np.sort(rng.permutation(nb)[:kept]) for _ in range(k[0].shape[0])])
            if drop_low_at is not None and kept <= nb // 2:
                kb[min(drop_low_at, len(kb) - 1)] = np.arange(nb - kept, nb)
            k = (kb.astype(np.int32), None, bs, nb / kept)
        sites.append(k)
    tt = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    o = {k: [tt(x) for x in v] if isinstance(v, list) else tt(v) for k, v in args.items()}
    pairs = [t_ds._mk_site(None if kb is None else tt(kb), None if dm is None else tt(dm), b, sc)
             for kb, dm, b, sc in sites]
    descs = tuple(p[0] for p in pairs)
    tables = tuple(None if p[1] is None else p[1].contiguous() for p in pairs)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
    keys = ("gx0", "us", "ws", "bs", "w_feed", "w_comb", "enc_proj", "enc_out", "score_bias",
            "h0", "c0", "feed0")
    d = lambda v: [x.double() for x in v] if isinstance(v, list) else v.double()
    return dict(kernel=lambda: list(t_ds.kernel_fwd(descs, tables, *(o[k] for k in keys), lens)),
                plain=lambda: list(t_ds.plain_fwd(descs, tables, *(o[k] for k in keys), lens)),
                f64=lambda: list(t_ds.plain_fwd(descs, tables, *(d(o[k]) for k in keys), lens)))


def _assert_k7_matches_plain(case):
    for g, w, n in zip(case["kernel"](), case["plain"](), ("htil", "gates", "hs", "cs", "alpha")):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-4, err_msg=n,
                                   atol=1e-5 * max(1.0, w.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T_,B_,S_,H_", [("mixed", 7, 5, 6, 40), ("sp", 50, 64, 50, 512)])
def test_cuda_forward_second_launch_gives_the_same_bits(kind, T_, B_, S_, H_):
    case = _k7_case(require_cuda(), kind, T_, B_, S_, H_)
    first, again = case["kernel"](), case["kernel"]()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,T_,B_,S_,H_", [("mixed", 7, 5, 6, 40), ("dp", 7, 5, 6, 40),
                                              ("sp", 50, 64, 50, 512)])
def test_cuda_forward_within_ten_times_plain_float32_of_float64(kind, T_, B_, S_, H_):
    """K7's distance to a float64 run of the plain forward, max |err| /
    max(1, |ref|) over every output, within 10 x the float32 plain
    version's + 1e-6."""
    case = _k7_case(require_cuda(), kind, T_, B_, S_, H_)
    ref = case["f64"]()
    dist = lambda xs: max((x.double() - r).abs().max().item() / max(1.0, r.abs().max().item())
                          for x, r in zip(xs, ref))
    dk, dp = dist(case["kernel"]()), dist(case["plain"]())
    assert dk <= 10 * dp + 1e-6, (dk, dp)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(kind="mixed", T_=5, B_=1, S_=4, H_=40),                   # one batch row
    dict(kind="mixed", T_=5, B_=6, S_=4, H_=48, lengths=[0, 5, 2, 5, 0, 1]),
    dict(kind="sp", T_=6, B_=4, S_=5, H_=516, drop_low_at=2, rate=0.5, lengths=[6, 0, 3, 6]),
    dict(kind="sf", T_=5, B_=3, S_=4, H_=516, drop_low_at=0, rate=0.5),
    dict(kind="dp", T_=5, B_=3, S_=4, H_=44, lengths=[5, 1, 0]),
    dict(kind="off", T_=4, B_=3, S_=7, H_=42),                     # H % 4 != 0
    dict(kind="df", T_=4, B_=40, S_=3, H_=40, lengths=[4, 0, 1] * 13 + [2]),
])
def test_cuda_forward_edge_cases_match_plain(kw):
    """One row, ragged rows of length 0 and T, a step that keeps no unit of
    half the CTAs, H not a multiple of the units a CTA (516 = 4 x 129) or of
    4, more rows than CTAs a row."""
    _assert_k7_matches_plain(_k7_case(require_cuda(), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("B_", [192, 256])
def test_cuda_forward_at_large_batch(B_):
    """At H=512 a large batch still matches the plain forward and gives the
    same bits again (in row blocks of 64)."""
    case = _k7_case(require_cuda(), "sp", 4, B_, 8, 512)
    _assert_k7_matches_plain(case)
    first, again = case["kernel"](), case["kernel"]()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_forward_refuses_a_shape_without_a_plan():
    """H = 1024 needs 8 units a CTA on the card, past K7's 4: its plan and
    a launch raise a CUDA error."""
    dev = require_cuda()
    with pytest.raises(RuntimeError, match="decoder_scan forward plan"):
        t_ds._tma_plan(dev.index or 0, 64, 1024, 8)
    case = _k7_case(dev, "sp", 2, 64, 8, 1024)
    with pytest.raises(RuntimeError, match="decoder_scan forward plan"):
        case["kernel"]()
