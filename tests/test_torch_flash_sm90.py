"""The bfloat16 route of the port's flash attention: K9, K10 and K11 on
Hopper's wgmma and TMA (``csrc/flash_attention_sm90.cu``, ``route() ==
"wgmma"``).

On the CPU: which kernel each (pass, dtype, head_dim) takes (bfloat16 at
head_dim 64, 128 and 256: all three on wgmma); the copies ``_prep`` makes
for TMA (16-byte bases and strides); K10's and K11's split of their
float32 p and ds into two bfloat16 terms (to 2^-16 of |x|, and dq, dk and
dv from the split terms, bfloat16 products summed in float32, within 1.5 x
the bfloat16 plain version's float64 distance, at head_dim 64 and 256);
and the plain versions in bfloat16 against the JAX reference's
Pallas kernel in interpret mode (``tests/test_flash.py``'s way) at the new
route's small shapes, within the reference's bfloat16 tolerance 3e-2 x
max(1, |ref|).

The ``cuda``-marked cases hold the new kernels to the plain versions on
the card (3e-2 x max(1, |ref|)) and to float64 (10 x the bfloat16 plain
version's distance + 1e-6), to their own bits on a second launch, and on
strided views that need no copy, at head_dim 64, 128 and 256, and
bfloat16 K9-K11 at whisper-base's and gemma-2b's attention shapes the same
way; they skip here. This module imports JAX only inside the reference
test, so the card (which has no JAX) runs the rest: ``PYTHONPATH=src
python -m pytest -q --noconftest -m cuda tests/test_torch_flash_sm90.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.testing import require_cuda

torch.set_num_threads(1)
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# the route and the copies TMA needs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("which", ["flash_fwd", "flash_dq", "flash_dkv"])
def test_route(which, dtype, d):
    want = "wgmma" if dtype == BF16 and d in (64, 128, 256) else "tf32"
    assert fa.route(which, dtype, d) == want
    assert f"{which}/{want}" in fa.LAUNCHES_BY_ROUTE


def _offset_view(shape, elems):
    """A bfloat16 (B, S, H, d) view starting ``elems`` elements into its
    storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + 64, dtype=BF16)[elems:elems + n].view(shape)


@pytest.mark.parametrize("case,copied", [
    ("aligned", {"wgmma": False, "tf32": False}),
    ("offset_8_bytes", {"wgmma": True, "tf32": False}),
    ("stride_24_bytes", {"wgmma": True, "tf32": False}),
    ("head_slice", {"wgmma": False, "tf32": False}),
    ("d_not_contiguous", {"wgmma": True, "tf32": True}),
])
def test_prep_copies_what_tma_cannot_read(case, copied):
    base = _offset_view((2, 10, 4, 64), 0)
    assert base.data_ptr() % 64 == 0
    x = {"aligned": base,
         "offset_8_bytes": _offset_view((2, 10, 4, 64), 4),
         "stride_24_bytes": torch.zeros(2, 10, 1, 12, dtype=BF16)[..., :8],
         "head_slice": torch.zeros(2, 10, 7, 64, dtype=BF16)[:, :, 1:5],
         "d_not_contiguous": torch.zeros(2, 64, 4, 10, dtype=BF16).transpose(1, 3)}[case]
    for r, want in copied.items():
        got = fa._prep(x, r)
        assert (got.data_ptr() != x.data_ptr()) == want, r
        torch.testing.assert_close(got, x, rtol=0, atol=0)
        if r == "wgmma":
            assert got.data_ptr() % 16 == 0
            assert all(s % 8 == 0 for s in got.stride()[:3]) and got.stride(-1) == 1


# ---------------------------------------------------------------------------
# K10's and K11's two-term split of p and ds
# ---------------------------------------------------------------------------


def _split(x):
    """x (float32) = hi + lo, each a bfloat16 value rounded to nearest: the
    A operands K10's and K11's wgmma route issues for p and ds."""
    hi = x.to(BF16).float()
    return hi, (x - hi).to(BF16).float()


@pytest.mark.parametrize("what", ["p", "ds"])
def test_two_bfloat16_terms_carry_float32_to_2_16(what):
    g = torch.Generator().manual_seed(0)
    if what == "p":
        x = torch.rand(200_000, generator=g)
    else:
        x = (torch.randn(200_000, generator=g)
             * 10.0 ** (torch.rand(200_000, generator=g) * 10 - 8))
    assert what == "p" or ((x < 0).any() and (x > 0).any())
    hi, lo = _split(x)
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert (err <= 2.0 ** -16 * x.double().abs()).all()
    # one bfloat16 term alone misses it
    assert ((hi.double() - x.double()).abs() > 2.0 ** -16 * x.double().abs()).any()


def _dkv_split(q, k, v, do, lse, delta, causal, window):
    """dk, dv as K11's wgmma route forms them: p and ds in float32 from the
    bfloat16 inputs, each split into two bfloat16 terms, every product one of
    bfloat16 values (exact in float32) summed in float32, rounded to
    bfloat16 at the end."""
    p, ds = fa._probs_and_ds(q, k, v, do, lse, delta, causal, window)
    B, Sk, Hkv, d = k.shape
    G = q.shape[2] // Hkv
    out = []
    for x, y in ((ds, q), (p, do)):
        hi, lo = _split(x)
        y = y.float()
        g = (torch.einsum("bhqk,bqhd->bkhd", hi, y)
             + torch.einsum("bhqk,bqhd->bkhd", lo, y))
        out.append(g.reshape(B, Sk, Hkv, G, d).sum(3).to(BF16))
    return tuple(out)


def _dq_split(q, k, v, do, lse, delta, causal, window):
    """dq as K10's wgmma route forms it: ds in float32 from the bfloat16
    inputs, split into two bfloat16 terms; dq summed in float32 over
    k-steps of 16 keys in key order, ds_hi k then ds_lo k in each (every
    product one of bfloat16 values, exact in float32), rounded to bfloat16
    at the end."""
    _, ds = fa._probs_and_ds(q, k, v, do, lse, delta, causal, window)
    kr = fa._repeat_kv(k, q.shape[2] // k.shape[2]).float()
    hi, lo = _split(ds)
    dq = torch.zeros(q.shape)
    for k0 in range(0, k.shape[1], 16):
        ks = slice(k0, k0 + 16)
        for term in (hi, lo):
            dq += torch.einsum("bhqk,bkhd->bqhd", term[..., ks], kr[:, ks])
    return dq.to(BF16)


def _float64_backward(window, d=64):
    """bfloat16 inputs (B 1, S 100, 4 query heads over 2, head_dim ``d``),
    the backward's arguments with lse and delta from the float64 forward,
    and the float64 dq (Sq, G, d), dk and dv (Sk, d) of each kv head."""
    g = torch.Generator().manual_seed(1)
    B, S, Hq, Hkv = 1, 100, 4, 2
    q, k, v, do = (torch.randn(*s, generator=g).to(BF16) for s in (
        (B, S, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d), (B, S, Hq, d)))
    G = Hq // Hkv
    lse = torch.empty(B, Hq, S)
    delta = torch.empty(B, Hq, S)
    want = []
    for hk in range(Hkv):
        lse64, delta64, dq64, dk64, dv64 = fa.backward_float64(q, k, v, do, True, window, 0, hk)
        lse[0, hk * G:(hk + 1) * G], delta[0, hk * G:(hk + 1) * G] = lse64, delta64
        want.append((dq64, dk64, dv64))
    return (q, k, v, do, lse, delta, True, window), want


def _rel(x, w):
    return float((x.double() - w).abs().max()) / max(1.0, float(w.abs().max()))


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("window", [None, 32])
def test_split_dk_dv_keep_the_plain_float64_distance(window, d):
    """At head_dim 256 K11's two warpgroups split the work by role: the
    first forms p, hands it to the second in float32 through shared memory
    and accumulates dv from p's two terms, the second forms ds from that p
    and accumulates dk from ds's two terms. The hand-off is exact, so the
    terms and products are ``_dkv_split``'s at every head_dim."""
    args, want = _float64_backward(window, d)

    def dist(pair):
        return max(_rel(x[0, :, hk], w) for hk, ws in enumerate(want)
                   for x, w in zip(pair, ws[1:]))

    split, plain = dist(_dkv_split(*args)), dist(fa.flash_dkv_plain(*args))
    assert 0 < split <= 1.5 * plain, (split, plain)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("window", [None, 32])
def test_split_dq_keeps_the_plain_float64_distance(window, d):
    """K10's kv tiles hold 64 keys at head_dim 64 and 128 and 32 at 256
    (q and do take 128 KB of shared memory there); each warpgroup keeps its
    64 rows' dq in registers and adds the k-steps of 16 keys in key order,
    hi then lo, at every head_dim: ``_dq_split``'s terms and order."""
    args, want = _float64_backward(window, d)
    G = args[0].shape[2] // args[1].shape[2]

    def dist(dq):
        return max(_rel(dq[0, :, hk * G:(hk + 1) * G], ws[0]) for hk, ws in enumerate(want))

    split, plain = dist(_dq_split(*args)), dist(fa.flash_dq_plain(*args))
    assert 0 < split <= 1.5 * plain, (split, plain)


# ---------------------------------------------------------------------------
# the plain versions in bfloat16 against the reference at the route's shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,d,causal,window,bq,bk", [
    (1, 100, 100, 6, 2, 64, True, None, 50, 50),      # G 3, S 100
    (1, 100, 100, 4, 2, 64, True, 32, 50, 50),        # window
    (1, 80, 144, 4, 2, 128, True, None, 40, 48),      # Sq < Sk
    (1, 144, 80, 4, 2, 128, False, None, 48, 40),     # Sq > Sk
    (1, 64, 64, 2, 1, 256, True, None, 32, 32),       # head_dim 256, G 2
])
def test_plain_bf16_matches_reference(B, Sq, Sk, Hq, Hkv, d, causal, window, bq, bk):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as r_flash

    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sq, Hq, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d), (B, Sq, Hq, d)))
    jx = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    o_r, vjp = jax.vjp(lambda *a: r_flash(*a, causal, window, bq, bk, True), *jx)
    _, dk_r, dv_r = vjp(jnp.asarray(do, jnp.bfloat16))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(BF16) for x in (q, k, v, do))
    o, lse = fa.attention_plain(tq, tk, tv, causal, window)
    dk, dv = fa.flash_dkv_plain(tq, tk, tv, tdo, lse, fa.flash_delta(o, tdo), causal, window)
    for got, ref, name in ((o, o_r, "o"), (dk, dk_r, "dk"), (dv, dv_r, "dv")):
        assert got.dtype == BF16, name
        ref = np.asarray(ref, np.float32)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3e-2 * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the kernels on the card (skip without one)
# ---------------------------------------------------------------------------

CUDA_CASES = [
    # B, Sq, Sk, Hq, Hkv, d, causal, window
    (2, 128, 128, 4, 2, 64, True, None),
    (2, 128, 128, 4, 2, 128, True, None),
    (1, 100, 100, 6, 2, 128, True, 40),       # G 3, window, ragged tiles
    (1, 100, 100, 9, 3, 64, True, 40),
    (2, 64, 64, 4, 1, 128, False, None),      # MQA, non-causal
    (1, 80, 144, 4, 2, 64, True, None),       # Sq < Sk
    (1, 144, 80, 4, 2, 128, True, None),      # Sq > Sk
    (1, 511, 511, 8, 4, 128, True, None),     # the serving prefill's S
    (1, 384, 384, 4, 2, 128, False, 256),     # window 256, non-causal
    (2, 128, 128, 4, 2, 256, True, None),     # head_dim 256
    (1, 100, 100, 6, 2, 256, True, 40),       # G 3, window, ragged tiles
    (1, 80, 144, 4, 2, 256, True, None),      # Sq < Sk
    (1, 144, 80, 4, 2, 256, False, None),     # Sq > Sk, non-causal
]


# {pass/route: launches} of one forward, dq and dk/dv in bfloat16 at head_dim
# 64, 128 or 256: all on wgmma
WGMMA_ONCE = {f"{p}/{r}": int(r == "wgmma") for p in ("flash_fwd", "flash_dq", "flash_dkv")
              for r in ("wgmma", "tf32")}


def _inputs(dev, B, Sq, Sk, Hq, Hkv, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=g).to(dev, BF16) for s in (
        (B, Sq, Hq, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d), (B, Sq, Hq, d))]


def _close(got, want):
    scale = max(1.0, float(want.detach().float().abs().max()))
    torch.testing.assert_close(got.detach().float(), want.detach().float(), rtol=0,
                               atol=3e-2 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,d,causal,window", CUDA_CASES)
def test_cuda_kernels_match_plain(B, Sq, Sk, Hq, Hkv, d, causal, window):
    dev = require_cuda()
    q, k, v, do = _inputs(dev, B, Sq, Sk, Hq, Hkv, d)
    before = dict(fa.LAUNCHES_BY_ROUTE)
    o_p, lse_p = fa.attention_plain(q, k, v, causal, window)
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, window)
    _close(o, o_p)
    _close(lse, lse_p)
    args = (q, k, v, do, lse_p, fa.flash_delta(o_p, do), causal, window)
    dq = fa.flash_dq_cuda(*args)
    assert dq.dtype == BF16 and dq.shape == q.shape
    _close(dq, fa.flash_dq_plain(*args))
    for got, want in zip(fa.flash_dkv_cuda(*args), fa.flash_dkv_plain(*args)):
        _close(got, want)
    assert {n: fa.LAUNCHES_BY_ROUTE[n] - before[n] for n in before} == WGMMA_ONCE


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_kernels_keep_the_plain_float64_distance(d):
    """o, lse, dq, dk and dv of every (batch, kv head) group within 10 x the
    bfloat16 plain version's distance to float64 + 1e-6 (the chip_smoke
    gate); the backward takes lse and delta from the float64 forward."""
    dev = require_cuda()
    B, S, Hq, Hkv = 1, 700, 4, 2
    q, k, v, do = _inputs(dev, B, S, S, Hq, Hkv, d, seed=4)
    G = Hq // Hkv
    o, lse = fa.flash_fwd_cuda(q, k, v)
    o_p, lse_p = fa.attention_plain(q, k, v)
    lse64 = torch.empty(B, Hq, S, device=dev)
    delta64 = torch.empty_like(lse64)
    rel = lambda x, w: float((x.double() - w).abs().max()) / max(1.0, float(w.abs().max()))
    groups = []
    for hk in range(Hkv):
        hs = slice(hk * G, (hk + 1) * G)
        fo, fl = fa.forward_float64(q, k, v, True, None, 0, hk)
        l64, d64, dq64, dk64, dv64 = fa.backward_float64(q, k, v, do, True, None, 0, hk)
        lse64[0, hs], delta64[0, hs] = l64, d64
        groups.append((hs, hk, fo, fl, dq64, dk64, dv64))
    args = (q, k, v, do, lse64, delta64, True, None)
    dq, dq_p = fa.flash_dq_cuda(*args), fa.flash_dq_plain(*args)
    (dk, dv), (dk_p, dv_p) = fa.flash_dkv_cuda(*args), fa.flash_dkv_plain(*args)
    for hs, hk, fo, fl, dq64, dk64, dv64 in groups:
        for got, plain, ref, name in ((o[0, :, hs], o_p[0, :, hs], fo, "o"),
                                      (lse[0, hs], lse_p[0, hs], fl, "lse"),
                                      (dq[0, :, hs], dq_p[0, :, hs], dq64, "dq"),
                                      (dk[0, :, hk], dk_p[0, :, hk], dk64, "dk"),
                                      (dv[0, :, hk], dv_p[0, :, hk], dv64, "dv")):
            kernel, yard = rel(got, ref), rel(plain, ref)
            assert kernel <= 10 * yard + 1e-6, (name, hk, kernel, yard)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_kernels_are_deterministic(d):
    """Two launches of each give the same bits (no atomics)."""
    dev = require_cuda()
    q, k, v, do = _inputs(dev, 2, 300, 300, 8, 2, d, seed=5)
    o, lse = fa.flash_fwd_cuda(q, k, v)
    args = (q, k, v, do, lse, fa.flash_delta(o, do), True, None)
    first = (o, lse, fa.flash_dq_cuda(*args), *fa.flash_dkv_cuda(*args))
    second = (*fa.flash_fwd_cuda(q, k, v), fa.flash_dq_cuda(*args),
              *fa.flash_dkv_cuda(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_kernels_read_strided_views(d):
    """q, k, v and do as head slices of wider tensors: 16-byte strides and
    bases, so TMA reads them in place (no copy) through their strides."""
    dev = require_cuda()
    g = torch.Generator().manual_seed(2)
    wide = lambda B, S, H: torch.randn(B, S, H + 3, d, generator=g).to(dev, BF16)[:, :, 1:H + 1]
    q, do = wide(2, 70, 4), wide(2, 70, 4)
    k, v = wide(2, 70, 2), wide(2, 70, 2)
    for x in (q, k, v, do):
        assert not x.is_contiguous() and fa._prep(x, "wgmma").data_ptr() == x.data_ptr()
    o_p, lse_p = fa.attention_plain(q, k, v, True, None)
    o, lse = fa.flash_fwd_cuda(q, k, v, True, None)
    _close(o, o_p)
    _close(lse, lse_p)
    args = (q, k, v, do, lse_p, fa.flash_delta(o_p, do), True, None)
    _close(fa.flash_dq_cuda(*args), fa.flash_dq_plain(*args))
    for got, want in zip(fa.flash_dkv_cuda(*args), fa.flash_dkv_plain(*args)):
        _close(got, want)


# whisper-base's attention (8 heads of 64, the encoder non-causal over
# sequences that are no multiple of the tile, up to its 1500 frames, the
# decoder causal over its 448 tokens) and gemma-2b's (8 query heads over its
# one kv head repeated 8 times, head_dim 256, S 4096), and their serving
# prefills (gemma-2b 8 x 511 prompt tokens, whisper-base's decoder 8 x 3):
# every pass on the wgmma route
MODEL_CASES = [
    # B, S, Hq, Hkv, d, causal
    (1, 100, 8, 8, 64, False),
    (1, 1500, 8, 8, 64, False),
    (2, 448, 8, 8, 64, True),
    (1, 4096, 8, 8, 256, True),
    (8, 511, 8, 8, 256, True),
    (8, 3, 8, 8, 64, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,d,causal", MODEL_CASES)
def test_cuda_model_shapes(B, S, Hq, Hkv, d, causal):
    """At whisper-base's and gemma-2b's shapes: each pass on wgmma; o,
    lse, dq, dk and dv within 3e-2 x max(1, |ref|) of the plain version and,
    over every (batch, kv head) group, within 10 x the bfloat16 plain
    version's distance to float64 + 1e-6 (the backward on the float64
    forward's lse and delta); a second launch gives the same bits."""
    dev = require_cuda()
    q, k, v, do = _inputs(dev, B, S, S, Hq, Hkv, d, seed=6)
    before = dict(fa.LAUNCHES_BY_ROUTE)
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, None)
    o_p, lse_p = fa.attention_plain(q, k, v, causal, None)
    _close(o, o_p)
    _close(lse, lse_p)
    G = Hq // Hkv
    lse64 = torch.empty(B, Hq, S, device=dev)
    delta64 = torch.empty_like(lse64)
    rel = lambda x, w: float((x.double() - w).abs().max()) / max(1.0, float(w.abs().max()))
    groups = []
    for b in range(B):
        for hk in range(Hkv):
            hs = slice(hk * G, (hk + 1) * G)
            fo, fl = fa.forward_float64(q, k, v, causal, None, b, hk)
            l64, d64, dq64, dk64, dv64 = fa.backward_float64(q, k, v, do, causal, None, b, hk)
            lse64[b, hs], delta64[b, hs] = l64, d64
            groups.append((b, hs, hk, fo, fl, dq64, dk64, dv64))
    args = (q, k, v, do, lse64, delta64, causal, None)
    dq, dq_p = fa.flash_dq_cuda(*args), fa.flash_dq_plain(*args)
    (dk, dv), (dk_p, dv_p) = fa.flash_dkv_cuda(*args), fa.flash_dkv_plain(*args)
    assert {n: fa.LAUNCHES_BY_ROUTE[n] - before[n] for n in before} == WGMMA_ONCE
    _close(dq, dq_p)
    for got, want in ((dk, dk_p), (dv, dv_p)):
        _close(got, want)
    for b, hs, hk, fo, fl, dq64, dk64, dv64 in groups:
        for got, plain, ref, name in ((o[b, :, hs], o_p[b, :, hs], fo, "o"),
                                      (lse[b, hs], lse_p[b, hs], fl, "lse"),
                                      (dq[b, :, hs], dq_p[b, :, hs], dq64, "dq"),
                                      (dk[b, :, hk], dk_p[b, :, hk], dk64, "dk"),
                                      (dv[b, :, hk], dv_p[b, :, hk], dv64, "dv")):
            kernel, yard = rel(got, ref), rel(plain, ref)
            assert kernel <= 10 * yard + 1e-6, (name, b, hk, kernel, yard)
    again = (*fa.flash_fwd_cuda(q, k, v, causal, None), fa.flash_dq_cuda(*args),
             *fa.flash_dkv_cuda(*args))
    for a, b_ in zip((o, lse, dq, dk, dv), again):
        assert torch.equal(a, b_)
