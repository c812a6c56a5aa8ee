"""K3/K4 fused LSTM scan: the port's forward and hand-written reverse
against the reference's ``lstm_scan(impl="pallas")`` (interpret mode).

Sweeps RH mode (structured / dense / off) x time pattern (per-step / FIXED
one-row) x ragged ``lengths``: (hs, h_fin, c_fin) and the gradients of
(gx, U, h0, c0) for the loss ``sum(hs^2) + sum(h_fin * c_fin)``. The
port's reverse is also held to ``torch.autograd`` of its plain forward.
On the CPU the port runs the kernels' plain versions; the ``cuda``-marked
tests (skipped without a GPU) hold the CUDA kernels to them.

Tolerances: float32, different summation order: forward rtol/atol 1e-5,
gradients rtol/atol 1e-4 (they sum over all T steps).
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import cell_scan as t_cs
from repro_torch.kernels import lstm_scan as t_ls
from repro_torch.testing import require_cuda

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
T, B, H = 5, 3, 16


def _inputs(mode, fixed, ragged, seed=0, T=T, B=B, H=H, bs=4, rate=0.5, u_std=0.1):
    rng = np.random.default_rng(seed)
    d = dict(gx=rng.standard_normal((T, B, 4 * H)).astype(np.float32) * 0.3,
             u=rng.standard_normal((H, 4 * H)).astype(np.float32) * u_std,
             h0=rng.standard_normal((B, H)).astype(np.float32) * 0.5,
             c0=rng.standard_normal((B, H)).astype(np.float32) * 0.5)
    rows = 1 if fixed else T
    kw = {}
    if mode == "structured":
        nb = H // bs
        kb = np.stack([np.sort(rng.permutation(nb)[:nb // 2]) for _ in range(rows)])
        kw = dict(keep_blocks=kb.astype(np.int32), block_size=bs, scale=2.0)
    elif mode == "dense":
        kw = dict(dense_mask=(rng.random((rows, B, H)) > rate).astype(np.float32),
                  scale=1.0 / (1.0 - rate))
    if ragged:
        kw["lengths"] = np.array([T, 2, 0][:B] + [T] * (B - 3), np.int32)
    return d, kw


def _port(d, kw, impl="pallas", device="cpu"):
    ins = [torch.from_numpy(d[k]).to(device).requires_grad_(True)
           for k in ("gx", "u", "h0", "c0")]
    tkw = {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    hs, (hf, cf) = t_ls.lstm_scan(*ins, impl=impl, **tkw)
    loss = (hs ** 2).sum() + (hf * cf).sum()
    grads = torch.autograd.grad(loss, ins)
    return [x.detach().cpu().numpy() for x in (hs, hf, cf, *grads)]


CASES = [(m, f, r) for m in ("structured", "dense", "off")
         for f in ((False, True) if m != "off" else (False,))
         for r in (False, True)]


@pytest.fixture(scope="module")
def ref_ops():
    jax = pytest.importorskip("jax")
    from repro.kernels import ops
    return jax, ops


@pytest.mark.parametrize("mode,fixed,ragged", CASES)
def test_matches_reference_pallas(ref_ops, mode, fixed, ragged):
    jax, ops = ref_ops
    d, kw = _inputs(mode, fixed, ragged)

    def loss(gx, u, h0, c0):
        hs, (hf, cf) = ops.lstm_scan(gx, u, h0, c0, impl="pallas", **kw)
        return (hs ** 2).sum() + (hf * cf).sum(), (hs, hf, cf)

    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        d["gx"], d["u"], d["h0"], d["c0"])
    got = _port(d, kw)
    for g, w, nm in zip(got[:3], outs, ("hs", "h_fin", "c_fin")):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=nm, **FWD)
    for g, w, nm in zip(got[3:], grads, ("gx", "U", "h0", "c0")):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"d{nm}", **GRAD)


@pytest.mark.parametrize("mode,fixed,ragged", CASES)
def test_reverse_matches_autograd_of_plain_forward(mode, fixed, ragged):
    d, kw = _inputs(mode, fixed, ragged, seed=1)
    got = _port(d, kw)
    ins = [torch.from_numpy(d[k]).requires_grad_(True) for k in ("gx", "u", "h0", "c0")]
    ids = None
    if "keep_blocks" in kw:
        kb = torch.from_numpy(kw["keep_blocks"])
        ids = (kb[..., None] * kw["block_size"] + torch.arange(kw["block_size"])).flatten(1)
    mask = torch.from_numpy(kw["dense_mask"]) if "dense_mask" in kw else None
    lengths = torch.from_numpy(kw["lengths"]) if "lengths" in kw else None
    hs, _, (cs,) = t_cs.plain_fwd(t_ls.lstm_cell_spec(0.0), ins[0], ins[1], ins[2],
                                  (ins[3],), ids, mask, lengths, kw.get("scale", 1.0))
    loss = (hs ** 2).sum() + (hs[-1] * cs[-1]).sum()
    want = torch.autograd.grad(loss, ins)
    for g, w, nm in zip(got[3:], want, ("gx", "U", "h0", "c0")):
        np.testing.assert_allclose(g, w.numpy(), err_msg=f"d{nm}", **GRAD)


def test_xla_impl_equals_pallas_impl_on_cpu():
    d, kw = _inputs("structured", False, True, seed=2)
    for a, b in zip(_port(d, kw, impl="xla"), _port(d, kw, impl="pallas")):
        np.testing.assert_array_equal(a, b)


def test_per_step_masks_differ():
    d, kw = _inputs("structured", False, False, seed=3)
    kw1 = dict(kw, keep_blocks=np.broadcast_to(kw["keep_blocks"][:1],
                                                kw["keep_blocks"].shape).copy())
    assert not np.allclose(_port(d, kw)[0], _port(d, kw1)[0])


def test_both_masks_raise():
    d, kw = _inputs("structured", False, False)
    with pytest.raises(ValueError):
        t_ls.lstm_scan(*(torch.from_numpy(d[k]) for k in ("gx", "u", "h0", "c0")),
                       keep_blocks=torch.from_numpy(kw["keep_blocks"]),
                       dense_mask=torch.ones(T, B, H), block_size=4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,fixed,ragged", CASES)
def test_cuda_kernels_match_plain(mode, fixed, ragged):
    dev = require_cuda()
    d, kw = _inputs(mode, fixed, ragged, seed=4, T=7, B=5, H=40, bs=1)
    n0 = dict(t_ls.LAUNCHES)
    got = _port(d, kw, device=dev)
    assert t_ls.LAUNCHES["lstm_scan_fwd"] == n0["lstm_scan_fwd"] + 1
    assert t_ls.LAUNCHES["lstm_scan_bwd"] == n0["lstm_scan_bwd"] + 1
    for g, w in zip(got, _port(d, kw)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_kernels_at_zaremba_medium_width():
    # U at the model's own scale (init uniform in +-0.05). With std 0.1 at
    # H=650 the recurrence amplifies rounding over the 35 steps, so that
    # the float32 plain version itself is ~4e-4 off a float64 run in dU.
    dev = require_cuda()
    d, kw = _inputs("structured", False, False, seed=5, T=35, B=20, H=650, bs=1,
                    u_std=0.05)
    for g, w in zip(_port(d, kw, device=dev), _port(d, kw)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# K4's cluster layout (csrc/scan_exchange.cuh): the host-side plan
# ---------------------------------------------------------------------------

# one-CTA-an-SM clusters resident at once on a 132-SM H100 (15 of 8 read by
# launch/scan_bench.py's probe)
_RESIDENT = {8: 15, 4: 33, 2: 66, 1: 132}


def _fits(H_, resident=_RESIDENT):
    return lambda q, j: t_ls.n_clusters(H_, j, q) <= resident[q]


@pytest.mark.parametrize("H_,J_,Q_,want", [(650, 6, 8, 14), (512, 5, 8, 13), (1500, 13, 8, 15),
                                           (40, 1, 8, 5), (64, 8, 8, 1), (65, 8, 8, 2),
                                           (7, 3, 1, 3)])
def test_n_clusters_covers_the_units_with_the_fewest_clusters(H_, J_, Q_, want):
    P = t_ls.n_clusters(H_, J_, Q_)
    assert P == want
    assert P * Q_ * J_ >= H_ > (P - 1) * Q_ * J_


@pytest.mark.parametrize("H_,want", [(650, (8, 6, 14)), (512, (8, 5, 13)),
                                     (1500, (8, 13, 15)), (40, (8, 1, 5))])
def test_cluster_plan_takes_clusters_of_eight_and_the_fewest_units(H_, want):
    assert t_ls.cluster_plan(H_, 132, _fits(H_)) == want


def test_cluster_plan_falls_back_to_smaller_clusters():
    no8 = lambda q, j: q != 8 and _fits(512)(q, j)
    assert t_ls.cluster_plan(512, 132, no8) == (4, 4, 32)
    assert t_ls.cluster_plan(512, 132, lambda q, j: q == 1 and j == 7) == (1, 7, 74)
    with pytest.raises(ValueError, match="no cluster plan"):
        t_ls.cluster_plan(512, 132, lambda q, j: False)


@pytest.mark.parametrize("Q,J,P,B_,H_,rows", [(8, 6, 14, 20, 650, 0), (8, 6, 14, 20, 650, 35),
                                              (8, 5, 13, 64, 512, 1), (1, 1, 40, 3, 41, 7)])
def test_ring_words_hold_two_slots_sentinels_barrier_and_keep_table(Q, J, P, B_, H_, rows):
    words = t_ls.ring_words(Q, J, P, B_, H_, rows)
    head = 2 * P * B_ * H_ + 2 * P * Q + 2
    assert words == head + -(-rows * H_ // 2)
    assert head % 2 == 0          # the keep table starts on 16 bytes
    assert 2 * (words - head) >= rows * H_


# ---------------------------------------------------------------------------
# K4 on the card: bits, float64 and the cluster layout's edge cases
# ---------------------------------------------------------------------------


def _k4_case(dev, T_=7, B_=5, H_=40, mode="structured", fixed=False, lengths=None, seed=6,
             drop_low_at=None):
    """K4's operands on the card (the plain forward's residuals), ids of
    k = H/2 unit ids a row (row ``drop_low_at`` keeps none of the units
    below H/2), and callables for the kernel and the plain reverse in
    float32 and float64 (each returns (dgx, dU, dh0, dc0))."""
    rng = np.random.default_rng(seed)
    f = lambda *s, std: torch.from_numpy(
        (rng.standard_normal(s) * std).astype(np.float32)).to(dev)
    gx, u, h0, c0 = f(T_, B_, 4 * H_, std=0.5), f(H_, 4 * H_, std=0.05), \
        f(B_, H_, std=0.5), f(B_, H_, std=0.5)
    ids = mask = None
    scale = 1.0
    rows = 1 if fixed else T_
    if mode == "structured":
        k = H_ // 2
        tab = np.stack([np.sort(rng.permutation(H_)[:k]) for _ in range(rows)])
        if drop_low_at is not None:
            tab[drop_low_at] = np.arange(H_ - k, H_)
        ids = torch.from_numpy(tab.astype(np.int32)).to(dev)
        scale = H_ / k
    elif mode == "dense":
        mask = torch.from_numpy((rng.random((rows, B_, H_)) > 0.5).astype(np.float32)).to(dev)
        scale = 2.0
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
    rh = (ids, mask, lens, scale)
    cell = t_ls.lstm_cell_spec(0.0)
    hs, gates, (cs,) = t_cs.plain_fwd(cell, gx, u, h0, (c0,), *rh)
    dy, dcT = f(T_, B_, H_, std=1.0), f(B_, H_, std=1.0)
    saved = (gates, (cs,), (c0,), hs, h0, u)
    flat = lambda o: (o[0], o[1], o[2], o[3][0])
    d = lambda t: t.double()
    return dict(
        kernel=lambda: flat(t_ls.lstm_scan_bwd_cuda(dy, (dcT,), *saved, *rh, forget_bias=0.0)),
        plain=lambda: flat(t_cs.plain_bwd(cell, dy, (dcT,), *saved, *rh)),
        f64=lambda: flat(t_cs.plain_bwd(cell, d(dy), (d(dcT),), d(gates), (d(cs),), (d(c0),),
                                        d(hs), d(h0), d(u), *rh)))


def _assert_k4_matches_plain(case):
    for g, w, n in zip(case["kernel"](), case["plain"](), ("dgx", "dU", "dh0", "dc0")):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-4, err_msg=n,
                                   atol=1e-5 * max(1.0, w.abs().max().item()))


def _f64_dist(xs, ref):
    return max((x.double() - r).abs().max().item() / max(1.0, r.abs().max().item())
               for x, r in zip(xs, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("T_,B_,H_", [(7, 5, 40), (35, 20, 650), (50, 64, 512)])
def test_cuda_second_launch_gives_the_same_bits(T_, B_, H_):
    case = _k4_case(require_cuda(), T_, B_, H_, lengths=None)
    first, again = case["kernel"](), case["kernel"]()
    for a, b, n in zip(first, again, ("dgx", "dU", "dh0", "dc0")):
        assert torch.equal(a, b), n


@pytest.mark.cuda
@pytest.mark.parametrize("T_,B_,H_,mode", [(7, 5, 40, "structured"), (7, 5, 40, "dense"),
                                           (35, 20, 650, "structured"),
                                           (50, 64, 512, "structured")])
def test_cuda_kernel_within_ten_times_plain_float32_of_float64(T_, B_, H_, mode):
    """K6's gate: the kernel's distance to a float64 run of the plain
    reverse, max |err| / max(1, |ref|), within 10 x the float32 plain
    version's + 1e-6."""
    case = _k4_case(require_cuda(), T_, B_, H_, mode=mode)
    ref = case["f64"]()
    dk, dp = _f64_dist(case["kernel"](), ref), _f64_dist(case["plain"](), ref)
    assert dk <= 10 * dp + 1e-6, (dk, dp)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(T_=6, B_=6, H_=48, lengths=[0, 6, 3, 6, 0, 1]),           # ragged rows of length 0 and T
    dict(T_=6, B_=4, H_=650, drop_low_at=3),                       # a step that keeps no unit of
    dict(T_=6, B_=4, H_=650, mode="dense", lengths=[6, 0, 2, 6]),  # half the CTAs; H % J != 0
    dict(T_=5, B_=4, H_=1500),                                     # U's block through L2
    dict(T_=5, B_=4, H_=1500, fixed=True, drop_low_at=0),
    dict(T_=6, B_=3, H_=41, mode="off", lengths=[6, 2, 0]),
])
def test_cuda_kernel_edge_cases_match_plain(kw):
    _assert_k4_matches_plain(_k4_case(require_cuda(), **kw))


def _k4_plan(dev, B_, H_, k):
    """K4's launch plan for a structured shape: (Q, J, P) and whether U's
    block stays in shared memory."""
    q, j, p = t_ls._bwd_plan(dev.index or 0, B_, H_, 1, k)
    mc, res, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    assert t_ls._lib().lstm_scan_bwd_clusters(B_, H_, 1, k, q, j, ctypes.byref(mc),
                                              ctypes.byref(res), ctypes.byref(smem)) == 0
    return (q, j, p), bool(res.value)


@pytest.mark.cuda
@pytest.mark.parametrize("B_,want", [
    (192, lambda plan, res: plan[0] == 8 and not res),   # clusters of 8, U's block through L2
    (256, lambda plan, res: plan[0] < 8),                # the plan falls back to smaller clusters
], ids=["q8_U_through_L2", "smaller_clusters"])
def test_cuda_kernel_at_large_batch_plans(B_, want):
    """At H=512 a large batch takes the plans the main paths do not: the
    kernel still matches the plain reverse and gives the same bits again."""
    dev = require_cuda()
    plan, res = _k4_plan(dev, B_, 512, 256)
    assert want(plan, res), (plan, res)
    case = _k4_case(dev, T_=6, B_=B_, H_=512)
    _assert_k4_matches_plain(case)
    first, again = case["kernel"](), case["kernel"]()
    for a, b, n in zip(first, again, ("dgx", "dU", "dh0", "dc0")):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# K3's cluster layout: the host-side plan and exchange
# ---------------------------------------------------------------------------

# one-CTA-an-SM clusters resident at once on a 132-SM H100 (launch/scan_bench.py's
# probe read 15 of 8 and 30 of 4)
_RESIDENT_FWD = {8: 15, 4: 30, 2: 66, 1: 132}


def _fwd_query(H_, rows, resident=_RESIDENT_FWD):
    """A plan query as the wrappers' (all clusters resident, rows a chunk)."""
    return lambda q, j: (t_ls.n_clusters(H_, j, q) <= resident[q], rows(q, j))


@pytest.mark.parametrize("H_,B_,want", [(650, 20, (8, 6, 14)), (512, 64, (8, 5, 13)),
                                        (1500, 20, (8, 13, 15)), (40, 1, (8, 1, 5))])
def test_fwd_cluster_plan_takes_clusters_of_eight_when_a_chunk_holds_the_batch(H_, B_, want):
    assert t_ls.fwd_cluster_plan(H_, B_, 132, _fwd_query(H_, lambda q, j: 64)) == want


def test_fwd_cluster_plan_prefers_whole_chunks_then_takes_any():
    """A plan whose chunk holds min(B, 64) rows comes first, even at smaller
    clusters; without one, the largest cluster whose chunk holds any rows."""
    rows = lambda q, j: 24 if q == 8 else 64
    assert t_ls.fwd_cluster_plan(512, 64, 132, _fwd_query(512, rows)) == (4, 5, 26)
    rows = lambda q, j: 24 if q >= 4 else 0
    assert t_ls.fwd_cluster_plan(512, 256, 132, _fwd_query(512, rows)) == (8, 5, 13)
    with pytest.raises(ValueError, match="no forward cluster plan"):
        t_ls.fwd_cluster_plan(512, 64, 132, _fwd_query(512, lambda q, j: 0))


@pytest.mark.parametrize("Q,J,P,B_,H_", [(8, 6, 14, 20, 650), (8, 5, 13, 64, 512),
                                         (8, 13, 15, 20, 1500), (1, 1, 41, 3, 41)])
def test_fwd_ring_words_hold_two_slots_and_a_sentinel_a_cta(Q, J, P, B_, H_):
    words = t_ls.fwd_ring_words(Q, J, P, B_, H_)
    assert words == 2 * B_ * H_ + P * Q
    assert P * Q * J >= H_            # every unit has an owner, and a sentinel


# ---------------------------------------------------------------------------
# K3 on the card: bits, float64 and the cluster layout's edge cases
# ---------------------------------------------------------------------------


def _k3_case(dev, T_=7, B_=5, H_=40, mode="structured", fixed=False, lengths=None, seed=8,
             drop_low_at=None):
    """K3's operands on the card (ids of k = H/2 unit ids a row; row
    ``drop_low_at`` keeps none of the units below H/2), and callables for
    the kernel and the plain forward in float32 and float64 (each returns
    (hs, gates, cs))."""
    rng = np.random.default_rng(seed)
    f = lambda *s, std: torch.from_numpy(
        (rng.standard_normal(s) * std).astype(np.float32)).to(dev)
    gx, u, h0, c0 = f(T_, B_, 4 * H_, std=0.5), f(H_, 4 * H_, std=0.05), \
        f(B_, H_, std=0.5), f(B_, H_, std=0.5)
    ids = mask = None
    scale = 1.0
    rows = 1 if fixed else T_
    if mode == "structured":
        k = H_ // 2
        tab = np.stack([np.sort(rng.permutation(H_)[:k]) for _ in range(rows)])
        if drop_low_at is not None:
            tab[drop_low_at] = np.arange(H_ - k, H_)
        ids = torch.from_numpy(tab.astype(np.int32)).to(dev)
        scale = H_ / k
    elif mode == "dense":
        mask = torch.from_numpy((rng.random((rows, B_, H_)) > 0.5).astype(np.float32)).to(dev)
        scale = 2.0
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
    rh = (ids, mask, lens, scale)
    cell = t_ls.lstm_cell_spec(0.0)
    flat = lambda o: (o[0], o[1], o[2][0])
    d = lambda t: None if t is None else t.double()
    return dict(
        kernel=lambda: flat(t_ls.lstm_scan_fwd_cuda(gx, u, h0, (c0,), *rh, forget_bias=0.0)),
        plain=lambda: flat(t_cs.plain_fwd(cell, gx, u, h0, (c0,), *rh)),
        f64=lambda: flat(t_cs.plain_fwd(cell, d(gx), d(u), d(h0), (d(c0),), ids, d(mask), lens,
                                        scale)))


def _assert_k3_matches_plain(case):
    for g, w, n in zip(case["kernel"](), case["plain"](), ("hs", "gates", "cs")):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-4, err_msg=n,
                                   atol=1e-5 * max(1.0, w.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("T_,B_,H_", [(7, 5, 40), (35, 20, 650), (50, 64, 512)])
def test_cuda_forward_second_launch_gives_the_same_bits(T_, B_, H_):
    case = _k3_case(require_cuda(), T_, B_, H_)
    first, again = case["kernel"](), case["kernel"]()
    for a, b, n in zip(first, again, ("hs", "gates", "cs")):
        assert torch.equal(a, b), n


@pytest.mark.cuda
@pytest.mark.parametrize("T_,B_,H_,mode", [(7, 5, 40, "structured"), (7, 5, 40, "dense"),
                                           (35, 20, 650, "structured"),
                                           (50, 64, 512, "structured")])
def test_cuda_forward_within_ten_times_plain_float32_of_float64(T_, B_, H_, mode):
    """K3's distance to a float64 run of the plain forward, max |err| /
    max(1, |ref|), within 10 x the float32 plain version's + 1e-6."""
    case = _k3_case(require_cuda(), T_, B_, H_, mode=mode)
    ref = case["f64"]()
    dk, dp = _f64_dist(case["kernel"](), ref), _f64_dist(case["plain"](), ref)
    assert dk <= 10 * dp + 1e-6, (dk, dp)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(T_=6, B_=1, H_=40),                                       # one batch row
    dict(T_=6, B_=6, H_=48, lengths=[0, 6, 3, 6, 0, 1]),           # ragged rows of length 0 and T
    dict(T_=6, B_=4, H_=650, drop_low_at=3),                       # a step that keeps no unit of
    dict(T_=6, B_=4, H_=650, mode="dense", lengths=[6, 0, 2, 6]),  # half the CTAs; H % J != 0
    dict(T_=5, B_=4, H_=1500),                                     # U's block through L2
    dict(T_=5, B_=4, H_=1500, fixed=True, drop_low_at=0),
    dict(T_=6, B_=3, H_=41, mode="off", lengths=[6, 2, 0]),
    dict(T_=6, B_=5, H_=44, mode="dense", fixed=True),
])
def test_cuda_forward_edge_cases_match_plain(kw):
    _assert_k3_matches_plain(_k3_case(require_cuda(), **kw))


def _k3_plan(dev, B_, H_, k):
    """K3's launch plan for a structured shape: (Q, J, P), whether U's block
    stays in shared memory, and the rows of a chunk."""
    q, j, p = t_ls._fwd_plan(dev.index or 0, B_, H_, 1, k)
    mc, res, smem, rows = (ctypes.c_int() for _ in range(4))
    assert t_ls._lib().lstm_scan_fwd_clusters(B_, H_, 1, k, q, j, ctypes.byref(mc),
                                              ctypes.byref(res), ctypes.byref(smem),
                                              ctypes.byref(rows)) == 0
    return (q, j, p), bool(res.value), rows.value


@pytest.mark.cuda
@pytest.mark.parametrize("B_,want", [
    (192, lambda plan, res, rows: res and rows < 192),   # the batch in chunks
    (256, lambda plan, res, rows: res and rows < 256),
], ids=["b192_chunks", "b256_chunks"])
def test_cuda_forward_at_large_batch_plans(B_, want):
    """At H=512 a large batch takes the plans the main paths do not (its
    rows in chunks, a cluster exchange each): the kernel still matches the
    plain forward and gives the same bits again."""
    dev = require_cuda()
    plan, res, rows = _k3_plan(dev, B_, 512, 256)
    assert want(plan, res, rows), (plan, res, rows)
    case = _k3_case(dev, T_=5, B_=B_, H_=512)
    _assert_k3_matches_plain(case)
    first, again = case["kernel"](), case["kernel"]()
    for a, b, n in zip(first, again, ("hs", "gates", "cs")):
        assert torch.equal(a, b), n
