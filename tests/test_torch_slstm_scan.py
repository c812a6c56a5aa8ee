"""K6 fused sLSTM scan: the port's forward and hand-written reverse against
the reference's ``slstm_scan(impl="pallas")`` (interpret mode) and its
plain oracle ``ref.slstm_scan_ref``.

Sweeps RH mode (structured / dense / off) x time pattern (per-step / FIXED
one-row) x ragged ``lengths`` x start (fresh: zeros and m0 = -1e30;
handoff: random h0, c0, m0 and n0 > 0), three heads: hs, the final
(h, c, n, m) and the gradients of all six inputs for the reference tests'
loss ``sum(hs^2) + sum(h_fin * c_fin) + 0.1 sum(n_fin) + 0.01 sum(m_fin)``.
The port's reverse is also held to ``torch.autograd`` of its plain forward,
and the headed cell_scan to one-head runs of each head. The split backward
(the plain scan, then dR from the WG wrapper over the wrapper's own tables
of kept (step, unit block) pairs) is held to plain_bwd and the reference. On the CPU the port
runs the kernels' plain versions; the ``cuda``-marked tests (skipped
without a GPU) hold the CUDA kernels to them.

Tolerances: float32, different summation order: forward rtol/atol 1e-5,
gradients rtol/atol 1e-4 (they sum over all T steps).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cell_scan as t_cs
from repro_torch.kernels import lstm_scan as t_ls
from repro_torch.kernels import slstm_scan as t_ss
from repro_torch.testing import require_cuda

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
T, B, NH, DH = 5, 3, 3, 16
NAMES = ("xg", "R", "h0", "c0", "n0", "m0")


def _inputs(mode, fixed, ragged, fresh, seed=0, T=T, B=B, NH=NH, dh=DH, bs=4,
            rate=0.5, mask_heads=1, lengths=None):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    d = dict(xg=rng.standard_normal((T, B, NH, 4 * dh)).astype(f32) * 0.3,
             R=rng.standard_normal((NH, dh, 4 * dh)).astype(f32) * 0.2)
    if fresh:
        z = np.zeros((B, NH, dh), f32)
        d.update(h0=z, c0=z, n0=z, m0=np.full((B, NH, dh), -1e30, f32))
    else:
        d.update(h0=rng.standard_normal((B, NH, dh)).astype(f32) * 0.5,
                 c0=rng.standard_normal((B, NH, dh)).astype(f32) * 0.5,
                 n0=np.abs(rng.standard_normal((B, NH, dh))).astype(f32) + 0.5,
                 m0=rng.standard_normal((B, NH, dh)).astype(f32) * 0.3)
    rows = 1 if fixed else T
    kw = {}
    if mode == "structured":
        nb = dh // bs
        kb = np.stack([np.sort(rng.permutation(nb)[:nb // 2]) for _ in range(rows)])
        kw = dict(keep_blocks=kb.astype(np.int32), block_size=bs, scale=2.0)
    elif mode == "dense":
        m = rng.random((rows, B, mask_heads, dh)) > rate
        kw = dict(dense_mask=m.astype(f32), scale=1.0 / (1.0 - rate))
    if ragged:
        lens = lengths if lengths is not None else [T, 2, 1][:B] + [T] * (B - 3)
        kw["lengths"] = np.array(lens, np.int32)
    return d, kw


def _loss(ys, hf, cf, nf, mf):
    return (ys ** 2).sum() + (hf * cf).sum() + 0.1 * nf.sum() + 0.01 * mf.sum()


def _port(d, kw, impl="pallas", device="cpu"):
    ins = [torch.from_numpy(d[k]).to(device).requires_grad_(True) for k in NAMES]
    tkw = {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    hs, (hf, (cf, nf, mf)) = t_ss.slstm_scan(*ins, impl=impl, **tkw)
    grads = torch.autograd.grad(_loss(hs, hf, cf, nf, mf), ins)
    return [x.detach().cpu().numpy() for x in (hs, hf, cf, nf, mf, *grads)]


# (mode, fixed, ragged, fresh); ragged rows of the fresh cases are >= 1 long
CASES = [("structured", False, False, True), ("structured", False, False, False),
         ("structured", True, False, True), ("structured", False, True, False),
         ("structured", True, True, True), ("dense", False, False, False),
         ("dense", True, False, True), ("dense", False, True, False),
         ("off", False, False, True), ("off", False, True, False)]


@pytest.fixture(scope="module")
def ref_ops():
    jax = pytest.importorskip("jax")
    from repro.kernels import ops, ref
    return jax, ops, ref


def _reference(jax, scan, d, kw):
    def loss(*a):
        ys, (hf, (cf, nf, mf)) = scan(*a, **kw)
        return _loss(ys, hf, cf, nf, mf), (ys, hf, cf, nf, mf)
    (_, outs), grads = jax.value_and_grad(loss, argnums=tuple(range(6)),
                                          has_aux=True)(*(d[k] for k in NAMES))
    return [np.asarray(x) for x in (*outs, *grads)]


def _assert_match(got, want):
    for g, w, nm in zip(got[:5], want[:5], ("hs", "h_fin", "c_fin", "n_fin", "m_fin")):
        np.testing.assert_allclose(g, w, err_msg=nm, **FWD)
    for g, w, nm in zip(got[5:], want[5:], NAMES):
        np.testing.assert_allclose(g, w, err_msg=f"d{nm}", **GRAD)


@pytest.mark.parametrize("mode,fixed,ragged,fresh", CASES)
def test_matches_reference_pallas(ref_ops, mode, fixed, ragged, fresh):
    jax, ops, _ = ref_ops
    d, kw = _inputs(mode, fixed, ragged, fresh,
                    mask_heads=NH if (mode, fixed) == ("dense", True) else 1)
    want = _reference(jax, lambda *a, **k: ops.slstm_scan(*a, impl="pallas", **k),
                      d, kw)
    _assert_match(_port(d, kw), want)


@pytest.mark.parametrize("mode,fixed,ragged,fresh",
                         [c for c in CASES if not c[2]])
def test_matches_plain_oracle(ref_ops, mode, fixed, ragged, fresh):
    jax, _, ref = ref_ops
    d, kw = _inputs(mode, fixed, ragged, fresh, seed=1)
    _assert_match(_port(d, kw), _reference(jax, ref.slstm_scan_ref, d, kw))


@pytest.mark.parametrize("mode,fixed,ragged,fresh", CASES[:6])
def test_reverse_matches_autograd_of_plain_forward(mode, fixed, ragged, fresh):
    d, kw = _inputs(mode, fixed, ragged, fresh, seed=2)
    got = _port(d, kw)
    ins = [torch.from_numpy(d[k]).requires_grad_(True) for k in NAMES]
    ids = None
    if "keep_blocks" in kw:
        kb = torch.from_numpy(kw["keep_blocks"])
        ids = (kb[..., None] * kw["block_size"] + torch.arange(kw["block_size"])).flatten(1)
    mask = torch.from_numpy(kw["dense_mask"]) if "dense_mask" in kw else None
    lengths = torch.from_numpy(kw["lengths"]) if "lengths" in kw else None
    hs, _, (cs, ns, ms) = t_cs.plain_fwd(t_ss.SLSTM_CELL, ins[0], ins[1], ins[2],
                                         tuple(ins[3:]), ids, mask, lengths,
                                         kw.get("scale", 1.0))
    # the finals are the last rows of the sequences (frozen rows carry them)
    want = torch.autograd.grad(_loss(hs, hs[-1], cs[-1], ns[-1], ms[-1]), ins)
    for g, w, nm in zip(got[5:], want, NAMES):
        np.testing.assert_allclose(g, w.numpy(), err_msg=f"d{nm}", **GRAD)


def test_fresh_empty_row_gives_finite_zero_grads():
    """A row of length 0 from a fresh start (m0 = -1e30) stays frozen: its
    stored input gate exp(gi - m) overflows, and the frozen step must still
    give exactly zero dgates, so the other rows' gradients are those of the
    batch without it."""
    d, kw = _inputs("structured", False, True, True, seed=3,
                    lengths=[T, 0, 3])
    got = _port(d, kw)
    assert all(np.isfinite(g).all() for g in got)
    np.testing.assert_array_equal(got[5][:, 1], 0.0)
    keep = [0, 2]
    d2 = {k: (v[:, keep] if k == "xg" else v[keep] if k != "R" else v)
          for k, v in d.items()}
    kw2 = dict(kw, lengths=kw["lengths"][keep])
    ref2 = _port(d2, kw2)
    np.testing.assert_allclose(got[5][:, keep], ref2[5], **GRAD)
    np.testing.assert_allclose(got[6], ref2[6], **GRAD)


@pytest.mark.parametrize("mode", ["structured", "dense", "off"])
def test_headed_cell_scan_equals_one_head_runs(mode):
    """cell_scan with three heads (LSTM cell) against one one-head
    lstm_scan per head, forward and every gradient."""
    rng = np.random.default_rng(4)
    H_, dh = 3, 8
    gx = torch.from_numpy(rng.standard_normal((T, B, H_, 4 * dh)).astype(np.float32) * 0.5)
    u = torch.from_numpy(rng.standard_normal((H_, dh, 4 * dh)).astype(np.float32) * 0.3)
    h0 = torch.from_numpy(rng.standard_normal((B, H_, dh)).astype(np.float32) * 0.5)
    c0 = torch.from_numpy(rng.standard_normal((B, H_, dh)).astype(np.float32) * 0.5)
    kw, mask = {}, None
    if mode == "structured":
        kb = np.stack([np.sort(rng.permutation(4)[:2]) for _ in range(T)])
        kw = dict(keep_blocks=torch.from_numpy(kb.astype(np.int32)), block_size=2,
                  scale=2.0)
    elif mode == "dense":
        mask = torch.from_numpy((rng.random((T, B, H_, dh)) > 0.5).astype(np.float32))
        kw = dict(scale=2.0)
    ins = [x.clone().requires_grad_(True) for x in (gx, u, h0, c0)]
    hs, (hf, (cf,)) = t_cs.cell_scan(ins[0], ins[1], ins[2], (ins[3],),
                                     cell=t_ls.lstm_cell_spec(0.0), dense_mask=mask, **kw)
    grads = torch.autograd.grad((hs ** 2).sum() + (hf * cf).sum(), ins)
    for hd in range(H_):
        one = [x.clone().requires_grad_(True)
               for x in (gx[:, :, hd], u[hd], h0[:, hd], c0[:, hd])]
        hs1, (hf1, cf1) = t_ls.lstm_scan(
            *one, dense_mask=None if mask is None else mask[:, :, hd], **kw)
        g1 = torch.autograd.grad((hs1 ** 2).sum() + (hf1 * cf1).sum(), one)
        np.testing.assert_allclose(hs[:, :, hd].detach(), hs1.detach(), **FWD)
        for g, w, idx in zip(grads, g1, ((slice(None), slice(None), hd), (hd,),
                                         (slice(None), hd), (slice(None), hd))):
            np.testing.assert_allclose(g[idx], w, **GRAD)


def test_bad_shapes_raise():
    d, kw = _inputs("off", False, False, True)
    args = [torch.from_numpy(d[k]) for k in NAMES]
    with pytest.raises(ValueError):
        t_ss.slstm_scan(*args, keep_blocks=torch.zeros(T, 2, dtype=torch.int32),
                        dense_mask=torch.ones(T, B, 1, DH), block_size=4)
    with pytest.raises(ValueError):
        t_ss._shapes(args[0], args[1][:, :, :-4])


def _unit_ids(kw):
    if "keep_blocks" not in kw:
        return None
    from repro_torch.core.masks import keep_blocks_to_unit_ids
    return keep_blocks_to_unit_ids(torch.from_numpy(kw["keep_blocks"]),
                                   kw["block_size"]).to(torch.int32)


def _split_backward(d, kw, device="cpu"):
    """The plain scan forward and backward on the test loss, then dR again
    from the WG wrapper (its plain version on the CPU) with the wrapper's own
    index tables. Returns (dR from WG, plain_bwd's outputs)."""
    x = {k: torch.from_numpy(v).to(device) for k, v in d.items()}
    ids = _unit_ids(kw)
    ids = None if ids is None else ids.to(device)
    mask = torch.from_numpy(kw["dense_mask"]).to(device) if "dense_mask" in kw else None
    lengths = (torch.from_numpy(kw["lengths"]).to(device)
               if "lengths" in kw else None)
    scale = kw.get("scale", 1.0)
    st0 = (x["c0"], x["n0"], x["m0"])
    rh = (ids, mask, lengths, scale)
    hs, gates, sts = t_cs.plain_fwd(t_ss.SLSTM_CELL, x["xg"], x["R"], x["h0"], st0, *rh)
    dy = 2 * hs
    dy[-1] += sts[0][-1]
    dstT = (hs[-1].clone(), torch.full_like(hs[-1], 0.1), torch.full_like(hs[-1], 0.01))
    plain = t_cs.plain_bwd(t_ss.SLSTM_CELL, dy, dstT, gates, sts, st0, hs, x["h0"],
                           x["R"], *rh)
    T_ = hs.shape[0]
    tables = t_ss.wg_tables(ids, T_, hs.shape[-1], device)
    dR = t_ss.slstm_wg(plain[0], hs, x["h0"], tables, mask, scale)
    return dR, plain


# (mode, fixed, ragged, fresh, mask_heads)
SPLIT_CASES = [("structured", False, False, True, 1), ("structured", True, False, False, 1),
               ("dense", True, False, True, NH), ("dense", False, False, False, 1),
               ("off", False, False, True, 1), ("structured", False, True, False, 1),
               ("dense", False, True, False, 1)]


@pytest.mark.parametrize("mode,fixed,ragged,fresh,mask_heads", SPLIT_CASES)
def test_split_backward_matches_plain_and_reference(ref_ops, mode, fixed, ragged, fresh,
                                                    mask_heads):
    """dR computed after the scan by the WG wrapper over the kept (step,
    unit block) pairs equals plain_bwd's in-loop dR and the reference's."""
    jax, ops, _ = ref_ops
    d, kw = _inputs(mode, fixed, ragged, fresh, seed=8, mask_heads=mask_heads)
    dR, plain = _split_backward(d, kw)
    np.testing.assert_allclose(dR.numpy(), plain[1].numpy(), **FWD)
    want = _reference(jax, lambda *a, **k: ops.slstm_scan(*a, impl="pallas", **k), d, kw)
    np.testing.assert_allclose(dR.numpy(), want[6], err_msg="dR", **GRAD)


def test_split_backward_fresh_empty_row_gives_exact_zeros():
    """The fresh empty row (length 0, m0 = -1e30): exact zero dgates, and dR
    from the WG wrapper equals that of the batch without the row."""
    d, kw = _inputs("structured", False, True, True, seed=3, lengths=[T, 0, 3])
    dR, plain = _split_backward(d, kw)
    assert torch.isfinite(dR).all()
    np.testing.assert_array_equal(plain[0][:, 1].numpy(), 0.0)
    np.testing.assert_allclose(dR.numpy(), plain[1].numpy(), **FWD)
    keep = [0, 2]
    d2 = {k: (v[:, keep] if k == "xg" else v[keep] if k != "R" else v)
          for k, v in d.items()}
    dR2, _ = _split_backward(d2, dict(kw, lengths=kw["lengths"][keep]))
    np.testing.assert_allclose(dR.numpy(), dR2.numpy(), **GRAD)


@pytest.mark.parametrize("rows", [T, 1])
def test_wg_tables_list_the_kept_blocks(rows):
    """With RH blocks of WG_UNITS units, a block's active steps are exactly
    the rows that keep it: the WG contraction runs at (1-p) FLOPs."""
    rng = np.random.default_rng(9)
    dh, bs = 4 * t_ss.WG_UNITS, t_ss.WG_UNITS
    kb = np.stack([np.sort(rng.permutation(4)[:3]) for _ in range(rows)]).astype(np.int32)
    from repro_torch.core.masks import keep_blocks_to_unit_ids
    ids = keep_blocks_to_unit_ids(torch.from_numpy(kb), bs).to(torch.int32)
    steps, counts, keep, partial = t_ss.wg_tables(ids, T, dh, "cpu")
    for blk in range(4):
        kept_rows = [t for t in range(T) if blk in kb[0 if rows == 1 else t]]
        assert counts[blk] == len(kept_rows)
        assert steps[blk, :len(kept_rows)].tolist() == kept_rows
        assert (steps[blk, len(kept_rows):] == T).all()
    assert int(counts.sum()) * bs == T * ids.shape[1]
    np.testing.assert_array_equal(keep.sum(1).numpy(), ids.shape[1])
    # a block is kept whole wherever it is active: the kernel needs no keep factor
    assert partial.dtype == torch.int32 and partial.tolist() == [0] * 4


@pytest.mark.parametrize("dh,bs", [(2 * 64, 16), (100, 4), (96, 32)])
def test_wg_tables_flag_the_blocks_kept_in_part(dh, bs):
    """``partial`` is 1 exactly for the blocks of WG_UNITS units that some
    active step keeps only in part (RH blocks narrower than the tile, and a
    last block cut short by dh, whose missing units do not count)."""
    rng = np.random.default_rng(13)
    nb = dh // bs
    kb = np.stack([np.sort(rng.permutation(nb)[:nb // 2]) for _ in range(T)]).astype(np.int32)
    from repro_torch.core.masks import keep_blocks_to_unit_ids
    ids = keep_blocks_to_unit_ids(torch.from_numpy(kb), bs).to(torch.int32)
    steps, counts, keep, partial = t_ss.wg_tables(ids, T, dh, "cpu")
    W = t_ss.WG_UNITS
    for blk in range(-(-dh // W)):
        k = keep[:, blk * W:(blk + 1) * W]
        live = k.amax(1) > 0
        want = bool((live & (k.amin(1) == 0)).any())
        assert partial[blk] == int(want), blk
        assert counts[blk] == int(live.sum())


def test_wg_tables_without_ids_list_every_step():
    steps, counts, keep, partial = t_ss.wg_tables(None, T, 80, "cpu")
    assert keep is None and partial is None and steps.shape == (2, T)
    assert counts.tolist() == [T, T]
    assert (steps == torch.arange(T, dtype=torch.int32)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode,fixed,ragged,fresh", CASES)
def test_cuda_kernels_match_plain(mode, fixed, ragged, fresh):
    dev = require_cuda()
    d, kw = _inputs(mode, fixed, ragged, fresh, seed=5, T=7, B=5, NH=3, dh=16,
                    bs=1, mask_heads=NH if (mode, fixed) == ("dense", True) else 1)
    n0 = dict(t_ss.LAUNCHES)
    got = _port(d, kw, device=dev)
    assert t_ss.LAUNCHES["slstm_scan_fwd"] == n0["slstm_scan_fwd"] + 1
    assert t_ss.LAUNCHES["slstm_scan_bwd"] == n0["slstm_scan_bwd"] + 1
    for g, w in zip(got, _port(d, kw)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_kernels_at_xlstm_width():
    """xlstm-1.3b's heads (4 x 512, RH block 64 at p = 0.25), 32 steps."""
    dev = require_cuda()
    d, kw = _inputs("structured", False, False, True, seed=6, T=32, B=2, NH=4,
                    dh=512, bs=64)
    d["R"] = d["R"] * (0.2 ** -1) * 512 ** -0.5      # the model's init scale
    for g, w in zip(_port(d, kw, device=dev), _port(d, kw)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B_,NH_,dh", [(9, 2, 16), (2, 1, 2048)])
def test_cuda_kernels_other_layouts(B_, NH_, dh):
    """Two forward row chunks (B > 8), and one head of 2048 units whose R
    columns and dR rows do not fit in shared memory (read through L2)."""
    dev = require_cuda()
    d, kw = _inputs("structured", False, True, False, seed=7, T=6, B=B_, NH=NH_,
                    dh=dh, bs=4, lengths=[6, 3] + [5] * (B_ - 2))
    d["R"] = d["R"] * (0.2 ** -1) * dh ** -0.5
    for g, w in zip(_port(d, kw, device=dev), _port(d, kw)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_kernel_rejects_other_dtypes():
    dev = require_cuda()
    d, _ = _inputs("off", False, False, True)
    args = [torch.from_numpy(d[k]).to(dev) for k in NAMES]
    args[0] = args[0].double()
    with pytest.raises(TypeError):
        t_ss.slstm_scan(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,fixed,dh,bs", [("structured", False, 128, 64),
                                              ("structured", True, 128, 4),
                                              ("structured", False, 16, 1),
                                              ("dense", False, 96, 1), ("off", False, 16, 1),
                                              ("dense", False, 30, 1)])
def test_cuda_wg_kernel_matches_plain(mode, fixed, dh, bs):
    """The WG kernel alone against plain_wg on the same dgx, hs and tables
    (dh = 30: rows not on 16 bytes, the kernel's 4-byte copies)."""
    dev = require_cuda()
    d, kw = _inputs(mode, fixed, False, False, seed=10, T=9, B=3, NH=2, dh=dh, bs=bs)
    rng = np.random.default_rng(11)
    x = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    dgx, hs, h0 = x(9, 3, 2, 4 * dh), x(9, 3, 2, dh), x(3, 2, dh)
    ids = _unit_ids(kw)
    mask = torch.from_numpy(kw["dense_mask"]) if "dense_mask" in kw else None
    scale = kw.get("scale", 1.0)
    want = t_ss.slstm_wg(dgx, hs, h0, t_ss.wg_tables(ids, 9, dh, "cpu"), mask, scale)
    n0 = t_ss.LAUNCHES["slstm_wg"]
    cuda = lambda a: None if a is None else a.to(dev)
    got = t_ss.slstm_wg(dgx.to(dev), hs.to(dev), h0.to(dev),
                        t_ss.wg_tables(cuda(ids), 9, dh, dev), cuda(mask), scale)
    assert t_ss.LAUNCHES["slstm_wg"] == n0 + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,bs", [("structured", 64), ("structured", 8), ("dense", 1)])
def test_cuda_wg_kernel_keeps_float32_accuracy(mode, bs):
    """The WG kernel (split-precision TF32 on the tensor cores) within 1e-5
    x max(1, |ref|) of a float64 product of the same masked operands over a
    contraction of ~1000 (step, row) pairs: float32's accuracy, which
    single-pass TF32 (~2^-11 a product) misses. Blocks kept whole (bs 64),
    kept in part (bs 8) and a dense mask."""
    dev = require_cuda()
    T_, B_, NH_, dh = 256, 4, 2, 256
    d, kw = _inputs(mode, False, False, False, seed=14, T=T_, B=B_, NH=NH_, dh=dh, bs=bs)
    rng = np.random.default_rng(15)
    x = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    dgx, hs, h0 = x(T_, B_, NH_, 4 * dh), x(T_, B_, NH_, dh), x(B_, NH_, dh)
    ids = _unit_ids(kw)
    ids = None if ids is None else ids.to(dev)
    mask = torch.from_numpy(kw["dense_mask"]).to(dev) if "dense_mask" in kw else None
    scale = kw.get("scale", 1.0)
    tables = t_ss.wg_tables(ids, T_, dh, dev)
    got = t_ss.slstm_wg(dgx, hs, h0, tables, mask, scale)
    hp = torch.cat([h0[None], hs[:-1]]).double()
    hp = hp * (tables[2][:, None, None, :] * scale if ids is not None else mask * scale)
    want = torch.einsum("tbhu,tbhc->huc", hp, dgx.double())
    err = float((got.double() - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(want.abs().max())), f"{err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("T_,B_,NH_,dh,bs", [(24, 2, 4, 512, 64), (6, 9, 2, 16, 4),
                                             (6, 2, 1, 2048, 64), (6, 3, 10, 256, 16)])
def test_cuda_second_launch_gives_the_same_bits(T_, B_, NH_, dh, bs):
    """Forward and backward (scan + WG) launched twice on the same inputs
    give the same bits (fixed sum orders, no atomics): xlstm-1.3b's heads,
    B = 9 (five row chunks), one head of 2048 units (R through L2) and 10
    heads of 256 (20 units a CTA: the backward holds its dgates in
    registers 16 unit quads at a time)."""
    dev = require_cuda()
    d, kw = _inputs("structured", False, True, False, seed=12, T=T_, B=B_, NH=NH_, dh=dh,
                    bs=bs, lengths=[T_, 3] + [T_ - 1] * (B_ - 2))
    d["R"] = d["R"] * (0.2 ** -1) * dh ** -0.5
    x = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    rh = (_unit_ids(kw).to(dev), None, torch.from_numpy(kw["lengths"]).to(dev), kw["scale"])
    st0 = (x["c0"], x["n0"], x["m0"])
    runs = [t_ss.slstm_scan_fwd_cuda(x["xg"], x["R"], x["h0"], st0, *rh) for _ in range(2)]
    hs, gates, sts = runs[0]
    for a, b in zip((runs[0][0], runs[0][1], *runs[0][2]), (runs[1][0], runs[1][1], *runs[1][2])):
        assert torch.equal(a, b)
    dy = torch.randn(hs.shape, generator=torch.Generator().manual_seed(0)).to(dev)
    dstT = tuple(torch.ones_like(x["h0"]) * v for v in (0.5, 0.1, 0.01))
    outs = [t_ss.slstm_scan_bwd_cuda(dy, dstT, gates, sts, st0, hs, x["h0"], x["R"], *rh)
            for _ in range(2)]
    flat = [(o[0], o[1], o[2], *o[3]) for o in outs]
    for a, b in zip(*flat):
        assert torch.equal(a, b)
    want = t_cs.plain_bwd(t_ss.SLSTM_CELL, dy, dstT, gates, sts, st0, hs, x["h0"], x["R"], *rh)
    for g, w in zip(flat[0], (want[0], want[1], want[2], *want[3])):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-4, atol=1e-4)
