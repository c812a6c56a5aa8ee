"""K1/K2 gather matmul: the port's wrappers against the JAX reference.

On a CPU tensor the port's wrappers run their plain versions; these are
held to ``repro.kernels.ops.gather_matmul*`` (Pallas in interpret mode, as
tests/test_kernels.py runs it) and to ``repro.kernels.ref``, for FP, BP and
b_cols, one mask and a (T, nk) table, block sizes 1 and 8. The CUDA kernel
itself is held to the plain version by the ``cuda``-marked tests (skipped
without a GPU) and by chip_smoke.py. The kernel's launch plan (``_plan``:
tiles, cluster split, copy width) is pure Python and tested here.

Tolerance: float32, the same products summed in another order:
rtol 1e-5, atol 1e-5 (inputs are O(1), outputs O(sqrt(k))).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gather_matmul as gm
from repro_torch.testing import require_cuda

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _data(T, M, H, N, bs, rate, seed=0):
    rng = np.random.default_rng(seed)
    nb = H // bs
    nk = nb - min(max(int(-(-rate * nb // 1)), 0), nb - 1)
    kb = np.stack([np.sort(rng.permutation(nb)[:nk]) for _ in range(T)]).astype(np.int32)
    return dict(
        a_full=rng.standard_normal((T, M, H)).astype(np.float32),
        a_out=rng.standard_normal((T, M, N)).astype(np.float32),
        b=(rng.standard_normal((H, N)) * 0.1).astype(np.float32),
        kb=kb, ids=(kb[..., None] * bs + np.arange(bs)).reshape(T, -1))


CASES = [(3, 4, 16, 24, 1, 0.5), (2, 5, 64, 32, 8, 0.5), (4, 1, 48, 17, 8, 0.25)]


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro.kernels import ops, ref
    return ops, ref


@pytest.mark.parametrize("T,M,H,N,bs,rate", CASES)
@pytest.mark.parametrize("variant", ["fp", "fp_compact", "bp", "cols"])
def test_unstepped_matches_reference(ref, T, M, H, N, bs, rate, variant):
    ops, oracle = ref
    d = _data(1, M, H, N, bs, rate)
    kb = d["kb"][0]
    if variant == "cols":
        # b_cols: a (M, K) @ b[:, kept]; kept over b's columns -> use b.T
        a, b, kw = d["a_out"][0], np.ascontiguousarray(d["b"].T), dict(gather="b_cols")
    elif variant == "bp":
        a, b, kw = d["a_out"][0], d["b"], dict(gather="b_rows", transpose_b=True)
    elif variant == "fp_compact":
        a, b, kw = d["a_full"][0][:, d["ids"][0]], d["b"], dict(gather="b_rows", a_is_compact=True)
    else:
        a, b, kw = d["a_full"][0], d["b"], dict(gather="b_rows")
    got = gm.gather_matmul(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(kb), block_size=bs, **kw).numpy()
    want = np.asarray(ops.gather_matmul(a, b, kb, block_size=bs, **kw))
    np.testing.assert_allclose(got, want, **TOL)
    kw_ref = {k: v for k, v in kw.items()}
    if variant == "fp_compact":
        a = d["a_full"][0]          # the oracle gathers a itself
        kw_ref.pop("a_is_compact")
    np.testing.assert_allclose(
        got, np.asarray(oracle.gather_matmul_ref(a, b, kb, block_size=bs, **kw_ref)), **TOL)


@pytest.mark.parametrize("T,M,H,N,bs,rate", CASES)
@pytest.mark.parametrize("variant", ["fp", "fp_compact", "bp"])
def test_stepped_matches_reference(ref, T, M, H, N, bs, rate, variant):
    ops, oracle = ref
    d = _data(T, M, H, N, bs, rate, seed=1)
    if variant == "bp":
        a, kw = d["a_out"], dict(transpose_b=True)
    elif variant == "fp_compact":
        a = np.take_along_axis(d["a_full"], d["ids"][:, None, :], axis=2)
        kw = dict(a_is_compact=True)
    else:
        a, kw = d["a_full"], {}
    got = gm.gather_matmul_stepped(torch.from_numpy(a), torch.from_numpy(d["b"]),
                                   torch.from_numpy(d["kb"]), block_size=bs,
                                   **kw).numpy()
    want = np.asarray(ops.gather_matmul_stepped(a, d["b"], d["kb"], block_size=bs, **kw))
    np.testing.assert_allclose(got, want, **TOL)
    if variant == "fp_compact":
        a, kw = d["a_full"], {}
    np.testing.assert_allclose(got, np.asarray(oracle.gather_matmul_stepped_ref(
        a, d["b"], d["kb"], block_size=bs, **kw)), **TOL)


def test_one_row_table_broadcasts():
    """A (1, nk) table serves every step (the FIXED time pattern)."""
    d = _data(3, 4, 16, 8, 1, 0.5)
    a, b = torch.from_numpy(d["a_full"]), torch.from_numpy(d["b"])
    one = torch.from_numpy(d["kb"][:1])
    y = gm.gather_matmul_stepped(a, b, one, block_size=1)
    y3 = gm.gather_matmul_stepped(a, b, one.expand(3, -1), block_size=1)
    torch.testing.assert_close(y, y3, rtol=0, atol=0)


def test_alpha_scales_result():
    d = _data(1, 3, 16, 8, 1, 0.5)
    a, b, kb = (torch.from_numpy(d[k][0] if k != "b" else d[k]) for k in ("a_full", "b", "kb"))
    torch.testing.assert_close(gm.gather_matmul(a, b, kb, block_size=1, alpha=2.5),
                               2.5 * gm.gather_matmul(a, b, kb, block_size=1))


def test_cpu_does_not_count_launches():
    before = dict(gm.LAUNCHES)
    d = _data(2, 3, 16, 8, 1, 0.5)
    gm.gather_matmul_stepped(torch.from_numpy(d["a_full"]), torch.from_numpy(d["b"]),
                             torch.from_numpy(d["kb"]), block_size=1)
    assert gm.LAUNCHES == before


# (mode, T, M, C, O) of every K1/K2 call on the main paths: zaremba-medium
# (M = 20, k = 325, 4H = 2600, T = 35) and luong-nmt (M = 64, k = 358,
# 4H = 2048, T = 50); C is the contraction, O the output width.
MAIN_SHAPES = [(mode, T_, M_, *((k_, n_) if mode == "fp" else (n_, k_)))
               for M_, k_, n_, T_s in ((20, 325, 2600, 35), (64, 358, 2048, 50))
               for T_ in (1, T_s) for mode in ("fp", "bp")]


def _vec(mode, C, O):
    """The copy widths the wrapper asks for when both base pointers are
    aligned: a's rows are C floats long, b's N (O in FP, C in BP)."""
    if mode == "cols":
        return False, False
    return C % 4 == 0, (O if mode == "fp" else C) % 4 == 0


@pytest.mark.parametrize("mode,T,M,C,O", MAIN_SHAPES + [
    ("fp", 1, 1, 8, 24), ("bp", 3, 33, 17, 9), ("cols", 1, 65, 64, 7),
    ("bp", 1, 5, 4, 40), ("fp", 2, 64, 600, 17), ("bp", 1, 20, 100000, 3)])
def test_plan_covers_each_output_once(mode, T, M, C, O):
    """Every (t, m, o) output lies in exactly one CTA's tile, and the
    cluster's splits cover the contraction exactly once, none empty."""
    pl = gm._plan(mode, T, M, C, O, *_vec(mode, C, O))
    assert 1 <= pl.split <= gm.MAX_SPLIT
    assert pl.split == 1 or pl.csplit % 4 == 0
    gx, gy, gz = pl.grid
    assert gz == T and gx % pl.split == 0
    hits = np.zeros((T, M, O), np.int64)
    cover = np.zeros(C, np.int64)
    for x in range(gx):
        tile, rank = divmod(x, pl.split)
        lo, hi = rank * pl.csplit, min(C, (rank + 1) * pl.csplit)
        assert lo < hi, f"split {rank} of {pl.split} is empty"
        if tile == 0:
            cover[lo:hi] += 1
        if rank == 0:
            for y in range(gy):
                hits[:, y * pl.bm:(y + 1) * pl.bm, tile * pl.bn:(tile + 1) * pl.bn] += 1
    assert (hits == 1).all()
    assert (cover == 1).all()


@pytest.mark.parametrize("mode,T,M,C,O", MAIN_SHAPES)
def test_plan_fills_the_card_on_the_main_path(mode, T, M, C, O):
    """At least one CTA per H100 SM at every main-path shape; row tiles of
    exactly M (20 or 64 rows)."""
    pl = gm._plan(mode, T, M, C, O, *_vec(mode, C, O))
    assert int(np.prod(pl.grid)) >= gm.H100_SMS
    assert pl.bm == M and pl.grid[1] == 1
    assert (pl.va, pl.vb) == ((False, True) if mode == "fp" else (True, True))


@pytest.mark.parametrize("case", ["fp k=325", "bp N=17", "storage_offset 1"])
def test_plan_takes_four_byte_copies_where_rows_are_unaligned(case):
    if case == "fp k=325":       # a_c rows of 325 floats
        a, b, mode, C, O = torch.zeros(20, 325), torch.zeros(650, 2600), "fp", 325, 2600
    elif case == "bp N=17":      # dy and b rows of 17 floats
        a, b, mode, C, O = torch.zeros(4, 17), torch.zeros(48, 17), "bp", 17, 36
    else:                        # contiguous, but 4 bytes past a 16-byte boundary
        a = torch.zeros(20 * 2600 + 1)[1:].view(20, 2600)
        b, mode, C, O = torch.zeros(650, 2600), "bp", 2600, 325
    assert a.is_contiguous()
    va = gm._vec_ok(a, a.shape[1])
    vb = gm._vec_ok(b, b.shape[1])
    pl = gm._plan(mode, 1, a.shape[0], C, O, va, vb)
    assert not pl.va
    assert pl.vb == (case == "fp k=325")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fp", "fp_compact", "bp"])
@pytest.mark.parametrize("T,M,H,N,bs,rate", CASES + [(35, 20, 650, 2600, 1, 0.5),
                                                    (50, 64, 512, 2048, 1, 0.3)])
def test_cuda_kernel_matches_plain(T, M, H, N, bs, rate, variant):
    dev = require_cuda()
    d = _data(T, M, H, N, bs, rate, seed=2)
    if variant == "bp":
        a, kw = d["a_out"], dict(transpose_b=True)
    elif variant == "fp_compact":
        a, kw = np.take_along_axis(d["a_full"], d["ids"][:, None, :], axis=2), dict(a_is_compact=True)
    else:
        a, kw = d["a_full"], {}
    a, b, kb = torch.from_numpy(a), torch.from_numpy(d["b"]), torch.from_numpy(d["kb"])
    want = gm.gather_matmul_stepped(a, b, kb, block_size=bs, alpha=2.0, **kw)
    n0 = sum(gm.LAUNCHES.values())
    got = gm.gather_matmul_stepped(a.to(dev), b.to(dev), kb.to(dev), block_size=bs,
                                   alpha=2.0, **kw)
    got1 = gm.gather_matmul(a[0].to(dev), b.to(dev), kb[0].to(dev), block_size=bs,
                            alpha=2.0, **kw)
    torch.cuda.synchronize()
    assert sum(gm.LAUNCHES.values()) == n0 + 2
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got1.cpu(), want[0], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_kernel_rejects_non_f32():
    dev = require_cuda()
    a = torch.zeros(2, 3, 8, device=dev, dtype=torch.float64)
    b = torch.zeros(8, 4, device=dev)
    with pytest.raises(TypeError):
        gm.gather_matmul_stepped(a, b, torch.zeros(2, 4, dtype=torch.int32, device=dev),
                                 block_size=1)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fp_compact", "bp"])
@pytest.mark.parametrize("M", [1, 20, 21, 33, 64, 65])
@pytest.mark.parametrize("T", [1, 4])
def test_cuda_kernel_row_tiles(T, M, variant):
    """Row counts at, below and past the 20- and 64-row tiles, one step
    (cluster split) and several."""
    dev = require_cuda()
    d = _data(T, M, 96, 384, 1, 0.5, seed=3)
    if variant == "bp":
        a, kw = d["a_out"], dict(transpose_b=True)
    else:
        a, kw = np.take_along_axis(d["a_full"], d["ids"][:, None, :], axis=2), dict(a_is_compact=True)
    a, b, kb = torch.from_numpy(a), torch.from_numpy(d["b"]), torch.from_numpy(d["kb"])
    want = gm.gather_matmul_stepped(a, b, kb, block_size=1, alpha=1.5, **kw)
    got = gm.gather_matmul_stepped(a.to(dev), b.to(dev), kb.to(dev), block_size=1,
                                   alpha=1.5, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fp_compact", "bp"])
def test_cuda_kernel_misaligned_a(variant):
    """A contiguous a whose first element is 4 bytes past a 16-byte
    boundary takes the 4-byte copies and agrees with the plain version."""
    dev = require_cuda()
    d = _data(1, 20, 648, 2592, 1, 0.5, seed=4)
    a = d["a_out"][0] if variant == "bp" else d["a_full"][0][:, d["ids"][0]]
    kw = dict(transpose_b=True) if variant == "bp" else dict(a_is_compact=True)
    flat = torch.zeros(a.size + 1, device=dev)
    a_dev = flat[1:].view(a.shape)
    a_dev.copy_(torch.from_numpy(a))
    assert a_dev.is_contiguous() and not gm._vec_ok(a_dev, a.shape[1])
    b, kb = torch.from_numpy(d["b"]), torch.from_numpy(d["kb"][0])
    want = gm.gather_matmul(torch.from_numpy(a), b, kb, block_size=1, **kw)
    got = gm.gather_matmul(a_dev, b.to(dev), kb.to(dev), block_size=1, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_bp_split_is_deterministic():
    """The cluster-split BP sums its partial tiles in rank order: two
    launches at the zaremba-medium shape give the same bits."""
    dev = require_cuda()
    d = _data(1, 20, 650, 2600, 1, 0.5, seed=5)
    a, b = torch.from_numpy(d["a_out"][0]).to(dev), torch.from_numpy(d["b"]).to(dev)
    kb = torch.from_numpy(d["kb"][0]).to(dev)
    assert gm._plan("bp", 1, 20, 2600, kb.numel(), True, True).split > 1
    y1 = gm.gather_matmul(a, b, kb, block_size=1, transpose_b=True)
    y2 = gm.gather_matmul(a, b, kb, block_size=1, transpose_b=True)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
