"""K12, the grouped (per-expert) matmul: the port's plain version against
the JAX reference's Pallas kernel in interpret mode (as tests/test_grouped.py
runs it on the CPU), ``plan_groups`` against the reference's, the
sorted-buffer end-to-end case, and the port's own extensions (any bm,
ragged row blocks, out-of-range expert ids give zeros). The ``cuda``-marked
tests hold the CUDA kernel against the plain version on the card (skipped
without one).

Inputs are made with numpy from a seed and given to both sides.
Tolerances: float32 rtol/atol 1e-4 (the reference test's; the same products
in another summation order), bfloat16 3e-2 (the reference's bf16 tolerance;
both sides round the float32 sums to bfloat16). On the card the kernel
multiplies on the TF32 tensor cores, a float32 operand split into a TF32
high part and remainder and each product taken as three TF32 products
("3xTF32"): float32 within 1e-4 x max(1, |ref|) of the plain version,
bfloat16 3e-2, and at D=6144 within 1e-5 x max(1, |ref|) of a float64
product, which keeps float32's accuracy and which single-pass TF32 (~3e-4)
would not meet.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_matmul as gm
from repro_torch.testing import require_cuda

torch.set_num_threads(1)

SWEEP = [(32, 16, 24, 4, 8), (64, 32, 32, 2, 16), (128, 64, 128, 8, 16),
         (24, 8, 8, 3, 8)]          # T, D, F, E, bm (tests/test_grouped.py)
TILES = {(32, 16, 24, 4, 8): (8, 8), (64, 32, 32, 2, 16): (16, 16),
         (128, 64, 128, 8, 16): (64, 32), (24, 8, 8, 3, 8): (8, 8)}   # bf, bk


def _inputs(T, D, F, E, bm, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) / D ** 0.5).astype(np.float32)
    blk = rng.integers(0, E, -(-T // bm)).astype(np.int32)
    return x, w, blk


def _oracle(x, w, blk, bm):
    """The per-block loop, in float64 numpy."""
    y = np.zeros((x.shape[0], w.shape[2]))
    for i, e in enumerate(blk):
        if 0 <= e < w.shape[0]:
            y[i * bm:(i + 1) * bm] = x[i * bm:(i + 1) * bm].astype(np.float64) @ w[e]
    return y


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference(shape, dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.grouped_matmul import grouped_matmul as r_gmm
    T, D, F, E, bm = shape
    bf, bk = TILES[shape]
    x, w, blk = _inputs(*shape)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    want = np.asarray(r_gmm(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
                            jnp.asarray(blk), bm=bm, bf=bf, bk=bk, interpret=True),
                      np.float32)
    got = gm.grouped_matmul(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                            torch.from_numpy(blk), bm=bm, bf=bf, bk=bk)
    assert got.dtype == td and got.shape == (T, F)
    tol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_plan_groups_static_layout():
    """tests/test_grouped.py's case: counts ignored, static slots."""
    offsets, blk = gm.plan_groups(torch.tensor([5, 0, 17, 8], dtype=torch.int32),
                                  bm=8, capacity_blocks=3)
    assert offsets.tolist() == [0, 24, 48, 72]
    assert blk.dtype == torch.int32 and blk.tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2,
                                                         3, 3, 3]


@pytest.mark.parametrize("E,bm,cap", [(4, 8, 3), (1, 1, 1), (6, 16, 2)])
def test_plan_groups_matches_reference(E, bm, cap):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.grouped_matmul import plan_groups as r_plan
    counts = np.random.default_rng(E).integers(0, 40, E).astype(np.int32)
    r_off, r_blk = r_plan(jnp.asarray(counts), bm=bm, capacity_blocks=cap)
    t_off, t_blk = gm.plan_groups(torch.from_numpy(counts), bm=bm, capacity_blocks=cap)
    assert t_off.tolist() == np.asarray(r_off).tolist()
    assert t_blk.tolist() == np.asarray(r_blk).tolist()


def test_sorted_buffer_end_to_end():
    """tests/test_grouped.py::test_matches_dense_moe_compute on the port:
    an expert-sorted, block-padded buffer built with plan_groups, then every
    token's row equals x @ w[its expert]."""
    T, D, F, E, bm = 32, 16, 32, 4, 8
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((E, D, F)) / D ** 0.5).astype(np.float32))
    expert_of = torch.from_numpy(rng.integers(0, E, T))
    offsets, blk = gm.plan_groups(torch.bincount(expert_of, minlength=E), bm=bm,
                                  capacity_blocks=T // bm)
    buf = torch.zeros((E * (T // bm) * bm, D))
    pos = [0] * E
    rows = []
    for i in torch.argsort(expert_of, stable=True).tolist():
        e = int(expert_of[i])
        rows.append((int(offsets[e]) + pos[e], i))
        pos[e] += 1
    for dst, src in rows:
        buf[dst] = x[src]
    y = gm.grouped_matmul(buf, w, blk, bm=bm, bf=16, bk=16)
    for dst, src in rows:
        torch.testing.assert_close(y[dst], x[src] @ w[int(expert_of[src])],
                                   rtol=1e-4, atol=1e-4)
    used = {dst for dst, _ in rows}
    empty = [r for r in range(buf.shape[0]) if r not in used]
    assert (y[empty] == 0).all()          # rows that hold no token stay zero


@pytest.mark.parametrize("T,D,F,E,bm", [(37, 13, 21, 3, 5), (10, 7, 9, 2, 10),
                                        (9, 4, 4, 2, 20), (130, 36, 40, 5, 1)])
def test_any_bm_and_ragged_tails(T, D, F, E, bm):
    """Beyond the reference: bm that does not divide T (the last block is
    shorter) and widths with no tiling at all."""
    x, w, blk = _inputs(T, D, F, E, bm, seed=T)
    got = gm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(blk), bm=bm)
    np.testing.assert_allclose(got.numpy(), _oracle(x, w, blk, bm), rtol=1e-5, atol=1e-5)


def test_out_of_range_expert_gives_zeros():
    x, w, blk = _inputs(24, 8, 8, 3, 8)
    blk[1] = 3
    blk[2] = -1
    got = gm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(blk), bm=8)
    assert (got[8:] == 0).all()
    np.testing.assert_allclose(got[:8].numpy(), x[:8] @ w[blk[0]], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["blk_len", "bm", "width", "dtype"])
def test_bad_inputs_raise(bad):
    x, w, blk = (torch.from_numpy(a) for a in _inputs(32, 16, 24, 4, 8))
    kw = dict(bm=8)
    if bad == "blk_len":
        blk = blk[:-1]
    elif bad == "bm":
        kw = dict(bm=0)
    elif bad == "width":
        w = w[:, :-1]
    else:
        w = w.double()
    with pytest.raises((ValueError, TypeError)):
        gm.grouped_matmul(x, w, blk, **kw)


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------

CUDA_CASES = [
    # T, D, F, E, bm, dtype
    (32, 16, 24, 4, 8, torch.float32),
    (128, 64, 128, 8, 16, torch.bfloat16),
    (1280, 256, 384, 4, 320, torch.float32),      # blocks of several tiles
    (300, 100, 130, 3, 100, torch.float32),       # bm not a multiple of 128
    (257, 37, 61, 5, 23, torch.float32),          # tails everywhere, scalar loads
    (512, 64, 96, 8, 64, torch.bfloat16),
    # the tensor-core kernel's tiling: 128 x 128 CTA tiles inside a row
    # block, contraction steps of 32 through a 4-stage cp.async ring,
    # 16-byte copies where rows are multiples of 16 bytes, 4-byte (float32)
    # or plain (bfloat16) loads otherwise
    (200, 16, 128, 3, 64, torch.float32),         # D below one 32-step
    (256, 96, 136, 2, 128, torch.float32),        # D below stages x 32; F tail
    (300, 37, 61, 3, 50, torch.float32),          # 4-byte copies; bm below the tile
    (700, 45, 130, 4, 200, torch.float32),        # 4-byte copies; bm across the tile
    (333, 64, 96, 3, 130, torch.bfloat16),        # bf16 16-byte copies; T, bm tails
    (300, 100, 132, 3, 70, torch.bfloat16),       # bf16 plain loads, tails everywhere
    (129, 5, 3, 2, 129, torch.bfloat16),          # widths below one copy
]


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,F,E,bm,dtype", CUDA_CASES)
def test_cuda_kernel_matches_plain(T, D, F, E, bm, dtype):
    dev = require_cuda()
    x, w, blk = _inputs(T, D, F, E, bm, seed=T)
    blk[0] = blk[-1]                      # repeated ids across blocks
    args = (torch.from_numpy(x).to(dev, dtype), torch.from_numpy(w).to(dev, dtype),
            torch.from_numpy(blk).to(dev))
    before = gm.LAUNCHES["grouped_matmul"]
    got = gm.grouped_matmul(*args, bm=bm)
    torch.cuda.synchronize()
    assert gm.LAUNCHES["grouped_matmul"] == before + 1
    want = gm.grouped_matmul_plain(*args, bm=bm)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_cuda_empty_expert_rows_are_exactly_zero():
    dev = require_cuda()
    x, w, blk = _inputs(64, 32, 40, 4, 16)
    x[16:32] = 0.0                         # a block that holds no token
    got = gm.grouped_matmul(torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev),
                            torch.from_numpy(blk).to(dev), bm=16)
    assert (got[16:32] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_out_of_range_expert_gives_zeros(dtype):
    dev = require_cuda()
    x, w, blk = _inputs(300, 64, 160, 3, 100)
    blk[1], blk[2] = 3, -1
    args = (torch.from_numpy(x).to(dev, dtype), torch.from_numpy(w).to(dev, dtype),
            torch.from_numpy(blk).to(dev))
    got = gm.grouped_matmul(*args, bm=100)
    torch.cuda.synchronize()
    assert (got[100:] == 0).all()
    want = gm.grouped_matmul_plain(*args, bm=100)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    scale = max(1.0, want.float().abs().max().item())
    assert (got[:100].float() - want[:100].float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_cuda_float32_accuracy_at_mixtral_depth():
    """D = 6144 (mixtral-8x22b's d_model) against float64: 3xTF32 keeps
    float32's accuracy, 1e-5 x max(1, |ref|)."""
    dev = require_cuda()
    x, w, blk = _inputs(256, 6144, 256, 2, 128, seed=6144)
    got = gm.grouped_matmul(torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev),
                            torch.from_numpy(blk).to(dev), bm=128)
    want = _oracle(x, w, blk, 128)
    err = np.abs(got.cpu().double().numpy() - want).max()
    assert err <= 1e-5 * max(1.0, np.abs(want).max())
