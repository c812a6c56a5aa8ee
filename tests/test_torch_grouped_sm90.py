"""The bfloat16 route of K12, the grouped (per-expert) matmul: Hopper's wgmma
and TMA (``csrc/grouped_matmul_sm90.cu``, ``route() == "wgmma"``).

On the CPU: which kernel each (dtype, D % 8, F % 8) takes and the copies
the wrapper makes for TMA (a 16-byte aligned base). The ``cuda``-marked
cases hold the new kernel to the plain version on the card (3e-2 x max(1,
|ref|), the reference's bfloat16 tolerance) at the reference test's four
shapes, at bm 200 and 23, with an empty expert, out-of-range and unsorted
ids and T / D / F tails, to a float64 product (10 x the bfloat16 plain
version's distance + 1e-6), and to its own bits on a second launch; they
skip here. This module does not import JAX, so the card runs it:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_grouped_sm90.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_matmul as gm
from repro_torch.testing import require_cuda

torch.set_num_threads(1)
BF16 = torch.bfloat16


@pytest.mark.parametrize("F", [96, 100])
@pytest.mark.parametrize("D", [64, 60])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_route(dtype, D, F):
    want = "wgmma" if dtype == BF16 and D % 8 == 0 and F % 8 == 0 else "tf32"
    assert gm.route(dtype, D, F) == want
    assert f"grouped_matmul/{want}" in gm.LAUNCHES_BY_ROUTE


def test_route_of_an_empty_contraction_is_tf32():
    """D = 0 gives zeros on the tf32 route; TMA takes no empty tensor."""
    assert gm.route(BF16, 0, 64) == "tf32"


@pytest.mark.parametrize("case,copied", [
    ("aligned", {"wgmma": False, "tf32": False}),
    ("offset_8_bytes", {"wgmma": True, "tf32": False}),
    ("offset_16_bytes", {"wgmma": False, "tf32": False}),
    ("not_contiguous", {"wgmma": True, "tf32": True}),
])
def test_prep_copies_what_tma_cannot_read(case, copied):
    store = torch.zeros(64 * 96 + 64, dtype=BF16)
    assert store.data_ptr() % 64 == 0
    x = {"aligned": store[:64 * 96].view(64, 96),
         "offset_8_bytes": store[4:4 + 64 * 96].view(64, 96),
         "offset_16_bytes": store[8:8 + 64 * 96].view(64, 96),
         "not_contiguous": store[:64 * 96].view(96, 64).t()}[case]
    for r, want in copied.items():
        got = gm._prep(x, r)
        assert (got.data_ptr() != x.data_ptr()) == want, r
        assert got.is_contiguous()
        torch.testing.assert_close(got, x, rtol=0, atol=0)
        if r == "wgmma":
            assert got.data_ptr() % 16 == 0


# ---------------------------------------------------------------------------
# the kernel on the card (skip without one)
# ---------------------------------------------------------------------------


def _inputs(T, D, F, E, bm, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((E, D, F)) / D ** 0.5).astype(np.float32))
    blk = torch.from_numpy(rng.integers(0, E, -(-T // bm)).astype(np.int32))
    return x, w, blk


def _on_card(dev, x, w, blk):
    return x.to(dev, BF16), w.to(dev, BF16), blk.to(dev)


CUDA_CASES = [
    # T, D, F, E, bm, ids
    (32, 16, 24, 4, 8, None),            # the reference test's four shapes
    (64, 32, 32, 2, 16, None),
    (128, 64, 128, 8, 16, None),
    (24, 8, 8, 3, 8, None),
    (600, 96, 160, 3, 200, None),        # bm 200: not a multiple of the tile
    (257, 72, 200, 5, 23, None),         # bm 23; T, D, F tails
    (1280, 256, 384, 4, 320, None),      # blocks of several tiles
    (700, 136, 264, 4, 300, None),       # D past two k-steps, F past one tile
    (512, 64, 96, 4, 128, [0, 0, 2, 3]),                            # expert 1 empty
    (384, 64, 64, 3, 32, [2, 0, 2, 2, 1, 0, 0, 1, 2, 1, 1, 0]),     # unsorted ids
    (300, 64, 160, 3, 100, [0, 3, -1]),                             # ids out of range
]


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,F,E,bm,ids", CUDA_CASES)
def test_cuda_kernel_matches_plain(T, D, F, E, bm, ids):
    dev = require_cuda()
    x, w, blk = _inputs(T, D, F, E, bm, seed=T)
    if ids is not None:
        blk = torch.tensor(ids, dtype=torch.int32)
    args = _on_card(dev, x, w, blk)
    assert gm.route(BF16, D, F) == "wgmma"
    before = dict(gm.LAUNCHES_BY_ROUTE)
    got = gm.grouped_matmul(*args, bm=bm)
    torch.cuda.synchronize()
    assert {k: gm.LAUNCHES_BY_ROUTE[k] - before[k] for k in before} == {
        "grouped_matmul/wgmma": 1, "grouped_matmul/tf32": 0}
    want = gm.grouped_matmul_plain(*args, bm=bm)
    assert got.dtype == BF16 and got.shape == (T, F)
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= 3e-2 * scale
    for i, e in enumerate(blk.tolist()):
        if not 0 <= e < E:                 # a bad id: zeros, nothing of w read
            assert (got[i * bm:(i + 1) * bm] == 0).all()


@pytest.mark.cuda
def test_cuda_kernel_keeps_the_plain_float64_distance():
    """At mixtral-8x22b's d_model (a contraction of 6144), one row block x
    256 columns within 10 x the bfloat16 plain version's distance to a
    float64 product + 1e-6 (the chip_smoke gate), and the same bits twice."""
    dev = require_cuda()
    x, w, blk = _inputs(512, 6144, 512, 2, 256, seed=6144)
    args = _on_card(dev, x, w, blk)
    got, plain = gm.grouped_matmul(*args, bm=256), gm.grouped_matmul_plain(*args, bm=256)
    assert torch.equal(got, gm.grouped_matmul(*args, bm=256))
    xb, wb = args[0][:256].double(), args[1][int(blk[0])].double()
    ref = xb @ wb[:, :256]
    rel = lambda y: float((y[:256, :256].double() - ref).abs().max()) / max(
        1.0, float(ref.abs().max()))
    assert rel(got) <= 10 * rel(plain) + 1e-6, (rel(got), rel(plain))


@pytest.mark.cuda
def test_cuda_kernel_reads_an_unaligned_base():
    """x and w starting 8 bytes into their storage: the wrapper copies them
    to an aligned base for TMA, and the result is the plain version's."""
    dev = require_cuda()
    x, w, blk = _inputs(200, 64, 96, 3, 50, seed=3)
    xs = torch.zeros(x.numel() + 8, dtype=BF16, device=dev)
    ws = torch.zeros(w.numel() + 8, dtype=BF16, device=dev)
    xs[4:4 + x.numel()] = x.flatten().to(dev, BF16)
    ws[4:4 + w.numel()] = w.flatten().to(dev, BF16)
    xv, wv = xs[4:4 + x.numel()].view(x.shape), ws[4:4 + w.numel()].view(w.shape)
    assert xv.data_ptr() % 16 and wv.data_ptr() % 16
    got = gm.grouped_matmul(xv, wv, blk.to(dev), bm=50)
    want = gm.grouped_matmul_plain(xv, wv, blk.to(dev), bm=50)
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= 3e-2 * scale
