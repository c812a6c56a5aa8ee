"""Block-gather matmul — the paper's compaction — on a hand-written kernel.

Port of ``repro.kernels.gather_matmul`` (Pallas ``_mm_kernel`` and
``_mm_kernel_stepped``). One CUDA kernel (``csrc/gather_matmul.cu``) serves
both wrappers; ``gather_matmul`` is the one-row (T = 1) case of
``gather_matmul_stepped``. Variants, with ``kept`` the kept unit ids:

  FP   : y  = a_c @ b[kept, :]         (gather="b_rows")
  BP   : dx = dy @ b[kept, :].T        (gather="b_rows", transpose_b)
  COLS : y  = a @ b[:, kept]           (gather="b_cols", unstepped only)

Block ids are expanded to unit ids here, so the kernel tiles the compact
axis independently of the dropout block size. ``alpha`` scales the result
in the kernel's epilogue (the inverted-dropout scale; the Pallas kernel
leaves it to its caller, which is numerically the same).

``_plan`` picks the kernel's row and column tile, the cluster split of the
contraction and the copy width from the call's shapes and alignment; it is
pure Python, so the CPU tests reach it. A CUDA tensor launches the kernel
(float32, contiguous; anything else raises, as does a plan the kernel
refuses) and bumps ``LAUNCHES``; a CPU tensor runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.masks import keep_blocks_to_unit_ids
from repro_torch.kernels import _build

# launches per wrapper and variant ("fp", "bp", "cols")
LAUNCHES = {"gather_matmul/fp": 0, "gather_matmul/bp": 0,
            "gather_matmul/cols": 0, "gather_matmul_stepped/fp": 0,
            "gather_matmul_stepped/bp": 0}

_MODES = {"fp": 0, "bp": 1, "cols": 2}
MAX_SPLIT = 8          # the portable thread block cluster size
H100_SMS = 132


class Plan(NamedTuple):
    """One launch: bm x bn output tiles; the contraction split over a
    cluster of ``split`` CTAs, rank r summing [r * csplit, (r + 1) *
    csplit); 16-byte (True) or 4-byte copies of a and b; the grid
    (ceil(O / bn) * split, ceil(M / bm), T)."""
    bm: int
    bn: int
    split: int
    csplit: int
    va: bool
    vb: bool
    grid: Tuple[int, int, int]


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


@functools.lru_cache(maxsize=None)
def _plan(mode: str, T: int, M: int, C: int, O: int, va: bool, vb: bool,
          sms: int = H100_SMS, a_gather: bool = False) -> Plan:
    """The kernel's launch for T steps of (M, C) @ (C, O).

    ``va`` / ``vb``: whether a's and b's rows may be copied 16 bytes at a
    time (``_vec_ok``); the plan keeps only the combinations the kernel has
    (FP: a only with b, neither when a is gathered; BP: both or neither;
    COLS: neither). Rows tile at 20 (M <= 20: zaremba's batch, unpadded)
    or 64; a 64-row CTA (256 threads) counts 8/5 of a 20-row one (160).
    FP tiles its wide output at 64 columns (128 on 64-row tiles that still
    make four waves), BP its narrow one at 32; both narrow (FP to 32, BP to
    16) where that would not make two waves, and then split the contraction
    over a cluster of up to 8 CTAs until the CTAs make two waves, in
    multiples of 4 so that every split starts on a 16-byte boundary, none
    empty and none under 64 long. The rules follow the device times that
    ``launch/tune_gather.py`` measured at the main paths' shapes.
    """
    bm = 20 if M <= 20 else 64
    mt = _cdiv(M, bm)

    def waves(bn):
        """CTA waves of bn-column tiles, in 160-thread CTAs per SM."""
        return T * mt * _cdiv(O, bn) * (1.0 if bm == 20 else 8 / 5) / sms

    if mode == "cols":
        va = vb = False
        bn, split, csplit = 64, 1, C
    else:
        if mode == "fp":
            va, vb = va and vb and not a_gather, vb and not a_gather
            bn = 128 if bm == 64 and waves(128) >= 4 else 64 if waves(64) >= 2 else 32
        else:
            va = vb = va and vb
            bn = 32 if waves(32) >= 2 else 16
        want = 1
        while want < min(MAX_SPLIT, max(1, C // 64)) and waves(bn) * want < 2:
            want += 1
        csplit = 4 * _cdiv(_cdiv(C, want), 4)
        split = _cdiv(C, csplit)
        if split == 1:
            csplit = C
    return Plan(bm, bn, split, csplit, va, vb, (_cdiv(O, bn) * split, mt, T))


def _vec_ok(x: torch.Tensor, width: int) -> bool:
    """Whether rows of ``width`` floats from ``x``'s first element start on
    16-byte boundaries."""
    return x.data_ptr() % 16 == 0 and width % 4 == 0


def _lib():
    lib = _build.load("gather_matmul")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.gather_matmul_f32.argtypes = [p, p, p, p, p, ctypes.c_float, p]
        lib.gather_matmul_f32.restype = ctypes.c_int
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _params(mode, T, M, C, O, lda, ldb, ids_tstride, a_gather, va, vb, sms):
    """The C entry point's plan array for one call shape (the cache keeps
    it alive)."""
    pl = _plan(mode, T, M, C, O, va, vb, sms, a_gather)
    return (ctypes.c_int * 15)(
        _MODES[mode], T, M, C, O, lda, ldb, ids_tstride, int(a_gather), pl.bm,
        pl.bn, pl.split, pl.csplit, int(pl.va), int(pl.vb))


def _mode(gather: str, transpose_b: bool) -> str:
    if gather == "b_rows":
        return "bp" if transpose_b else "fp"
    if gather == "b_cols" and not transpose_b:
        return "cols"
    raise ValueError(f"bad gather={gather!r} transpose_b={transpose_b}")


def _check(a, b, ids):
    dev = a.get_device()
    for name, x, dt in (("a", a, torch.float32), ("b", b, torch.float32),
                        ("keep ids", ids, torch.int32)):
        if x.get_device() != dev:
            raise ValueError(f"{name} on {x.device}, a on {a.device}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(mode, a, b, ids, *, a_is_compact, alpha):
    """a (T, M, Ka), or (M, Ka) for one step; b (K, N); ids (R, k) unit ids
    with R in (1, T), or (k,) for one row. Returns y (T, M, O), or (M, O)
    for a 2-D a."""
    _check(a, b, ids)
    *lead, M, Ka = a.shape
    T = lead[0] if lead else 1
    K, N = b.shape
    R, k = ids.shape if ids.dim() == 2 else (1, ids.shape[0])
    if R not in (1, T):
        raise ValueError(f"ids table has {R} rows for T={T}")
    if mode == "fp":
        if Ka != (k if a_is_compact else K):
            raise ValueError(f"a width {Ka} != {'k' if a_is_compact else 'K'}")
        C, O = k, N
    elif mode == "bp":
        if Ka != N:
            raise ValueError(f"a width {Ka} != b width {N}")
        C, O = N, k
    else:
        if Ka != K:
            raise ValueError(f"a width {Ka} != b rows {K}")
        C, O = K, k
    a_gather = mode == "fp" and not a_is_compact
    dev = a.get_device()
    params = _params(mode, T, M, C, O, Ka, N, 0 if R == 1 else k, a_gather,
                     not a_gather and mode != "cols" and _vec_ok(a, Ka),
                     mode != "cols" and _vec_ok(b, N), _sms(dev))
    y = torch.empty((*lead, M, O), dtype=torch.float32, device=a.device)
    lib = _lib()
    # the current stream as a raw handle, without a torch.cuda.Stream object
    code = lib.gather_matmul_f32(params, a.data_ptr(), b.data_ptr(),
                                 ids.data_ptr(), y.data_ptr(), alpha,
                                 torch._C._cuda_getCurrentRawStream(dev))
    if code:
        _build.check(lib, code, "gather_matmul")
    return y


def _plain(mode, a, b, ids, *, a_is_compact, alpha):
    """Plain PyTorch version: a (T, M, Ka), ids (R, k) unit ids."""
    T = a.shape[0]
    ids = ids.long().expand(T, ids.shape[1])
    if mode == "fp":
        a_c = a if a_is_compact else torch.gather(
            a, 2, ids[:, None, :].expand(T, a.shape[1], ids.shape[1]))
        y = torch.bmm(a_c, b[ids])                       # (T, M, N)
    elif mode == "bp":
        y = torch.bmm(a, b[ids].transpose(1, 2))         # (T, M, k)
    else:
        y = torch.bmm(a, b.t()[ids].transpose(1, 2))     # (T, M, k)
    return y * alpha


def gather_matmul_stepped_plain(a, b, keep_blocks, *, block_size,
                                a_is_compact=False, transpose_b=False,
                                alpha=1.0):
    ids = keep_blocks_to_unit_ids(keep_blocks, block_size)
    return _plain(_mode("b_rows", transpose_b), a, b, ids,
                  a_is_compact=a_is_compact, alpha=alpha)


def gather_matmul_plain(a, b, keep_blocks, *, block_size, gather="b_rows",
                        a_is_compact=False, transpose_b=False, alpha=1.0):
    ids = keep_blocks_to_unit_ids(keep_blocks, block_size)
    return _plain(_mode(gather, transpose_b), a[None], b, ids[None],
                  a_is_compact=a_is_compact, alpha=alpha)[0]


def gather_matmul_stepped(a: torch.Tensor, b: torch.Tensor,
                          keep_blocks: torch.Tensor, *, block_size: int,
                          a_is_compact: bool = False,
                          transpose_b: bool = False,
                          alpha: float = 1.0) -> torch.Tensor:
    """Per-step "b_rows" gather matmuls for a whole (T | 1, nk) ids table.

      not transpose_b (FP): a (T, M, nk*bs | K) -> y (T, M, N) = a_c @ b[kept_t]
      transpose_b     (BP): a (T, M, N)         -> y (T, M, nk*bs)
    """
    if not a.is_cuda:
        return gather_matmul_stepped_plain(
            a, b, keep_blocks, block_size=block_size,
            a_is_compact=a_is_compact, transpose_b=transpose_b, alpha=alpha)
    ids = keep_blocks_to_unit_ids(keep_blocks, block_size).contiguous()
    mode = _mode("b_rows", transpose_b)
    y = _launch(mode, a, b, ids, a_is_compact=a_is_compact, alpha=alpha)
    LAUNCHES[f"gather_matmul_stepped/{mode}"] += 1
    return y


def gather_matmul(a: torch.Tensor, b: torch.Tensor,
                  keep_blocks: torch.Tensor, *, block_size: int,
                  gather: str = "b_rows", a_is_compact: bool = False,
                  transpose_b: bool = False,
                  alpha: float = 1.0) -> torch.Tensor:
    """One mask's gather matmul. a (M, Ka), b (K, N), keep_blocks (nk,)."""
    if not a.is_cuda:
        return gather_matmul_plain(
            a, b, keep_blocks, block_size=block_size, gather=gather,
            a_is_compact=a_is_compact, transpose_b=transpose_b, alpha=alpha)
    ids = keep_blocks_to_unit_ids(keep_blocks, block_size).contiguous()
    mode = _mode(gather, transpose_b)
    y = _launch(mode, a, b, ids, a_is_compact=a_is_compact, alpha=alpha)
    LAUNCHES[f"gather_matmul/{mode}"] += 1
    return y
