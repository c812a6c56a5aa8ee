"""Grouped (per-expert) matmul (K12) on a hand-written kernel.

Port of ``repro.kernels.grouped_matmul``: over expert-sorted rows,

    y[i] = x[i] @ w[blk_expert[i // bm]]

with x ``(T, D)``, w ``(E, D, F)`` and one expert id per row block of
``bm`` rows. Unlike the Pallas kernel, any ``bm >= 1`` and any T, D, F are
taken: the last row block may be shorter and the kernel masks every ragged
edge. ``bf``/``bk`` are the reference's VMEM tile sizes, accepted and
unused. A block whose expert id lies outside ``[0, E)`` comes out as zeros
on both routes.

A CUDA tensor launches one of two kernels (``route``), y in x's dtype,
and bumps ``LAUNCHES``, ``LAUNCHES_BY_ROUTE`` and ``LAUNCHES_BY_SHAPE``
(under ``"grouped_matmul/{D}x{F}"``, which tells a layer's gate/up
products from its down product); a CPU tensor runs
``grouped_matmul_plain`` (the loop of the reference's test oracle).
bfloat16 with D and F positive multiples of 8 (TMA's 16-byte strides)
takes ``"wgmma"``, ``csrc/grouped_matmul_sm90.cu``: Hopper's wgmma on TMA
tiles, bfloat16 products with float32 sums, as the reference's. Everything
else, float32 and bfloat16 of other widths, takes ``"tf32"``,
``csrc/grouped_matmul.cu``, on the TF32 tensor cores with float32 sums: a
float32 operand is split into a TF32 high part and a TF32 remainder and
each product is taken as three TF32 products ("3xTF32"), which keeps
float32's accuracy; bfloat16 values are TF32 values and take one. A failed
build, tensor map or launch raises; no route falls back to the other. The
wrapper is not differentiable: the MoE layer's ``"pallas"`` route wraps it
in an autograd.Function whose backward is two library products
(models/transformer.py), as the reference leaves those products to XLA.

``plan_groups`` is the port's copy of the reference's static buffer layout.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

LAUNCHES = {"grouped_matmul": 0}
LAUNCHES_BY_ROUTE = {"grouped_matmul/wgmma": 0, "grouped_matmul/tf32": 0}
LAUNCHES_BY_SHAPE: dict = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, D: int, F: int) -> str:
    """The kernel a launch takes: ``"wgmma"`` (bfloat16, D and F positive
    multiples of 8) or ``"tf32"`` (everything else)."""
    if dtype == torch.bfloat16 and D > 0 and D % 8 == 0 and F % 8 == 0:
        return "wgmma"
    return "tf32"


def plan_groups(counts: torch.Tensor, bm: int, capacity_blocks: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-expert token counts -> (row offsets into the padded sorted
    buffer, per-row-block expert ids). Expert e owns the block slots
    ``[e * capacity_blocks, (e + 1) * capacity_blocks)``, so the layout is
    static: T_pad = E * capacity_blocks * bm, whatever the counts."""
    E = counts.shape[0]
    ar = torch.arange(E, dtype=torch.int32, device=counts.device)
    return ar * capacity_blocks * bm, ar.repeat_interleave(capacity_blocks)


def _check(x, w, blk_expert, bm):
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}: expected "
                         f"(T, D) and (E, D, F)")
    if int(bm) < 1:
        raise ValueError(f"bm must be >= 1, got {bm}")
    nblk = -(-x.shape[0] // int(bm))
    if blk_expert.dim() != 1 or blk_expert.shape[0] != nblk:
        raise ValueError(f"blk_expert {tuple(blk_expert.shape)}: expected "
                         f"({nblk},) for T={x.shape[0]}, bm={bm}")
    if blk_expert.dtype.is_floating_point or blk_expert.dtype == torch.bool:
        raise TypeError(f"blk_expert must hold integers, got {blk_expert.dtype}")
    if len({x.device, w.device, blk_expert.device}) != 1:
        raise ValueError(f"x, w, blk_expert on {x.device}, {w.device}, "
                         f"{blk_expert.device}")
    if x.dtype != w.dtype:
        raise TypeError(f"x is {x.dtype}, w is {w.dtype}")


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         blk_expert: torch.Tensor, *, bm: int) -> torch.Tensor:
    """K12's plain version: one product per row block, float32 sums, y in
    x's dtype."""
    _check(x, w, blk_expert, bm)
    T, E, F = x.shape[0], w.shape[0], w.shape[2]
    y = torch.zeros((T, F), dtype=x.dtype, device=x.device)
    for i, e in enumerate(blk_expert.tolist()):
        if 0 <= e < E:
            rows = slice(i * bm, min((i + 1) * bm, T))
            y[rows] = (x[rows].float() @ w[e].float()).to(x.dtype)
    return y


_P, _I = ctypes.c_void_p, ctypes.c_int
# the C library, entry point and argument types of each route: (x, w, ids,
# y, T, D, F, E, bm, stream), the tf32 one led by (dtype, vec)
_ROUTE_LIB = {"wgmma": ("grouped_matmul_sm90", "grouped_matmul_sm90_launch",
                        [_P] * 4 + [_I] * 5 + [_P]),
              "tf32": ("grouped_matmul", "grouped_matmul_launch",
                       [_I] * 2 + [_P] * 4 + [_I] * 5 + [_P])}


def _entry(r):
    """The C entry point of route ``r``, typed."""
    name, fn_name, argtypes = _ROUTE_LIB[r]
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if not getattr(lib, "_typed", False):
        fn.argtypes = argtypes
        fn.restype = _I
        lib._typed = True
    return lib, fn


def _prep(x, r):
    """``x`` contiguous; on the ``"wgmma"`` route, whose tiles TMA reads,
    also on a 16-byte aligned base (copied otherwise)."""
    x = x.contiguous()
    if r == "wgmma" and x.data_ptr() % 16:
        x = x.clone()
    return x


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                        blk_expert: torch.Tensor, *, bm: int) -> torch.Tensor:
    """K12 on CUDA tensors: y (T, F) in x's dtype."""
    _check(x, w, blk_expert, bm)
    if x.device.type != "cuda":
        raise ValueError(f"K12 needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"K12 takes float32 or bfloat16, got {x.dtype}")
    T, D = x.shape
    E, _, F = w.shape
    r = route(x.dtype, D, F)
    x, w = _prep(x, r), _prep(w, r)
    ids = blk_expert.to(torch.int32).contiguous()
    y = torch.empty((T, F), dtype=x.dtype, device=x.device)
    lib, fn = _entry(r)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), w.data_ptr(), ids.data_ptr(), y.data_ptr())
    if r == "wgmma":
        code = fn(*ptrs, T, D, F, E, int(bm), stream)
    else:
        per16 = 16 // x.element_size()          # elements of a 16-byte copy
        vec = (D % per16 == 0 and F % per16 == 0 and x.data_ptr() % 16 == 0
               and w.data_ptr() % 16 == 0)
        code = fn(_DTYPES[x.dtype], int(vec), *ptrs, T, D, F, E, int(bm), stream)
    _build.check(lib, code, f"grouped_matmul ({r})")
    LAUNCHES["grouped_matmul"] += 1
    LAUNCHES_BY_ROUTE[f"grouped_matmul/{r}"] += 1
    key = f"grouped_matmul/{D}x{F}"
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return y


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, blk_expert: torch.Tensor,
                   *, bm: int = 128, bf: Optional[int] = None,
                   bk: Optional[int] = None) -> torch.Tensor:
    """x (T, D) expert-sorted rows; w (E, D, F); blk_expert (ceil(T / bm),)
    expert id per row block -> y (T, F)."""
    del bf, bk
    _check(x, w, blk_expert, bm)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, blk_expert, bm=bm)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return grouped_matmul_cuda(x, w, blk_expert, bm=bm)
