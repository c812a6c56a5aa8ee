"""Flash attention (forward, dq pass, dk/dv pass) on hand-written kernels.

Port of ``repro.kernels.flash_attention``. Public layout as the reference:
q ``(B, Sq, Hq, d)``, k/v ``(B, Sk, Hkv, d)`` -> ``(B, Sq, Hq, d)``; query
head h reads kv head ``h // (Hq // Hkv)`` (grouped-query attention by head
index, no repeat). Scores ``(q . k) * d ** -0.5`` (the scale rounded to
float32) are masked to ``-1e30`` in float32 where the causal mask
(``qpos >= kpos``) or the sliding ``window`` (``qpos - kpos < window``)
drops them, positions counted from 0 in both sequences.

A CUDA tensor goes through ``torch.autograd.Function`` ``_FlashAttention``:
its forward launches K9 (o and the float32 log-sum-exp ``lse (B, Hq,
Sq)``) and saves (q, k, v, o, lse), as the reference's ``_fa_fwd_res``; its
backward computes ``delta = rowsum(do * o)`` in float32 outside the
kernels, as ``_flash_bwd``, then launches K10 (dq) and K11 (dk, dv, summed
over each kv head's group of query heads inside the kernel). The kernels
take float32 or bfloat16 and head_dim in ``HEAD_DIMS``; anything else
raises. On the ``"tf32"`` route (below) K9, K10 and K11 run their products
on the TF32 tensor cores in split precision (each float32 operand as a
TF32 hi and lo, three products summed in float32), which keeps float32's
accuracy; on either route launch to launch they give the same bits (no
atomics). A CPU tensor takes the plain version: the masked float32
scores materialised and a softmax (the reference's test oracle),
differentiated by autograd. ``LAUNCHES`` counts the kernel launches.

``flash_dq_plain`` and ``flash_dkv_plain`` are K10's and K11's plain
versions (the same formulas on materialised probabilities
``p = exp(s - lse)``), against which the kernels are held on the card;
``forward_float64`` and ``backward_float64`` are the forward and the
backward in float64 over one group of query heads, the oracles of the
kernels' float32 accuracy.

Two routes of kernels (``route``), by dtype and head_dim, the same for
all three passes:

========================  =========================================
dtype, head_dim           ``flash_fwd``, ``flash_dq``, ``flash_dkv``
========================  =========================================
bfloat16, 64 / 128 / 256  wgmma
bfloat16, 16 / 32         tf32
float32, any              tf32
========================  =========================================

``"wgmma"`` is ``csrc/flash_attention_sm90.cu`` (Hopper's wgmma from
shared memory and registers on TMA tiles; K9 with a producer warpgroup at
head_dim 64 and 128 and its thread 0 producing at 256, K10 and K11 with
their thread 0 producing, K10 at 256 on kv tiles of 32 keys, K11 at 256
split by role between its two warpgroups; K10's float32 ds and K11's p and
ds as two bfloat16 terms each); ``"tf32"`` is ``csrc/flash_attention.cu``.
A failed build or launch raises; no route falls back to the other.
``LAUNCHES_BY_ROUTE`` counts the launches of each (pass, route) beside
``LAUNCHES``.

Rows that see no key at all (a window with ``Sq > Sk + window - 1``) are
refused on the CPU and on the card: the reference's kernel gives them the
mean of v in the forward and a backward that disagrees with its own oracle
there.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
LAUNCHES_BY_ROUTE = {"flash_fwd/wgmma": 0, "flash_fwd/tf32": 0,
                     "flash_dq/wgmma": 0, "flash_dq/tf32": 0,
                     "flash_dkv/wgmma": 0, "flash_dkv/tf32": 0}

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PASS = {"flash_fwd": 0, "flash_dq": 1, "flash_dkv": 2}
# the bfloat16 head dims that take the wgmma route, in every pass
WGMMA_HEAD_DIMS = (64, 128, 256)
# the C library and entry point of each route
_ROUTE_LIB = {"wgmma": ("flash_attention_sm90", "flash_attention_sm90_launch"),
              "tf32": ("flash_attention", "flash_attention_launch")}


def route(which: str, dtype: torch.dtype, d: int) -> str:
    """The kernel a launch of pass ``which`` (``"flash_fwd"``,
    ``"flash_dq"`` or ``"flash_dkv"``) takes: ``"wgmma"`` (bfloat16 at
    ``WGMMA_HEAD_DIMS``, every pass alike) or ``"tf32"`` (everything
    else)."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS else "tf32"


def softmax_scale(d: int) -> float:
    """``d ** -0.5`` rounded to float32, as the reference's kernels apply it."""
    return float(torch.tensor(d ** -0.5, dtype=torch.float32))


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (B, S, H, d) with k, v alike")
    B, Sq, Hq, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or Hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} mismatch")
    if window is not None:
        if int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if Sq > k.shape[1] + int(window) - 1:
            raise ValueError(f"window {window} leaves query rows >= "
                             f"{k.shape[1] + int(window) - 1} with no key "
                             f"(Sq={Sq}, Sk={k.shape[1]})")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _visible(Sq, Sk, causal, window, device):
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        m &= qpos >= kpos
    if window is not None:
        m &= qpos - kpos < window
    return m


def _repeat_kv(x, G):
    """(B, S, Hkv, d) -> (B, S, Hkv * G, d): kv head j serves query heads
    j G .. j G + G - 1 (``repeat_interleave``, not ``Tensor.repeat``)."""
    return x.repeat_interleave(G, dim=2) if G > 1 else x


def _scores(q, k, causal, window):
    """Masked float32 scores (B, Hq, Sq, Sk)."""
    G = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _repeat_kv(k, G).float()) * softmax_scale(q.shape[3])
    vis = _visible(q.shape[1], k.shape[1], causal, window, q.device)
    return torch.where(vis, s, torch.full_like(s, NEG_INF))


def attention_plain(q, k, v, causal: bool = True,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's plain version: (o (B, Sq, Hq, d) in q's dtype, lse (B, Hq, Sq)
    float32), differentiable by autograd."""
    s = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    G = q.shape[2] // k.shape[2]
    o = torch.einsum("bhqk,bkhd->bqhd", p, _repeat_kv(v, G).float())
    return o.to(q.dtype), torch.logsumexp(s, dim=-1)


def _probs_and_ds(q, k, v, do, lse, delta, causal, window):
    s = _scores(q, k, causal, window)
    p = torch.exp(s - lse[..., None])
    G = q.shape[2] // k.shape[2]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _repeat_kv(v, G).float())
    ds = p * (dp - delta[..., None]) * softmax_scale(q.shape[3])
    return p, ds


def flash_dq_plain(q, k, v, do, lse, delta, causal=True, window=None):
    """K10's plain version: dq in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    G = q.shape[2] // k.shape[2]
    return torch.einsum("bhqk,bkhd->bqhd", ds,
                        _repeat_kv(k, G).float()).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal=True, window=None):
    """K11's plain version: (dk, dv) in k's and v's dtypes, per query head in
    float32 and summed over each kv head's group."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window)
    B, Sk, Hkv, d = k.shape
    G = q.shape[2] // Hkv
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return (dk.reshape(B, Sk, Hkv, G, d).sum(3).to(k.dtype),
            dv.reshape(B, Sk, Hkv, G, d).sum(3).to(v.dtype))


def _scores_float64(q, k, causal, window, b, hk):
    """Masked float64 scores (G, Sq, Sk) of the G query heads that read kv
    head ``hk`` of batch ``b`` (-inf where masked)."""
    G = q.shape[2] // k.shape[2]
    q64, k64 = q[b, :, hk * G:(hk + 1) * G].double(), k[b, :, hk].double()
    vis = _visible(q.shape[1], k.shape[1], causal, window, q.device)
    s = torch.einsum("qgd,kd->gqk", q64, k64) * softmax_scale(q.shape[3])
    return s.masked_fill(~vis, float("-inf"))


def forward_float64(q, k, v, causal=True, window=None, b=0, hk=0):
    """The forward of one (batch ``b``, kv head ``hk``) group in float64: o
    (Sq, G, d) and lse (G, Sq) of its G query heads. The float64 oracle that
    K9 is held to on the card."""
    s = _scores_float64(q, k, causal, window, b, hk)
    lse = torch.logsumexp(s, -1)
    o = torch.einsum("gqk,kd->qgd", torch.exp(s - lse[..., None]), v[b, :, hk].double())
    return o, lse


def backward_float64(q, k, v, do, causal=True, window=None, b=0, hk=0):
    """The backward of one (batch ``b``, kv head ``hk``) group in float64:
    (lse, delta) of its G query heads (G, Sq), their dq (Sq, G, d), and dk,
    dv (Sk, d) of kv head ``hk`` summed over the group. The float64 oracle
    that K10 and K11 are held to on the card."""
    G = q.shape[2] // k.shape[2]
    hs = slice(hk * G, (hk + 1) * G)
    scale = softmax_scale(q.shape[3])
    q64, do64 = q[b, :, hs].double(), do[b, :, hs].double()
    k64, v64 = k[b, :, hk].double(), v[b, :, hk].double()
    s = _scores_float64(q, k, causal, window, b, hk)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    del s
    delta = (do64 * torch.einsum("gqk,kd->qgd", p, v64)).sum(-1).T
    ds = p * (torch.einsum("qgd,kd->gqk", do64, v64) - delta[..., None]) * scale
    return (lse, delta, torch.einsum("gqk,kd->qgd", ds, k64),
            torch.einsum("gqk,qgd->kd", ds, q64), torch.einsum("gqk,qgd->kd", p, do64))


def flash_delta(o, do):
    """``rowsum(do * o)`` in float32, (B, Hq, Sq)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# CUDA launches (K9, K10, K11)
# ---------------------------------------------------------------------------


def _entry(r):
    """The C entry point of route ``r`` (both take the same arguments)."""
    name, fn_name = _ROUTE_LIB[r]
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i, i, i] + [p] * 11 + [i] * 5 + [ll] * 12
                       + [i, i, ctypes.c_float, p])
        fn.restype = i
        lib._typed = True
    return lib, fn


def _prep(x, r="tf32"):
    """``x`` with head_dim contiguous, its other strides multiples of 4 and
    its start aligned for the kernels' vector loads (copied otherwise). On
    the ``"wgmma"`` route, whose tiles TMA reads, every stride is a positive
    multiple of 16 bytes and the start 16-byte aligned."""
    if r == "wgmma":
        unit = 16 // x.element_size()
        bad = any(s <= 0 or s % unit for s in x.stride()[:3]) or x.data_ptr() % 16
    else:
        align = 16 if x.dtype == torch.float32 else 8
        bad = any(s % 4 for s in x.stride()[:3]) or x.data_ptr() % align
    if x.stride(-1) != 1 or bad:
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def _cuda_inputs(named, dtype, r):
    dev = named[0][1].device
    for name, x in named:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name} on {x.device}, expected {dev} (CUDA)")
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {dtype}")
    if dtype not in _DTYPES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {dtype}")
    return [_prep(x, r) for _, x in named]


def _launch(which, q, k, v, do, lse_in, delta, o, lse, dq, dk, dv, causal,
            window):
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    r = route(which, q.dtype, d)
    ptr = lambda x: None if x is None else x.data_ptr()
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *(do.stride()[:3] if do is not None else (0, 0, 0))]
    lib, fn = _entry(r)
    code = fn(
        _PASS[which], _DTYPES[q.dtype], d, ptr(q), ptr(k), ptr(v), ptr(do),
        ptr(lse_in), ptr(delta), ptr(o), ptr(lse), ptr(dq), ptr(dk), ptr(dv),
        B, Sq, Sk, Hq, Hkv, *strides, int(bool(causal)),
        0 if window is None else int(window), softmax_scale(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, f"{which} ({r})")
    LAUNCHES[which] += 1
    LAUNCHES_BY_ROUTE[f"{which}/{r}"] += 1


def flash_fwd_cuda(q, k, v, causal=True, window=None):
    """K9: (o (B, Sq, Hq, d) in q's dtype, lse (B, Hq, Sq) float32)."""
    _check(q, k, v, window)
    q, k, v = _cuda_inputs((("q", q), ("k", k), ("v", v)), q.dtype,
                           route("flash_fwd", q.dtype, q.shape[3]))
    B, Sq, Hq, d = q.shape
    o = torch.empty((B, Sq, Hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, k, v, None, None, None, o, lse, None, None, None,
            causal, window)
    return o, lse


def _bwd_inputs(which, q, k, v, do, lse, delta, window):
    _check(q, k, v, window)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} for q {tuple(q.shape)}")
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, x in (("lse", lse), ("delta", delta)):
        if (tuple(x.shape) != want or x.dtype != torch.float32
                or x.device != q.device):
            raise ValueError(f"{name} must be float32 {want} on {q.device}")
    q, k, v, do = _cuda_inputs((("q", q), ("k", k), ("v", v), ("do", do)),
                               q.dtype, route(which, q.dtype, q.shape[3]))
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def flash_dq_cuda(q, k, v, do, lse, delta, causal=True, window=None):
    """K10: dq in q's dtype from (q, k, v, do, lse, delta)."""
    q, k, v, do, lse, delta = _bwd_inputs("flash_dq", q, k, v, do, lse, delta,
                                          window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("flash_dq", q, k, v, do, lse, delta, None, None, dq, None, None,
            causal, window)
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, causal=True, window=None):
    """K11: (dk, dv) in k's dtype, summed over each kv head's group."""
    q, k, v, do, lse, delta = _bwd_inputs("flash_dkv", q, k, v, do, lse,
                                          delta, window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("flash_dkv", q, k, v, do, lse, delta, None, None, None, dk, dv,
            causal, window)
    return dk, dv


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_fwd_cuda(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window = ctx.cfg
        delta = flash_delta(o, do)
        dq = flash_dq_cuda(q, k, v, do, lse, delta, causal, window)
        dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, causal, window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    bq: int = 512, bk: int = 512) -> torch.Tensor:
    """q (B, Sq, Hq, d); k, v (B, Sk, Hkv, d) -> (B, Sq, Hq, d).

    ``bq``/``bk`` are the reference's VMEM tile sizes (set from the model's
    ``q_chunk``/``kv_chunk``); the CUDA kernels choose their own tiles, which
    changes only the float32 summation order. CUDA tensors launch K9 (and
    K10/K11 in the backward); CPU tensors run the plain version."""
    del bq, bk
    _check(q, k, v, window)
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal, window)[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 None if window is None else int(window))
