"""Config-driven transformer — port of ``repro.models.transformer``:
qwen3 / minitron / gemma / qwen1.5 (dense, GQA/MQA, qk-norm, QKV bias,
SwiGLU / GeGLU / ReLU^2 / GELU), mixtral / arctic (mixture-of-experts FFN,
sliding window, dense-residual MoE), pixtral (embeddings in) and whisper
(encoder-decoder, sinusoidal positions, cross-attention).

Parameters are plain dicts of stacked ``(L, ...)`` tensors in the
reference's tree, so they convert leaf for leaf; the layer stack is a
Python loop with ``torch.utils.checkpoint`` per block for ``remat="full"``
(the reference's ``lax.scan`` + ``jax.checkpoint``) and a selective
checkpoint for ``remat="dots"`` (the reference's
``dots_with_no_batch_dims_saveable``: the outputs of the matrix products
without a batch dimension, ``aten.mm`` and ``aten.addmm``, are saved, the
rest is recomputed).

The paper's Case-III structured dropout runs on the non-recurrent
direction: the normalised residual-stream input of each sub-layer (sites
``attn/nr`` and ``mlp/nr``, time axis = layer index; ``enc/attn/nr`` and
``enc/mlp/nr`` in the encoder) is consumed through ``sdrop_matmul`` by the
QKV and FFN-up projections, so their FP/BP/WG run at (1-p) FLOPs;
``mlp/ffn_inner`` is the optional structured drop over the FFN inner
dimension. The masks of layer l are drawn before its checkpointed block,
so the recompute sees the same kept blocks.

Attention: ``attn_impl="xla"`` (the config's default) is the chunked
online-softmax attention in plain PyTorch (windowed span included);
``"flash"`` runs ``kernels/flash_attention.py`` (K9 forward, K10/K11
backward on the card); ``"identity"`` is the reference's roofline probe,
``q * repeat(v)`` with no mixing.

MoE (``moe``, a ``MoEConfig``): ``moe_ffn`` is the reference's sort-based
capacity routing (static shapes, per-shard with ``local_shards``), with the
three expert products picked by the port-only field ``moe_impl``: ``"xla"``
(the default) runs them as ``torch.matmul`` over the ``(S, E, C, .)``
capacity buffer, ``"pallas"`` runs K12 (``kernels/grouped_matmul.py``) on
the flattened buffer, one row block of C rows per (shard, expert).

Encoder-decoder (``is_encoder_decoder``): ``encode`` runs the encoder stack
(non-causal, sinusoidal positions, its own final norm) over (B, T, D)
frames; each decoder block has a cross-attention sub-layer (``lnx``,
``xq``, ``xk``, ``xv``, ``xo``) between its self-attention and its FFN.
As in the reference, the training and prefill forwards only use the
encoder output to switch that sub-layer on: its keys and values are
projected from the decoder's own normalised stream and attended
non-causally through the chunked attention (never flash), so the loss
does not depend on the encoder and its gradients are zero; decode attends
over the cross K/V that ``prefill`` projects from the encoder output.

Serving (``init_cache``, ``prefill``, ``decode_step``): the KV cache is a
dict of stacked ``(L, B, Smax, KVeff, hd)`` tensors (plus the cross K/V
``xk`` / ``xv``, ``(L, B, enc_seq, KVeff, hd)``, of an encoder-decoder)
that ``prefill`` and ``decode_step`` write IN PLACE, at positions held in
device tensors (the reference's ``dynamic_update_slice``, clamped as it
clamps), so a decode step runs inside a captured CUDA graph
(``serving/engine.py``). Prefill attends within the fresh span through
``_attend`` (K9 under ``flash``); decode attends over the whole cache
through ``decode_attention`` (plain PyTorch, float32 scores, as the
reference's). ``embeds_in`` models (pixtral) take (B, S, D) embeddings in
place of token ids in ``forward``, ``loss_fn`` (``batch["embeds"]``),
``prefill`` and ``decode_step``, and have no ``embed`` leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import layers as L
from repro_torch.core import metrics
from repro_torch.core import sparse_matmul as sm
from repro_torch.core.dropout_plan import DropoutPlan, fit_block
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.optim import tree_map


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    dense_ff: int = 0            # arctic: parallel dense-residual FFN width
    router_dtype: Any = torch.float32
    # routing (sort / capacity / scatter) per data shard: 1 = global
    local_shards: int = 1


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "transformer"
    num_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab: int = 256
    mlp: str = "swiglu"          # swiglu | geglu | gelu_mlp | relu2
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    qk_norm: bool = False        # qwen3
    qkv_bias: bool = False       # qwen1.5
    pos: str = "rope"            # rope | sinusoidal | none
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding-window attention
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    scale_embed: bool = False    # gemma: embed * sqrt(d_model)
    max_seq: int = 4096          # positional table length (sinusoidal)
    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500          # audio-frame count (frontend stub)
    # frontend stub: inputs are precomputed embeddings, not token ids (pixtral)
    embeds_in: bool = False
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    attn_impl: str = "xla"       # xla (chunked online softmax) | flash (kernels) | identity
    q_chunk: int = 512
    kv_chunk: int = 512
    loss_chunks: int = 8
    remat: str = "full"          # full | dots | none
    plan: DropoutPlan = DropoutPlan()
    kv_repeat: int = 1           # replicate kv heads (as the reference)
    moe_impl: str = "xla"        # port only: xla (torch.matmul) | pallas (K12)

    def __post_init__(self):
        for field, allowed in (("attn_impl", ("xla", "flash", "identity")),
                               ("remat", ("full", "dots", "none")),
                               ("pos", ("rope", "sinusoidal", "none"))):
            if getattr(self, field) not in allowed:
                raise ValueError(f"{field}={getattr(self, field)!r}: expected "
                                 f"one of {allowed}")
        if self.moe_impl not in ("xla", "pallas"):
            raise ValueError(f"moe_impl={self.moe_impl!r}: expected xla or pallas")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_kv_eff(self) -> int:
        return self.n_kv_heads * self.kv_repeat


# ---------------------------------------------------------------------------
# Positions and norms
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, hd), positions (..., S): rotate the two HALVES of
    head_dim (not interleaved pairs), in float32, cast back."""
    hd = x.shape[-1]
    ang = positions[..., None].float() * rope_freqs(hd, theta, x.device)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def sinusoidal(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Rows ``positions`` (any shape, integer) of the reference's
    ``sinusoidal_table``, float32 (..., dim): sin at the even columns, cos
    at the odd ones, of ``pos * exp(i * -log(10000) / dim)`` for i = 0, 2,
    ... The same float32 operations as the table, one row at a time, so a
    decode step at position ``pos`` builds one row, not ``max_seq``."""
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=positions.device)
                    * (-math.log(10000.0) / dim))
    ang = positions.float()[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).flatten(-2)


def sinusoidal_table(max_len: int, dim: int, device="cpu") -> torch.Tensor:
    """(max_len, dim) float32: the reference's ``sinusoidal_table``."""
    return sinusoidal(torch.arange(max_len, device=device), dim)


def norm_apply(kind, g, b, x, eps=1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * g).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * g + b).to(x.dtype)


def init_norm(cfg: TransformerConfig, dim: int, device="cpu"):
    pd = dict(dtype=cfg.param_dtype, device=device)
    p = {"g": torch.ones((dim,), **pd)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros((dim,), **pd)
    return p


def _norm(cfg, p, x):
    return norm_apply(cfg.norm, p["g"], p.get("b"), x)


# ---------------------------------------------------------------------------
# Chunked attention (online softmax; sliding window; GQA without kv repeat)
# ---------------------------------------------------------------------------


def _attn_chunk(q, k, v, qpos, kpos, *, causal, window, scale):
    """One (q-chunk x kv-chunk) tile. q (B, cq, Hkv, G, hd); k, v
    (B, ck, Hkv, hd). Returns the tile's (running max m, exp-sum l,
    weighted values o), float32."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)                                       # (B, Hkv, G, cq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    return m, l, o


def _pick(S, c):
    """The largest divisor of S that is <= c."""
    c = min(c, S)
    while S % c:
        c -= 1
    return c


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      q_chunk: int, kv_chunk: int) -> torch.Tensor:
    """Flash-style attention in plain PyTorch. q (B, Sq, Hq, hd); k, v
    (B, Sk, Hkv, hd). Sliding-window configs attend over a static
    (window + q_chunk) kv span per q chunk."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = hd ** -0.5
    cq, ck = _pick(Sq, q_chunk), _pick(Sk, kv_chunk)
    qr = q.reshape(B, Sq // cq, cq, Hkv, G, hd)
    use_window = window is not None and window < Sk
    kw = dict(causal=causal, window=window, scale=scale)
    outs = []
    for qi in range(Sq // cq):
        qc = qr[:, qi]
        qpos = qi * cq + torch.arange(cq, device=q.device)
        if use_window:
            span = min(window + cq, Sk)
            start = min(max(qi * cq - window, 0), Sk - span)
            kpos = start + torch.arange(span, device=q.device)
            m, l, o = _attn_chunk(qc, k[:, start:start + span],
                                  v[:, start:start + span], qpos, kpos, **kw)
        else:
            m = torch.full((B, Hkv, G, cq), -1e30, device=q.device)
            l = torch.zeros((B, Hkv, G, cq), device=q.device)
            o = torch.zeros((B, Hkv, G, cq, hd), device=q.device)
            for kj in range(Sk // ck):
                kpos = kj * ck + torch.arange(ck, device=q.device)
                sl = slice(kj * ck, (kj + 1) * ck)
                m_c, l_c, o_c = _attn_chunk(qc, k[:, sl], v[:, sl], qpos, kpos, **kw)
                m_n = torch.maximum(m, m_c)
                r_a, r_c = torch.exp(m - m_n), torch.exp(m_c - m_n)
                l = l * r_a + l_c * r_c
                o = o * r_a[..., None] + o_c * r_c[..., None]
                m = m_n
        out = o / torch.clamp(l[..., None], min=1e-30)        # (B, Hkv, G, cq, hd)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, cq, Hq, hd).to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, pos, *, window: Optional[int]):
    """Single-token attention over a (B, Smax, Hkv, hd) cache. q (B, 1, Hq,
    hd); ``pos`` a 0-dim tensor: keys at positions <= pos (and within the
    window) are seen. Scores and the weighted sum in float32."""
    B, _, Hq, hd = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qr.float(), k_cache.float()) * hd ** -0.5
    idx = torch.arange(Smax, device=q.device)
    mask = idx <= pos
    if window is not None:
        mask &= idx > pos - window
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, -1e30)), dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Parameter init (stacked layers)
# ---------------------------------------------------------------------------


def _dense_init(gen, shape, cfg, device, scale=None):
    """Normal * ``shape[0] ** -0.5`` unless given, as the reference: for a
    stacked (L, ...) leaf that is the layer count's."""
    scale = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn(shape, generator=gen, device=gen.device) * scale
    return w.to(device=device, dtype=cfg.param_dtype)


def init_block_params(gen, cfg: TransformerConfig, num_layers: int,
                      device="cpu", cross_attn: bool = False):
    """Stacked (L, ...) block params: attention, the cross-attention of a
    decoder block (``cross_attn``), then the dense FFN or the MoE router,
    experts and optional dense-residual FFN."""
    D, H, KV, hd, F_ = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    L = num_layers
    pd = dict(dtype=cfg.param_dtype, device=device)
    w = lambda shape, scale=None: _dense_init(gen, shape, cfg, device, scale)
    p = {
        "ln1": {"g": torch.ones((L, D), **pd)},
        "ln2": {"g": torch.ones((L, D), **pd)},
        "wq": w((L, D, H * hd)),
        "wk": w((L, D, KV * hd)),
        "wv": w((L, D, KV * hd)),
        "wo": w((L, H * hd, D)),
    }
    if cfg.norm == "layernorm":
        p["ln1"]["b"] = torch.zeros((L, D), **pd)
        p["ln2"]["b"] = torch.zeros((L, D), **pd)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((L, H * hd), **pd)
        p["bk"] = torch.zeros((L, KV * hd), **pd)
        p["bv"] = torch.zeros((L, KV * hd), **pd)
    if cfg.qk_norm:
        p["qn"] = torch.ones((L, hd), **pd)
        p["kn"] = torch.ones((L, hd), **pd)
    if cross_attn:
        p["lnx"] = {"g": torch.ones((L, D), **pd)}
        if cfg.norm == "layernorm":
            p["lnx"]["b"] = torch.zeros((L, D), **pd)
        p["xq"] = w((L, D, H * hd))
        p["xk"] = w((L, D, KV * hd))
        p["xv"] = w((L, D, KV * hd))
        p["xo"] = w((L, H * hd, D))
    if cfg.moe is not None:
        E = cfg.moe.num_experts
        p["router"] = w((L, D, E))
        p["we_gate"] = w((L, E, D, F_))
        p["we_up"] = w((L, E, D, F_))
        p["we_down"] = w((L, E, F_, D), F_ ** -0.5)
        if cfg.moe.dense_ff:
            Fd = cfg.moe.dense_ff
            p["w_gate"] = w((L, D, Fd))
            p["w_up"] = w((L, D, Fd))
            p["w_down"] = w((L, Fd, D), Fd ** -0.5)
        return p
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = w((L, D, F_))
    p["w_up"] = w((L, D, F_))
    p["w_down"] = w((L, F_, D), F_ ** -0.5)
    return p


def init_params(gen: torch.Generator, cfg: TransformerConfig, *, device="cpu"):
    """The reference's tree: blocks, ln_f, embed (not with ``embeds_in``),
    lm_head (untied), enc_blocks and enc_ln_f (encoder-decoder)."""
    p = {"blocks": init_block_params(gen, cfg, cfg.num_layers, device,
                                     cross_attn=cfg.is_encoder_decoder),
         "ln_f": init_norm(cfg, cfg.d_model, device)}
    if not cfg.embeds_in:
        p["embed"] = _dense_init(gen, (cfg.vocab, cfg.d_model), cfg, device, 0.02)
    if not cfg.tie_embeddings:
        p["lm_head"] = _dense_init(gen, (cfg.d_model, cfg.vocab), cfg, device)
    if cfg.is_encoder_decoder:
        p["enc_blocks"] = init_block_params(gen, cfg, cfg.enc_layers, device)
        p["enc_ln_f"] = init_norm(cfg, cfg.d_model, device)
    return p


# ---------------------------------------------------------------------------
# MoE: sort-based capacity routing (static shapes)
# ---------------------------------------------------------------------------


class _GroupedExperts(torch.autograd.Function):
    """The expert product of one weight over the flattened ``(S, E, C, D)``
    capacity buffer: K12 forward (row block of C rows per (shard, expert)),
    and the backward the reference gets from XLA's autodiff of its einsum,
    ``dx = dy @ w[e].T`` and ``dw[e] = sum_s x[s, e].T @ dy[s, e]``, as two
    library products."""

    @staticmethod
    def forward(ctx, buf, w):
        S, E, C, D = buf.shape
        F_ = w.shape[2]
        blk = torch.arange(E, dtype=torch.int32, device=buf.device).repeat(S)
        y = grouped_matmul(buf.reshape(S * E * C, D), w, blk, bm=C)
        ctx.save_for_backward(buf, w)
        return y.reshape(S, E, C, F_)

    @staticmethod
    def backward(ctx, dy):
        buf, w = ctx.saved_tensors
        S, E, C, D = buf.shape
        F_ = w.shape[2]
        # float32 sums, each rounded once to its primal's dtype, as XLA
        # transposes the reference's float32-accumulating einsum (K12's
        # bfloat16 output gives a bfloat16 cotangent: bfloat16 products)
        dy = dy.to(torch.promote_types(dy.dtype, w.dtype))
        dx = torch.matmul(dy, w.to(dy.dtype).transpose(1, 2))
        dw = torch.bmm(buf.to(dy.dtype).transpose(0, 1).reshape(E, S * C, D)
                       .transpose(1, 2), dy.transpose(0, 1).reshape(E, S * C, F_))
        return dx.to(buf.dtype), dw.to(w.dtype)


def _expert_product(buf, w, cfg):
    """(S, E, C, D) @ (E, D, F) -> (S, E, C, F), float32 sums. The xla route
    returns them unrounded, as the reference's ``einsum(...,
    preferred_element_type=float32)`` (bfloat16 operands widened exactly);
    K12 returns them in buf's dtype, as the reference's grouped_matmul."""
    if cfg.moe_impl == "pallas":
        return _GroupedExperts.apply(buf, w)
    wide = torch.promote_types(buf.dtype, torch.float32)
    return torch.matmul(buf.to(wide), w.to(wide))


def moe_ffn(pl, x2d, cfg: TransformerConfig, out_dtype=None):
    """x2d (T, D) -> (T, D): route each token to its top-k experts, sort by
    expert per shard, drop past capacity C, run the grouped SwiGLU FFN and
    combine the top-k outputs with the renormalised gates (the reference's
    ``moe_ffn``, step for step). Dropped tokens go to a scratch row that is
    sliced off, so they contribute zero. The result is in ``out_dtype``
    (default x2d's); the block takes the float32 combine and rounds once
    after its residual add."""
    mcfg = cfg.moe
    T, D = x2d.shape
    E, K = mcfg.num_experts, mcfg.top_k
    S = mcfg.local_shards if T % max(mcfg.local_shards, 1) == 0 else 1
    S = max(S, 1)
    Tl = T // S
    C = max(1, int(math.ceil(Tl * K / E * mcfg.capacity_factor)))
    dev = x2d.device

    x3 = x2d.reshape(S, Tl, D)
    rd = mcfg.router_dtype
    probs = torch.softmax(torch.matmul(x3.to(rd), pl["router"].to(rd)), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)       # (S, Tl, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    flat_e = expert_idx.reshape(S, Tl * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)         # per-shard sort
    sorted_e = torch.gather(flat_e, 1, order)
    # position of each token within its expert group (per shard)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(Tl * K, device=dev)[None] - first
    valid = pos_in_e < C
    dest = torch.where(valid, sorted_e * C + pos_in_e,
                       torch.full_like(sorted_e, E * C))       # drop -> scratch

    tok_idx = order // K                                       # (S, Tl*K)
    xs = torch.gather(x3, 1, tok_idx[..., None].expand(S, Tl * K, D))
    buf = torch.zeros((S, E * C + 1, D), dtype=x2d.dtype, device=dev).scatter(
        1, dest[..., None].expand(S, Tl * K, D), xs)[:, :-1]
    buf = buf.reshape(S, E, C, D)

    g = _expert_product(buf, pl["we_gate"], cfg)
    u = _expert_product(buf, pl["we_up"], cfg)
    h = (F.silu(g) * u).to(x2d.dtype)
    y_e = _expert_product(h, pl["we_down"], cfg).to(x2d.dtype)

    # gather back, un-sort, combine top-k with gate weights
    y_flat2 = y_e.reshape(S, E * C, D)
    back = torch.clamp(dest, max=E * C - 1)
    y_sorted = torch.gather(y_flat2, 1, back[..., None].expand(S, Tl * K, D)) \
        * valid[..., None]
    inv = torch.argsort(order, dim=-1)
    y_unsorted = torch.gather(y_sorted, 1, inv[..., None].expand(S, Tl * K, D))
    y = (y_unsorted.reshape(S, Tl, K, D).float()
         * gate_vals[..., None].to(x2d.dtype)).sum(dim=2).to(out_dtype or x2d.dtype)
    return y.reshape(T, D)


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


def _residual_mm(x, a, w):
    """``x + a @ w`` in x's dtype, the product's float32 sums and the
    residual added before the one rounding (``torch.addmm``'s epilogue), as
    XLA's fused convert-add gives the reference in bfloat16."""
    y = torch.addmm(x.reshape(-1, x.shape[-1]), a.reshape(-1, a.shape[-1]), w)
    return y.reshape(x.shape)


def _proj_sdrop(x, w, b, drop_state):
    """Projection consuming x through NR structured dropout (paper FP/BP/WG):
    compact (structured), masked dense (random) or dense."""
    if drop_state is None or drop_state.inactive:
        y = (x @ w).to(x.dtype)
    elif drop_state.structured:
        y = sm.sdrop_matmul(x, w, drop_state.keep_blocks,
                            rate=drop_state.spec.rate,
                            block_size=drop_state.spec.block_size,
                            impl=drop_state.spec.impl, scale=drop_state.scale)
    else:
        y = (drop_state.apply(x) @ w).to(x.dtype)
    return y + b if b is not None else y


def _act(cfg, gt, up):
    if cfg.mlp == "swiglu":
        return F.silu(gt) * up
    if cfg.mlp == "geglu":          # jax.nn.gelu's default: the tanh form
        return F.gelu(gt, approximate="tanh") * up
    if cfg.mlp == "relu2":
        return torch.square(F.relu(up))
    return F.gelu(up, approximate="tanh")


def _mlp(pl, h, cfg, drop_state, inner=None, residual=None):
    """Dense FFN with NR sdrop on its input; ``inner`` (a structured
    DropoutState over d_ff) drops FFN-inner blocks: compact up/gate
    columns and compact down rows. With ``residual`` the result is
    ``residual + ffn(h)`` (``_residual_mm`` for the dense down product)."""
    gated = cfg.mlp in ("swiglu", "geglu")
    if inner is not None:
        kw = dict(rate=inner.spec.rate, block_size=inner.spec.block_size)
        up = sm.sdrop_matmul_out(h, pl["w_up"], inner.keep_blocks, **kw)
        gt = sm.sdrop_matmul_out(h, pl["w_gate"], inner.keep_blocks, **kw) if gated else None
        y = sm.sdrop_matmul(_act(cfg, gt, up), pl["w_down"], inner.keep_blocks,
                            x_is_compact=True, scale=inner.scale, **kw)
        return y if residual is None else residual + y
    up = _proj_sdrop(h, pl["w_up"], None, drop_state)
    gt = _proj_sdrop(h, pl["w_gate"], None, drop_state) if gated else None
    if residual is not None:
        return _residual_mm(residual, _act(cfg, gt, up), pl["w_down"])
    return (_act(cfg, gt, up) @ pl["w_down"]).to(h.dtype)


def _qkv(pl, h, cfg, drop_state, positions, prefix="w"):
    """q (B, S, H, hd), k, v (B, S, KVeff, hd) of h; ``prefix="x"`` takes the
    cross-attention weights (``xq``, ``xk``, ``xv``: no bias, no dropout,
    no positions), as the reference's ``_qkv(..., prefix="x")``."""
    B, S, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bias = (lambda n: pl.get(n)) if prefix == "w" else (lambda n: None)
    q = _proj_sdrop(h, pl[prefix + "q"], bias("bq"), drop_state).reshape(B, S, H, hd)
    k = _proj_sdrop(h, pl[prefix + "k"], bias("bk"), drop_state).reshape(B, S, KV, hd)
    v = _proj_sdrop(h, pl[prefix + "v"], bias("bv"), drop_state).reshape(B, S, KV, hd)
    if cfg.qk_norm:             # RMSNorm over head_dim, before rope
        q = norm_apply("rmsnorm", pl["qn"], None, q)
        k = norm_apply("rmsnorm", pl["kn"], None, k)
    if cfg.pos == "rope" and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.kv_repeat > 1:       # jnp.repeat on the head axis: each kv head
        k = k.repeat_interleave(cfg.kv_repeat, dim=2)     # kv_repeat times
        v = v.repeat_interleave(cfg.kv_repeat, dim=2)     # in a row
    return q, k, v


def _attend(q, k, v, cfg, causal):
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal, cfg.window, cfg.q_chunk,
                               cfg.kv_chunk)
    if cfg.attn_impl == "identity":
        # the reference's roofline probe: no mixing across positions
        return q * v.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    return chunked_attention(q, k, v, causal=causal, window=cfg.window,
                             q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)


def _write_kv(entry, k, v, pos):
    """K, V (B, S, KVeff, hd) into one layer's cache entry {"k", "v"} (B,
    Smax, KVeff, hd), in place, at positions pos .. pos + S - 1; ``pos`` is
    a 0-dim device tensor, clamped to Smax - S as the reference's
    ``dynamic_update_slice`` clamps its start."""
    S, Smax = k.shape[1], entry["k"].shape[1]
    if S > Smax:
        raise ValueError(f"{S} positions do not fit a cache of {Smax}")
    idx = pos.clamp(0, Smax - S) + torch.arange(S, device=k.device)
    entry["k"].index_copy_(1, idx, k.to(entry["k"].dtype))
    entry["v"].index_copy_(1, idx, v.to(entry["v"].dtype))


def _cross_attention(pl, x, cfg, memory, cache):
    """x plus the cross-attention sub-layer of a decoder block. With
    ``memory`` (training, prefill) its q, k and v are projected from the
    normalised x itself and attended non-causally by the chunked attention,
    as the reference's ``block_apply`` (the encoder output only switches the
    sub-layer on); with a decode ``cache`` holding the cross K/V (``xk``,
    ``xv``, (B, T, KVeff, hd)) the token's q attends over all T of them."""
    B, S, _ = x.shape
    hx = _norm(cfg, pl["lnx"], x)
    if memory is not None:
        qx, kx, vx = _qkv(pl, hx, cfg, None, None, prefix="x")
        ax = chunked_attention(qx, kx, vx, causal=False, window=None,
                               q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    else:
        qx = (hx @ pl["xq"]).to(hx.dtype).reshape(B, S, cfg.n_heads, cfg.hd)
        ax = decode_attention(qx, cache["xk"], cache["xv"],
                              cache["xk"].shape[1] - 1, window=None)
    return _residual_mm(x, ax.reshape(B, S, cfg.n_heads * cfg.hd), pl["xo"])


def block_apply(pl, x, cfg: TransformerConfig, *, causal: bool,
                drop_states=(None, None, None), positions=None, cache=None,
                cache_pos=None, memory=None):
    """One transformer block; ``drop_states`` = (attention-in, mlp-in,
    FFN-inner) DropoutStates or None. With ``moe`` the FFN is ``moe_ffn``
    (plus the dense-residual FFN, which consumes the mlp-in state, when
    ``dense_ff`` is set).

    With ``cache`` (one layer's {"k", "v"}, (B, Smax, KVeff, hd)) the
    block's K and V are written into it in place at ``cache_pos`` (a 0-dim
    device tensor); a single token (S == 1) then attends over the cache,
    a prefill span attends within itself through ``_attend``. A decoder
    block of an encoder-decoder (``xq`` in ``pl``) runs its cross-attention
    when given ``memory`` or a cache with ``xk`` (``_cross_attention``)."""
    B, S, D = x.shape
    d_attn, d_mlp, inner = drop_states
    h = _norm(cfg, pl["ln1"], x)
    q, k, v = _qkv(pl, h, cfg, d_attn, positions)
    if cache is not None:
        _write_kv(cache, k, v, cache_pos)
    if cache is not None and S == 1:
        attn = decode_attention(q, cache["k"], cache["v"], cache_pos,
                                window=cfg.window)
    else:
        attn = _attend(q, k, v, cfg, causal)
    attn = attn.reshape(B, S, cfg.n_heads * cfg.hd)
    x = _residual_mm(x, attn, pl["wo"])
    if "xq" in pl and (memory is not None or (cache is not None and "xk" in cache)):
        x = _cross_attention(pl, x, cfg, memory, cache)
    h2 = _norm(cfg, pl["ln2"], x)
    if cfg.moe is None:
        return _mlp(pl, h2, cfg, d_mlp, inner, residual=x)
    y = moe_ffn(pl, h2.reshape(B * S, D), cfg, out_dtype=torch.float32)
    y = y.reshape(B, S, D)
    if cfg.moe.dense_ff:
        y = y + _mlp(pl, h2, cfg, d_mlp)
    return (x + y).to(x.dtype)


# ---------------------------------------------------------------------------
# Dropout states (per layer, per sub-layer, per step)
# ---------------------------------------------------------------------------


def _layer_drop_states(ctx, cfg: TransformerConfig, layer_idx: int, bs_shape,
                       prefix: str = ""):
    """(attention-in, mlp-in, FFN-inner) states of one layer: NR states
    over d_model (kept-block ids, or a per-token mask for the random
    baseline) and the FFN-inner kept blocks over d_ff when that site is
    structured. The layer index is the time axis: PER_STEP specs re-sample
    per layer, FIXED ones share one mask across the depth. A MoE layer draws
    the mlp-in state even when nothing consumes it (no ``dense_ff``), as the
    reference, and never an FFN-inner one. ``prefix`` ("enc/") separates the
    encoder stack's streams from the decoder's."""
    if ctx is None or ctx.deterministic:
        return (None, None, None)
    inner = fit_block(ctx.spec(prefix + "mlp/ffn_inner"), cfg.d_ff)
    if not (ctx.spec(prefix + "attn/nr").active
            or ctx.spec(prefix + "mlp/nr").active or inner.structured):
        return (None, None, None)
    st_a = ctx.state(prefix + "attn/nr", bs_shape, cfg.d_model, t=layer_idx)
    st_m = ctx.state(prefix + "mlp/nr", bs_shape, cfg.d_model, t=layer_idx)
    st_i = (ctx.state(prefix + "mlp/ffn_inner", bs_shape, cfg.d_ff, t=layer_idx)
            if inner.structured and cfg.moe is None else None)
    return (st_a, st_m, st_i)


def dropout_sites(cfg: TransformerConfig, batch: int, seq: int):
    """Every dropout application a forward makes, as (name, "state_t",
    layer index, batch, dim): the encoder's (``enc/`` sites over (batch,
    enc_seq)) first, then the decoder's."""
    inner = (fit_block(cfg.plan.spec("mlp/ffn_inner"), cfg.d_ff).structured
             and cfg.moe is None)
    stacks = [("", cfg.num_layers, seq)]
    if cfg.is_encoder_decoder:
        stacks.insert(0, ("enc/", cfg.enc_layers, cfg.enc_seq))
    sites = []
    for pre, layers, s in stacks:
        for li in range(layers):
            sites.append((pre + "attn/nr", "state_t", li, (batch, s), cfg.d_model))
            sites.append((pre + "mlp/nr", "state_t", li, (batch, s), cfg.d_model))
            if inner:
                sites.append((pre + "mlp/ffn_inner", "state_t", li, (batch, s),
                              cfg.d_ff))
    return sites


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

# remat="dots": the outputs of the matrix products without a batch dimension
# are saved (the reference's dots_with_no_batch_dims_saveable; attention's
# and the experts' batched products are bmm, recomputed)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(body, x, cfg):
    """``body(x)`` under the config's rematerialisation: recomputed whole in
    the backward ("full"), recomputed but for its saved matrix products
    ("dots"), or kept ("none", or with no autograd)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return body(x)
    if cfg.remat == "dots":
        return checkpoint(body, x, use_reentrant=False, context_fn=_dots_context)
    return checkpoint(body, x, use_reentrant=False)


def _embed_tokens(params, tokens, cfg):
    x = L.lookup(params["embed"], tokens).to(cfg.compute_dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype)
    return x


def _inputs(params, inputs, cfg):
    """The residual stream's input: (B, S, D) embeddings as they are
    (``embeds_in``), or the embedded token ids (B, S)."""
    if cfg.embeds_in:
        return inputs.to(cfg.compute_dtype)
    return _embed_tokens(params, inputs, cfg)


def _run_stack(blocks, x, cfg, *, causal, positions, ctx=None, prefix="",
               num_layers=None, memory=None):
    """The layer loop, each block under ``_remat``. Layer l's masks are
    drawn outside its checkpoint."""
    for li in range(num_layers or cfg.num_layers):
        pl = tree_map(lambda a: a[li], blocks)
        ds = _layer_drop_states(ctx, cfg, li, tuple(x.shape[:2]), prefix)
        body = lambda x_, pl=pl, ds=ds: block_apply(
            pl, x_, cfg, causal=causal, drop_states=ds, positions=positions,
            memory=memory)
        x = _remat(body, x, cfg)
    return x


def encode(params, frames, cfg: TransformerConfig, *, ctx=None):
    """The encoder: frames (B, T, D) from the frontend stub, plus sinusoidal
    positions, through the encoder stack (non-causal, sites ``enc/``) and
    its final norm -> (B, T, D)."""
    pos = sinusoidal_table(frames.shape[1], cfg.d_model, frames.device)
    x = frames.to(cfg.compute_dtype) + pos.to(cfg.compute_dtype)[None]
    x = _run_stack(params["enc_blocks"], x, cfg, causal=False, positions=None,
                   ctx=ctx, prefix="enc/", num_layers=cfg.enc_layers)
    return _norm(cfg, params["enc_ln_f"], x)


def _positions(x, cfg):
    """x plus the sinusoidal table's first S rows (``pos="sinusoidal"``,
    no rope positions), or x and the rope positions 0 .. S-1."""
    B, S = x.shape[:2]
    if cfg.pos == "sinusoidal":
        tab = sinusoidal_table(S, cfg.d_model, x.device)
        return x + tab.to(x.dtype)[None], None
    return x, torch.arange(S, device=x.device)[None].expand(B, S)


def forward(params, inputs, cfg: TransformerConfig, *, ctx=None, memory=None):
    """tokens (B, S) or embeddings (B, S, D) (``embeds_in``) -> final-norm
    features (B, S, D); ``memory`` (the encoder output) switches on the
    decoder blocks' cross-attention."""
    x, positions = _positions(_inputs(params, inputs, cfg), cfg)
    x = _run_stack(params["blocks"], x, cfg, causal=True, positions=positions,
                   ctx=ctx, memory=memory)
    return _norm(cfg, params["ln_f"], x)


def lm_logits(params, feats, cfg):
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return feats.float() @ w.float()


def unused_in_loss(cfg: TransformerConfig) -> tuple:
    """The parameter subtrees ``loss_fn`` may not read, as paths: an
    encoder-decoder's encoder, as in the reference, whose decoder
    cross-attention projects its keys and values from the decoder's own
    stream in training (the encoder output only switches it on); and under
    ``attn_impl="identity"`` (q times v) the key projections."""
    out = ("enc_blocks", "enc_ln_f") if cfg.is_encoder_decoder else ()
    if cfg.attn_impl == "identity":
        out += ("blocks/wk", "blocks/bk", "blocks/xk", "enc_blocks/wk",
                "enc_blocks/bk")
    return out


def loss_fn(params, batch, cfg: TransformerConfig, *, seed: Optional[int] = None,
            step: int = 0, injected=None):
    """Mean next-token NLL over batch {"tokens" | "embeds", "labels",
    ["frames"]}. ``seed=None`` runs without dropout; ``injected`` serves
    precomputed masks per site (core/dropout_plan.py)."""
    ctx = cfg.plan.bind(seed, step, device=params["ln_f"]["g"].device,
                        injected=injected)
    memory = (encode(params, batch["frames"], cfg, ctx=ctx)
              if cfg.is_encoder_decoder else None)
    inputs = batch["embeds"] if cfg.embeds_in else batch["tokens"]
    feats = forward(params, inputs, cfg, ctx=ctx, memory=memory)
    return metrics.lm_loss(lambda f: lm_logits(params, f, cfg), feats,
                           batch["labels"], cfg.loss_chunks)


# ---------------------------------------------------------------------------
# Serving: KV cache, prefill, decode step
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=None,
               *, device="cpu"):
    """KV cache: {"k", "v"} stacked (L, B, Smax, KVeff, hd), and for an
    encoder-decoder the cross K/V {"xk", "xv"} (L, B, enc_seq, KVeff, hd),
    zeros in ``compute_dtype``."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.num_layers, batch, max_seq, cfg.n_kv_eff, cfg.hd)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.is_encoder_decoder:
        xshape = (cfg.num_layers, batch, cfg.enc_seq, cfg.n_kv_eff, cfg.hd)
        c["xk"] = torch.zeros(xshape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(xshape, dtype=dtype, device=device)
    return c


def _serve_stack(params, x, cfg, cache, pos, positions, memory=None):
    for li in range(cfg.num_layers):
        pl = tree_map(lambda a: a[li], params["blocks"])
        entry = {k: v[li] for k, v in cache.items()}
        x = block_apply(pl, x, cfg, causal=True, positions=positions,
                        cache=entry, cache_pos=pos, memory=memory)
    return _norm(cfg, params["ln_f"], x)


def _write_cross_kv(params, cfg, cache, memory):
    """The cross K/V of every decoder layer, projected from the encoder
    output ``memory`` (B, T, D), into ``cache["xk"]`` / ``cache["xv"]`` in
    place (the decode graphs hold their addresses)."""
    B, T, _ = memory.shape
    if T != cache["xk"].shape[2]:
        raise ValueError(f"{T} encoder frames do not fit a cross cache of "
                         f"{cache['xk'].shape[2]} (enc_seq)")
    blocks = params["blocks"]
    for li in range(cfg.num_layers):
        for name in ("xk", "xv"):
            kv = (memory @ blocks[name][li]).reshape(B, T, cfg.n_kv_heads, cfg.hd)
            if cfg.kv_repeat > 1:
                kv = kv.repeat_interleave(cfg.kv_repeat, dim=2)
            cache[name][li].copy_(kv)


def prefill(params, inputs, cfg: TransformerConfig, cache, *, memory=None):
    """Forward pass over tokens (B, S) (or embeddings (B, S, D) with
    ``embeds_in``) that also writes their K/V into ``cache`` at positions
    0 .. S-1 (in place; attention within the span through ``_attend``, so
    K9 under ``flash``). With ``memory`` (an encoder-decoder's encoder
    output) the cross K/V are written too. Returns (final-norm features
    (B, S, D), cache)."""
    x, positions = _positions(_inputs(params, inputs, cfg), cfg)
    if memory is not None:
        _write_cross_kv(params, cfg, cache, memory)
    pos = torch.zeros((), dtype=torch.long, device=x.device)
    return _serve_stack(params, x, cfg, cache, pos, positions, memory), cache


def decode_step(params, cfg: TransformerConfig, cache, tokens, pos):
    """One decode step: tokens (B, 1) (or embeddings (B, 1, D) with
    ``embeds_in``) at position ``pos`` (an int or a 0-dim integer tensor,
    one position for every row). Writes K/V into ``cache`` in place and
    returns (logits (B, 1, V) float32, cache). With a tensor ``pos``
    nothing reads back to the host, so the step can be captured in a CUDA
    graph; a sinusoidal model adds the one row ``pos`` of the table (the
    reference's row of a ``max_seq`` table, clamped as its slice)."""
    x = _inputs(params, tokens, cfg)
    pos = torch.as_tensor(pos, device=x.device).reshape(()).long()
    if cfg.pos == "sinusoidal":
        row = sinusoidal(pos.clamp(0, cfg.max_seq - 1), cfg.d_model)
        x, positions = x + row.to(x.dtype), None
    else:
        positions = pos.expand(x.shape[0], 1)
    feats = _serve_stack(params, x, cfg, cache, pos, positions)
    return lm_logits(params, feats, cfg), cache
