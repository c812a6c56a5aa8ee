"""xLSTM (sLSTM + mLSTM blocks), arXiv:2405.04517 — port of
``repro.models.xlstm`` (the training path).

The sLSTM block has a true h -> h recurrence, so the paper's RH structured
dropout applies to it directly (the recurrent product consumes ``h_{t-1}``
through the RH site ``slstm{g}/rh``); the mLSTM block has a linear
matrix-memory recurrence with no h -> h weight, so only NR applies there.
Every ``slstm_every``-th block is an sLSTM, the rest mLSTM; parameters are
stacked per family (leading axis = the block's index in its family) as in
the reference's tree, so they convert leaf for leaf.

  * mLSTM: the stabilized chunkwise-parallel form, plain torch (the
    reference has no kernel for it).
  * sLSTM: three engines over the time recurrence. ``stepwise`` draws the RH
    mask per step (the oracle); ``scheduled`` samples the whole schedule up
    front and loops over time with ``slstm_step``; ``fused`` runs the whole
    recurrence as one ``kernels/slstm_scan.py`` call (K6 on the card when
    the RH site's spec has ``impl="pallas"``, as the reference).

NR projections (``_proj_sdrop``) are compact gathers and ``torch.matmul``:
the reference calls ``sdrop_matmul`` with its default ``impl="xla"``, so no
Pallas kernel runs there. Dropout sites: ``mlstm/nr`` and ``slstm/nr``
(time axis = layer index), ``slstm{g}/rh`` (time axis = sequence step).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import masks as _masks
from repro_torch.core import layers as L
from repro_torch.core import metrics
from repro_torch.core import sparse_matmul as sm
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.lstm import ENGINES
from repro_torch.kernels.slstm_scan import _pointwise_fwd, slstm_scan
from repro_torch.optim import tree_map


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    name: str = "xlstm"
    num_layers: int = 8
    d_model: int = 128
    n_heads: int = 4
    vocab: int = 256
    proj_factor: float = 2.0      # mLSTM inner = pf * d_model
    slstm_every: int = 8          # every k-th block is sLSTM
    conv_kernel: int = 4
    chunk: int = 64               # mLSTM chunk length
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    loss_chunks: int = 8
    remat: str = "full"           # "full": recompute mLSTM blocks in backward
    plan: DropoutPlan = DropoutPlan()
    engine: str = "scheduled"     # sLSTM time recurrence: see module docstring

    @property
    def inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def dh_m(self) -> int:       # mLSTM per-head dim
        return self.inner // self.n_heads

    @property
    def dh_s(self) -> int:       # sLSTM per-head dim
        return self.d_model // self.n_heads

    @property
    def layer_kinds(self):
        """('m'|'s') per layer."""
        return tuple("s" if (i + 1) % self.slstm_every == 0 else "m"
                     for i in range(self.num_layers))


# ---------------------------------------------------------------------------
# mLSTM: chunkwise-parallel matrix-memory cell
# ---------------------------------------------------------------------------


def mlstm_chunkwise(q, k, v, lf, li, chunk: int, initial=None):
    """Stabilized chunkwise mLSTM.

    q, k, v (B, H, S, d); lf (B, H, S) log-sigmoid forget; li (B, H, S) log
    input gate. Returns (h (B, H, S, d), final (C, n, m)).

      C_t = f_t C_{t-1} + i_t k_t v_t^T ;  n_t = f_t n_{t-1} + i_t k_t
      h_t = (q_t^T C_t) / max(|q_t^T n_t|, exp(-m_t))
    """
    B, H, S, d = q.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    nc = S // c
    scale = d ** -0.5
    split = lambda x: x.reshape(B, H, nc, c, *x.shape[3:]).movedim(2, 0)
    qc, kc, vc, lfc, lic = (split(x) for x in (q, k, v, lf, li))
    if initial is None:         # states in float32 (or wider)
        st = torch.promote_types(q.dtype, torch.float32)
        C = q.new_zeros((B, H, d, d), dtype=st)
        n = q.new_zeros((B, H, d), dtype=st)
        m = q.new_full((B, H), -1e30, dtype=st)
    else:
        C, n, m = initial
    above = ~torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    hs = []
    for qq, kk, vv, lff, lii in zip(qc, kc, vc, lfc, lic):
        # the reference's products take q, k, v into float32 sums
        # (preferred_element_type) beside the float32 carries: widened here
        # once a chunk, exactly
        qq, kk, vv = (x.to(C.dtype) for x in (qq, kk, vv))
        # stabilized carry: the true C is C * exp(m)
        b = torch.cumsum(lff, dim=-1)                    # incl. own lf
        Mt = torch.cummax(lii - b, dim=-1).values        # running max of li - b
        m_t = b + torch.maximum(m[..., None], Mt)         # per-step stabilizer
        w_inter = torch.exp(m[..., None] + b - m_t)
        # intra decay D[t, tau] = exp(b_t - b_tau + li_tau - m_t), tau <= t;
        # masked to -inf before exp, so no inf x 0 reaches the backward
        logD = (b[..., :, None] - b[..., None, :] + lii[..., None, :]
                - m_t[..., :, None])
        D = torch.exp(logD.masked_fill(above, float("-inf")))
        s = (qq @ kk.transpose(-1, -2)) * scale
        inter_h = (qq @ C) * scale
        h_num = (s * D) @ vv + inter_h * w_inter[..., None]
        n_t = D @ kk + n[..., None, :] * w_inter[..., None]
        qn_t = (qq * n_t).sum(-1) * scale
        denom = torch.maximum(qn_t.abs(), torch.exp(-m_t))
        hs.append(h_num / denom[..., None])
        # end-of-chunk state
        b_end = b[..., -1:]
        m_end = b_end[..., 0] + torch.maximum(m, Mt[..., -1])
        w_c = torch.exp(b_end[..., 0] + m - m_end)              # carry decay
        w_k = torch.exp(b_end - b + lii - m_end[..., None])     # (B, H, c)
        C = C * w_c[..., None, None] + (kk * w_k[..., None]).transpose(-1, -2) @ vv
        n = n * w_c[..., None] + (w_k[..., None] * kk).sum(-2)
        m = m_end
    h = torch.stack(hs).movedim(0, 2).reshape(B, H, S, d)
    return h.to(q.dtype), (C, n, m)


def mlstm_decode(q, k, v, lf, li, state):
    """One-token mLSTM step. q, k, v (B, H, d); lf, li (B, H); state (C, n,
    m) float32, updated IN PLACE. Returns (h (B, H, d), (C, n, m))."""
    C, n, m = state
    B, H, d = q.shape
    scale = d ** -0.5
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    # C <- fw C + iw k v^T as one rank-1 batched update, in place
    C.mul_(fw[..., None, None]).view(B * H, d, d).baddbmm_(
        (iw[..., None] * k).reshape(B * H, d, 1).to(C.dtype),
        v.reshape(B * H, 1, d).to(C.dtype))
    n.mul_(fw[..., None]).add_(iw[..., None] * k)
    m.copy_(m_new)
    h_num = (q[..., None, :].to(C.dtype) @ C)[..., 0, :] * scale
    qn = (q * n).sum(-1) * scale
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))
    return (h_num / denom[..., None]).to(q.dtype), (C, n, m)


# ---------------------------------------------------------------------------
# sLSTM: scalar-memory cell with a true h -> h recurrence
# ---------------------------------------------------------------------------


def slstm_step(x_gates, h_prev, state, R, *, rh_state=None):
    """One sLSTM step for all heads.

    x_gates (B, 4D) from the input projection ((i, f, z, o) per head);
    h_prev (B, H, dh); state (c, n, m) each (B, H, dh); R (H, dh, 4dh).
    ``rh_state`` is the RH DropoutState over dh, shared across heads: kept
    unit ids (compacted product) or a (B, 1, dh) dense mask.
    """
    B, H, dh = h_prev.shape
    R = R.to(h_prev.dtype)      # bfloat16 R into the float32 carry's products
    if rh_state is not None and rh_state.structured:
        ids = _masks.keep_blocks_to_unit_ids(
            rh_state.keep_blocks, rh_state.spec.block_size).long()
        h_c = h_prev.index_select(-1, ids) * rh_state.scale
        r_gates = torch.einsum("bhk,hkg->bhg", h_c, R.index_select(1, ids))
    elif rh_state is not None and rh_state.dense_mask is not None:
        dm = rh_state.dense_mask
        dm = dm if dm.dim() == 3 else dm[:, None, :]
        r_gates = torch.einsum("bhd,hdg->bhg", h_prev * dm * rh_state.scale, R)
    else:
        r_gates = torch.einsum("bhd,hdg->bhg", h_prev, R)
    gates = x_gates.reshape(B, H, 4 * dh) + r_gates
    return _pointwise_fwd(gates, state)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B, S, D), w (K, D)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return out + b


def _proj_sdrop(x, w, drop_state):
    """``dropout(x) @ w``: compact (structured), masked (random) or dense."""
    if drop_state is None or drop_state.inactive:
        return (x @ w).to(x.dtype)
    if drop_state.structured:
        return sm.sdrop_matmul(x, w, drop_state.keep_blocks,
                               rate=drop_state.spec.rate,
                               block_size=drop_state.spec.block_size,
                               scale=drop_state.scale)
    return (drop_state.apply(x) @ w).to(x.dtype)


def _randn(gen, shape, scale, cfg, device):
    x = torch.randn(shape, generator=gen, device=gen.device) * scale
    return x.to(device=device, dtype=cfg.param_dtype)


def init_mlstm_block(gen, cfg: XLSTMConfig, L: int, device="cpu"):
    D, I, H = cfg.d_model, cfg.inner, cfg.n_heads
    pd = dict(dtype=cfg.param_dtype, device=device)

    def w(shape, scale=None):
        return _randn(gen, shape, scale if scale is not None else shape[-2] ** -0.5,
                      cfg, device)

    return {
        "ln": {"g": torch.ones((L, D), **pd)},
        "w_up": w((L, D, 2 * I)),
        "conv_w": torch.zeros((L, cfg.conv_kernel, I), **pd),
        "conv_b": torch.zeros((L, I), **pd),
        "wq": w((L, I, I)),
        "wk": w((L, I, I)),
        "wv": w((L, I, I)),
        "w_gates": w((L, I, 2 * H), scale=I ** -0.5),
        "b_gates": torch.cat([torch.zeros((L, H)), torch.linspace(
            3.0, 6.0, H)[None].repeat(L, 1)], -1).to(**pd),
        "gn": {"g": torch.ones((L, I), **pd)},
        "w_down": w((L, I, D)),
    }


def init_slstm_block(gen, cfg: XLSTMConfig, L: int, device="cpu"):
    D, H, dh = cfg.d_model, cfg.n_heads, cfg.dh_s
    Fu = int(4 * D / 3) // 2 * 2   # gated-FFN width (pf 4/3)
    pd = dict(dtype=cfg.param_dtype, device=device)

    def w(shape, scale=None):
        return _randn(gen, shape, scale if scale is not None else shape[-2] ** -0.5,
                      cfg, device)

    return {
        "ln": {"g": torch.ones((L, D), **pd)},
        "w_gates": w((L, D, 4 * D)),
        "b_gates": torch.zeros((L, 4 * D), **pd),
        "R": w((L, H, dh, 4 * dh), scale=dh ** -0.5),
        "gn": {"g": torch.ones((L, D), **pd)},
        "ln2": {"g": torch.ones((L, D), **pd)},
        "w_up1": w((L, D, Fu)),
        "w_up2": w((L, D, Fu)),
        "w_down": w((L, Fu, D)),
    }


def init_params(gen: torch.Generator, cfg: XLSTMConfig, *, device="cpu"):
    """The reference's tree: ``mlstm``/``slstm`` stacked per family, None
    where the family has no block."""
    kinds = cfg.layer_kinds
    n_m, n_s = kinds.count("m"), kinds.count("s")
    return {
        "embed": _randn(gen, (cfg.vocab, cfg.d_model), 0.02, cfg, device),
        "mlstm": init_mlstm_block(gen, cfg, n_m, device) if n_m else None,
        "slstm": init_slstm_block(gen, cfg, n_s, device) if n_s else None,
        "ln_f": {"g": torch.ones((cfg.d_model,), dtype=cfg.param_dtype,
                                 device=device)},
        "lm_head": _randn(gen, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5,
                          cfg, device),
    }


def _rms(g, x, eps=1e-6):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * g).to(x.dtype)


def _group_rms(g, x, H, eps=1e-6, dtype=None):
    """Per-head RMS norm over the head dim. x (..., H*dh); the result in
    ``dtype`` (default x's)."""
    shp = x.shape
    xf = x.reshape(*shp[:-1], H, shp[-1] // H).float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y.reshape(shp) * g).to(dtype or x.dtype)


def _f32(x):
    """x in float32 or wider. In bfloat16 models the elementwise chains run
    in float32 and round once where the reference's tensor is stored or
    enters a product (XLA fuses such chains without rounding between their
    steps)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def mlstm_block_apply(pl, x, cfg: XLSTMConfig, drop_state=None,
                      return_conv=False):
    """x (B, S, D) -> (x + block(x), final (C, n, m)). ``return_conv``
    returns ``(x + block(x), ((C, n, m), conv_tail))`` instead: the last
    conv_kernel - 1 pre-conv ``u`` rows (zero-padded in front for a short
    prompt), the ring buffer ``decode_step`` continues from."""
    B, S, _ = x.shape
    H, I = cfg.n_heads, cfg.inner
    h = _rms(pl["ln"]["g"], x)
    up = _proj_sdrop(h, pl["w_up"], drop_state)          # NR structured drop
    u, z = up.chunk(2, dim=-1)
    uc = F.silu(_causal_conv(_f32(u), pl["conv_w"], pl["conv_b"])).to(u.dtype)
    q = (uc @ pl["wq"]).reshape(B, S, H, -1)
    k = (uc @ pl["wk"]).reshape(B, S, H, -1)
    v = (u @ pl["wv"]).reshape(B, S, H, -1)
    gates = _f32(uc @ pl["w_gates"]) + pl["b_gates"]
    li, gf = gates.chunk(2, dim=-1)                      # (B, S, H) each
    hcell, state = mlstm_chunkwise(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        F.logsigmoid(gf).transpose(1, 2), li.transpose(1, 2), cfg.chunk)
    hcell = hcell.transpose(1, 2).reshape(B, S, I)
    out = (_group_rms(pl["gn"]["g"], hcell, H, dtype=_f32(x).dtype)
           * F.silu(_f32(z))).to(x.dtype)
    y = x + (out @ pl["w_down"]).to(x.dtype)
    if return_conv:
        K = cfg.conv_kernel
        tail = F.pad(u[:, max(0, S - (K - 1)):], (0, 0, max(0, K - 1 - S), 0))
        return y, (state, tail)
    return y, state


def slstm_block_apply(pl, x, cfg: XLSTMConfig, nr_state=None, ctx=None,
                      rh_site: str = "slstm/rh",
                      lengths: Optional[torch.Tensor] = None):
    """sLSTM block from a fresh state: time recurrence with RH dropout per
    step, then a gated FFN. ``lengths`` (B,) int32 freezes the (h, c, n, m)
    carries past each row's length. Returns (x + block(x), final
    (h, (c, n, m)))."""
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.dh_s
    h = _rms(pl["ln"]["g"], x)
    xg = _proj_sdrop(h, pl["w_gates"], nr_state) + pl["b_gates"]  # (B, S, 4D)

    zeros = x.new_zeros((B, H, dh),
                        dtype=torch.promote_types(x.dtype, torch.float32))
    h0, st0 = zeros, (zeros, zeros, torch.full_like(zeros, -1e30))

    rh_active = (ctx is not None and not ctx.deterministic
                 and ctx.spec(rh_site).active)
    rh_sched, rh_rows, rh_const = None, None, None
    if rh_active and cfg.engine != "stepwise":
        # the whole RH schedule up front, shared across heads ((B, 1, dh))
        rh_sched = ctx.schedule(rh_site, S, (B, 1), dh)
        rh_rows = rh_sched.scan_rows()
        if rh_rows is None:
            rh_const = rh_sched.state(0)

    if cfg.engine == "fused":
        # the whole recurrence as one slstm_scan call; its impl follows the
        # RH site's spec ("pallas" = K6 on the card), as the reference
        kw, impl = {}, "xla"
        if rh_sched is not None and not rh_sched.inactive:
            impl = rh_sched.spec.impl
            if rh_sched.structured:
                kw = dict(keep_blocks=rh_sched.keep_blocks,
                          block_size=rh_sched.spec.block_size,
                          scale=rh_sched.scale)
            else:
                kw = dict(dense_mask=rh_sched.dense_mask, scale=rh_sched.scale)
        xgh = xg.transpose(0, 1).reshape(S, B, H, 4 * dh)   # head-major
        hs, (hf, stf) = slstm_scan(xgh, pl["R"], h0, *st0, impl=impl,
                                   lengths=lengths, **kw)
        hs = hs.transpose(0, 1)
    else:
        h_prev, st = h0, tuple(st0)
        outs = []
        for t in range(S):
            rh = None
            if rh_sched is not None:
                rh = (rh_const if rh_rows is None
                      else rh_sched.state_for_row(rh_rows[t]))
            elif rh_active:
                rh = ctx.state(rh_site, (B, 1), dh, t=t)
            h_new, st_new = slstm_step(xg[:, t], h_prev, st, pl["R"],
                                       rh_state=rh)
            if lengths is not None:
                act = (t < lengths)[:, None, None]
                h_new = torch.where(act, h_new, h_prev)
                st_new = tuple(torch.where(act, a, b)
                               for a, b in zip(st_new, st))
            h_prev, st = h_new, st_new
            outs.append(h_new)
        hs, hf, stf = torch.stack(outs, dim=1), h_prev, st
    x = x + _group_rms(pl["gn"]["g"], hs.reshape(B, S, D), H, dtype=x.dtype)
    # gated FFN (pf 4/3); jax.nn.gelu's default is the tanh approximation
    h2 = _rms(pl["ln2"]["g"], x)
    u1 = _proj_sdrop(h2, pl["w_up1"], nr_state)
    u2 = _proj_sdrop(h2, pl["w_up2"], nr_state)
    y = (F.gelu(_f32(u1), approximate="tanh") * u2).to(x.dtype) @ pl["w_down"]
    return x + y.to(x.dtype), (hf, stf)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def forward(params, tokens, cfg: XLSTMConfig, *, ctx=None, lengths=None):
    """tokens (B, S) -> features (B, S, D). ``lengths`` (B,) int32 freezes
    the sLSTM carries at each row's last real token (the mLSTM's chunkwise
    form is causal and needs no freeze)."""
    if cfg.engine not in ENGINES:
        raise ValueError(f"unknown engine {cfg.engine!r}; expected one of {ENGINES}")
    if ctx is None:
        ctx = cfg.plan.bind(None)
    x = L.lookup(params["embed"], tokens).to(cfg.compute_dtype)
    # the layer index li is the NR sites' time axis
    for li, (kind, i) in enumerate(_blocks(cfg)):
        if kind == "m":
            pl = tree_map(lambda a: a[i], params["mlstm"])
            ds = ctx.state("mlstm/nr", x.shape[:2], cfg.d_model, t=li)
            body = lambda x_, pl=pl, ds=ds: mlstm_block_apply(pl, x_, cfg, ds)[0]
            x = (checkpoint(body, x, use_reentrant=False)
                 if cfg.remat != "none" and torch.is_grad_enabled() else body(x))
        else:
            sl = tree_map(lambda a: a[i], params["slstm"])
            nr = ctx.state("slstm/nr", x.shape[:2], cfg.d_model, t=li)
            x, _ = slstm_block_apply(sl, x, cfg, nr_state=nr, ctx=ctx,
                                     rh_site=f"slstm{i}/rh", lengths=lengths)
    return _finish(params, x, cfg)


def _blocks(cfg: XLSTMConfig):
    """The blocks in layer order as ("m", index in the mLSTM family) or
    ("s", index in the sLSTM family): groups of slstm_every - 1 mLSTMs and
    one sLSTM, then the trailing mLSTMs."""
    counts = {"m": 0, "s": 0}
    order = []
    for kind in cfg.layer_kinds:
        order.append((kind, counts[kind]))
        counts[kind] += 1
    return order


def _finish(params, x, cfg):
    return _rms(params["ln_f"]["g"], x)


def lm_logits(params, feats):
    return feats.float() @ params["lm_head"].float()


def dropout_sites(cfg: XLSTMConfig, batch: int, seq: int):
    """Every dropout application a forward makes, as (name, how, t or steps,
    batch, dim): "state_t" for an NR site at its layer index t (the index
    in ``layer_kinds``), "schedule" for an sLSTM block's RH schedule."""
    sites, g = [], 0
    for li, kind in enumerate(cfg.layer_kinds):
        site = "mlstm/nr" if kind == "m" else "slstm/nr"
        sites.append((site, "state_t", li, (batch, seq), cfg.d_model))
        if kind == "s":
            sites.append((f"slstm{g}/rh", "schedule", seq, (batch, 1), cfg.dh_s))
            g += 1
    return sites


def loss_fn(params, batch, cfg: XLSTMConfig, *, seed: Optional[int] = None,
            step: int = 0, injected=None):
    """Mean NLL per token (per real token when the batch has "lengths").

    ``seed=None`` runs without dropout; ``injected`` serves precomputed
    masks per site (core/dropout_plan.py)."""
    ctx = cfg.plan.bind(seed, step, device=params["embed"].device,
                        injected=injected)
    lengths = batch.get("lengths")
    feats = forward(params, batch["tokens"], cfg, ctx=ctx, lengths=lengths)
    if lengths is not None:
        B, S = batch["tokens"].shape
        mask = metrics.length_mask(lengths, S)
        chunk = max(1, -(-(B * S) // cfg.loss_chunks))
        return metrics.masked_lm_loss(params["lm_head"], feats,
                                      batch["labels"], mask, chunk=chunk)
    return metrics.lm_loss(lambda f: lm_logits(params, f), feats,
                           batch["labels"], cfg.loss_chunks)


# ---------------------------------------------------------------------------
# Serving: recurrent state, prefill, decode step
# ---------------------------------------------------------------------------


def init_state(cfg: XLSTMConfig, batch: int, dtype=torch.float32, *,
               device="cpu"):
    """Recurrent serving state, O(1) in position: mLSTM (C, n, m) and the
    conv ring buffer per mLSTM block, sLSTM (h, c, n, m) per sLSTM block.
    Cells in float32 with the stabilizers m at -1e30; the conv ring in
    ``compute_dtype`` (it feeds products)."""
    kinds = cfg.layer_kinds
    n_m, n_s = kinds.count("m"), kinds.count("s")
    H, dm, dh = cfg.n_heads, cfg.dh_m, cfg.dh_s
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    state = {
        "m_C": z(n_m, batch, H, dm, dm),
        "m_n": z(n_m, batch, H, dm),
        "m_m": torch.full((n_m, batch, H), -1e30, dtype=dtype, device=device),
        "m_conv": torch.zeros((n_m, batch, cfg.conv_kernel - 1, cfg.inner),
                              dtype=cfg.compute_dtype, device=device),
    }
    if n_s:
        state.update({"s_h": z(n_s, batch, H, dh), "s_c": z(n_s, batch, H, dh),
                      "s_n": z(n_s, batch, H, dh),
                      "s_m": torch.full((n_s, batch, H, dh), -1e30,
                                        dtype=dtype, device=device)})
    return state


def prefill(params, tokens, cfg: XLSTMConfig, state=None):
    """The eval block stack over tokens (B, S) that also writes every
    block's final recurrent state into ``state`` (in place; a fresh
    ``init_state`` when None): mLSTM (C, n, m) and conv tail, sLSTM (h, c,
    n, m), the stabilizer m included, so ``decode_step`` continues where
    the prompt left off. Dropout is off. Returns (features (B, S, D),
    state)."""
    ctx = cfg.plan.bind(None)
    x = L.lookup(params["embed"], tokens).to(cfg.compute_dtype)
    if state is None:
        state = init_state(cfg, x.shape[0], device=x.device)
    for kind, i in _blocks(cfg):
        if kind == "m":
            pl = tree_map(lambda a: a[i], params["mlstm"])
            x, ((C, n, m), conv) = mlstm_block_apply(pl, x, cfg,
                                                      return_conv=True)
            for key, v in (("m_C", C), ("m_n", n), ("m_m", m), ("m_conv", conv)):
                state[key][i].copy_(v)
        else:
            pl = tree_map(lambda a: a[i], params["slstm"])
            x, (h, (c, n, m)) = slstm_block_apply(pl, x, cfg, ctx=ctx)
            for key, v in (("s_h", h), ("s_c", c), ("s_n", n), ("s_m", m)):
                state[key][i].copy_(v)
    return _finish(params, x, cfg), state


def _mlstm_decode_block(pl, x, cfg, state, i):
    B = x.shape[0]
    H, I = cfg.n_heads, cfg.inner
    u, z = (_rms(pl["ln"]["g"], x) @ pl["w_up"]).chunk(2, dim=-1)
    conv = state["m_conv"][i]
    win = torch.cat([conv, u[:, None, :].to(conv.dtype)], dim=1)   # (B, K, I)
    uc = F.silu(torch.einsum("bki,ki->bi", _f32(win), _f32(pl["conv_w"]))
                + pl["conv_b"]).to(u.dtype)
    q = (uc @ pl["wq"]).reshape(B, H, -1)
    k = (uc @ pl["wk"]).reshape(B, H, -1)
    v = (u @ pl["wv"]).reshape(B, H, -1)
    li, gf = (_f32(uc @ pl["w_gates"]) + pl["b_gates"]).chunk(2, dim=-1)
    hc, _ = mlstm_decode(q, k, v, F.logsigmoid(gf), li,
                         (state["m_C"][i], state["m_n"][i], state["m_m"][i]))
    conv.copy_(win[:, 1:])
    out = (_group_rms(pl["gn"]["g"], hc.reshape(B, I), H, dtype=_f32(x).dtype)
           * F.silu(_f32(z))).to(x.dtype)
    return x + (out @ pl["w_down"]).to(x.dtype)


def _slstm_decode_block(pl, x, cfg, state, g):
    B = x.shape[0]
    xg = _rms(pl["ln"]["g"], x) @ pl["w_gates"] + pl["b_gates"]
    h_new, st_new = slstm_step(xg, state["s_h"][g], (state["s_c"][g],
                               state["s_n"][g], state["s_m"][g]), pl["R"])
    for key, v in zip(("s_h", "s_c", "s_n", "s_m"), (h_new, *st_new)):
        state[key][g].copy_(v)
    x = x + _group_rms(pl["gn"]["g"], h_new.reshape(B, -1), cfg.n_heads,
                       dtype=x.dtype)
    h2 = _rms(pl["ln2"]["g"], x)
    y = (F.gelu(_f32(h2 @ pl["w_up1"]), approximate="tanh")
         * (h2 @ pl["w_up2"])).to(x.dtype) @ pl["w_down"]
    return x + y.to(x.dtype)


def decode_step(params, cfg: XLSTMConfig, state, tokens, pos):
    """One-token decode: tokens (B, 1) -> (logits (B, 1, V) float32,
    state), the state updated in place. ``pos`` is unused: the recurrent
    state is O(1) in position."""
    del pos
    x = L.lookup(params["embed"], tokens[:, 0]).to(cfg.compute_dtype)   # (B, D)
    for kind, i in _blocks(cfg):
        if kind == "m":
            x = _mlstm_decode_block(tree_map(lambda a: a[i], params["mlstm"]),
                                    x, cfg, state, i)
        else:
            x = _slstm_decode_block(tree_map(lambda a: a[i], params["slstm"]),
                                    x, cfg, state, i)
    return lm_logits(params, _finish(params, x, cfg))[:, None, :], state
