"""LSTM stack with the paper's structured dropout (NR and RH), in PyTorch.

Port of ``repro.core.lstm``. Gate matmuls ``x@W + h@U + b`` with W (D, 4H),
U (H, 4H), gate order (i, f, g, o); NR dropout on x_t entering W, RH
dropout on h_{t-1} entering U; c is never dropped. Three engines compute
the same function:

  * ``"scheduled"`` — Phase A samples every site's masks for all T steps
    and runs each layer's NR matmul time-batched (K2 under ``:pallas``);
    Phase B loops over time with the RH matmul (K1 under ``:pallas``) and
    the pointwise update (K5 under ``pointwise_impl="pallas"``).
  * ``"fused"`` — Phase A as above with the bias folded in; Phase B is one
    persistent-scan kernel launch per layer and direction
    (kernels/lstm_scan.py: K3 forward, K4 backward).
  * ``"stepwise"`` — the oracle: one loop over time with the layer loop
    inside, masks drawn per step via ``ctx.state``.

``lengths`` (B,) int32 freezes row b's carries after step ``lengths[b]`` in
every layer (outputs repeat the last valid state; frozen steps contribute
zero gradient), identically in all three engines.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import layers as L
from repro_torch.core.dropout_plan import NULL_CTX, DropoutCtx
from repro_torch.kernels import lstm_pointwise as k5
from repro_torch.kernels.lstm_scan import lstm_scan

ENGINES = ("scheduled", "stepwise", "fused")


class LSTMState(NamedTuple):
    h: torch.Tensor   # (num_layers, B, H)
    c: torch.Tensor   # (num_layers, B, H)


def init_lstm_params(generator, in_dim: int, hidden: int, num_layers: int, *,
                     init_scale: float = 0.05, dtype=torch.float32,
                     device="cpu"):
    """Per-layer {W, U, b}; layer 0 consumes in_dim, the rest hidden."""
    params = []
    for layer in range(num_layers):
        d = in_dim if layer == 0 else hidden
        params.append({
            "W": L.uniform_init(generator, (d, 4 * hidden), init_scale, dtype, device),
            "U": L.uniform_init(generator, (hidden, 4 * hidden), init_scale, dtype, device),
            "b": torch.zeros((4 * hidden,), dtype=dtype, device=device),
        })
    return params


def zero_state(num_layers: int, batch: int, hidden: int, dtype=torch.float32,
               device="cpu") -> LSTMState:
    z = torch.zeros((num_layers, batch, hidden), dtype=dtype, device=device)
    return LSTMState(h=z, c=z)


def lstm_pointwise(gates: torch.Tensor, c_prev: torch.Tensor, *,
                   forget_bias: float = 0.0, impl: str = "xla"):
    """Gate nonlinearities + state update: plain torch (``"xla"``) or K5
    (``"pallas"``, kernels/lstm_pointwise.py, forward only)."""
    if impl == "pallas":
        return k5.lstm_pointwise(gates, c_prev, forget_bias=forget_bias)
    # the reference's xla branch: math in the inputs' dtypes, not K5's plain
    # version (float32 math, cast back), which differs off float32
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + forget_bias) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_cell(params, x, h_prev, c_prev, nr_drop, rh_drop, *,
              forget_bias: float = 0.0, pointwise_impl: str = "xla"):
    """One LSTM step; nr_drop / rh_drop are DropoutStates (or None)."""
    gx = L.dense_sdrop({"w": params["W"]}, x, nr_drop)
    gh = L.dense_sdrop({"w": params["U"]}, h_prev, rh_drop)
    gates = gx + gh + params["b"]
    return lstm_pointwise(gates, c_prev, forget_bias=forget_bias,
                          impl=pointwise_impl)


def _freeze(t, lengths, new, old):
    if lengths is None:
        return new
    return torch.where((t < lengths)[:, None], new, old)


def _lstm_stack_stepwise(params, x_seq, state, *, ctx, site, forget_bias,
                         pointwise_impl, lengths=None):
    num_layers = len(params)
    hidden = state.h.shape[-1]
    T, batch = x_seq.shape[0], x_seq.shape[1]
    hs = list(state.h.unbind(0))
    cs = list(state.c.unbind(0))
    ys = []
    for t in range(T):
        inp = x_seq[t]
        for layer in range(num_layers):
            nr = ctx.state(f"{site}/layer{layer}/nr", batch, inp.shape[-1], t=t)
            rh = ctx.state(f"{site}/layer{layer}/rh", batch, hidden, t=t)
            h, c = lstm_cell(params[layer], inp, hs[layer], cs[layer], nr, rh,
                             forget_bias=forget_bias,
                             pointwise_impl=pointwise_impl)
            hs[layer] = _freeze(t, lengths, h, hs[layer])
            cs[layer] = _freeze(t, lengths, c, cs[layer])
            inp = hs[layer]
        ys.append(inp)
    return torch.stack(ys), LSTMState(h=torch.stack(hs), c=torch.stack(cs))


def _lstm_stack_scheduled(params, x_seq, state, *, ctx, site, forget_bias,
                          pointwise_impl, lengths=None):
    T, batch, _ = x_seq.shape
    hidden = state.h.shape[-1]
    inp = x_seq
    h_fin, c_fin = [], []
    for layer, p in enumerate(params):
        nr_sched = ctx.schedule(f"{site}/layer{layer}/nr", T, batch, inp.shape[-1])
        rh_sched = ctx.schedule(f"{site}/layer{layer}/rh", T, batch, hidden)
        # Phase A: time-batched NR gate matmul.
        gx = L.dense_sdrop_scheduled({"w": p["W"]}, inp, nr_sched)
        rh_rows = rh_sched.scan_rows()
        rh_const = rh_sched.state(0) if rh_rows is None else None
        h, c = state.h[layer], state.c[layer]
        ys = []
        for t in range(T):
            st = rh_const if rh_rows is None else rh_sched.state_for_row(rh_rows[t])
            gh = L.dense_sdrop({"w": p["U"]}, h, st)
            h2, c2 = lstm_pointwise(gx[t] + gh + p["b"], c,
                                    forget_bias=forget_bias,
                                    impl=pointwise_impl)
            h, c = _freeze(t, lengths, h2, h), _freeze(t, lengths, c2, c)
            ys.append(h)
        h_fin.append(h)
        c_fin.append(c)
        inp = torch.stack(ys)
    return inp, LSTMState(h=torch.stack(h_fin), c=torch.stack(c_fin))


def _lstm_stack_fused(params, x_seq, state, *, ctx, site, forget_bias,
                      pointwise_impl, lengths=None):
    T, batch, _ = x_seq.shape
    hidden = state.h.shape[-1]
    inp = x_seq
    h_fin, c_fin = [], []
    for layer, p in enumerate(params):
        nr_sched = ctx.schedule(f"{site}/layer{layer}/nr", T, batch, inp.shape[-1])
        rh_sched = ctx.schedule(f"{site}/layer{layer}/rh", T, batch, hidden)
        # Phase A: time-batched NR gate matmul, bias folded in.
        gx = L.dense_sdrop_scheduled({"w": p["W"], "b": p["b"]}, inp, nr_sched)
        kw, impl = {}, pointwise_impl
        if not rh_sched.inactive:
            impl = rh_sched.spec.impl
            if rh_sched.structured:
                kw = dict(keep_blocks=rh_sched.keep_blocks,
                          block_size=rh_sched.spec.block_size,
                          scale=rh_sched.scale)
            else:
                kw = dict(dense_mask=rh_sched.dense_mask, scale=rh_sched.scale)
        ys, (h_l, c_l) = lstm_scan(gx, p["U"], state.h[layer], state.c[layer],
                                   forget_bias=forget_bias, impl=impl,
                                   lengths=lengths, **kw)
        h_fin.append(h_l)
        c_fin.append(c_l)
        inp = ys
    return inp, LSTMState(h=torch.stack(h_fin), c=torch.stack(c_fin))


def lstm_stack(params, x_seq: torch.Tensor, state: LSTMState, *,
               ctx: Optional[DropoutCtx] = None, site: str = "lstm",
               forget_bias: float = 0.0, pointwise_impl: str = "xla",
               engine: str = "scheduled",
               lengths: Optional[torch.Tensor] = None):
    """Run a multi-layer LSTM over a (T, B, D) sequence.

    Returns (outputs (T, B, H), final LSTMState). Layer ``l`` consumes the
    sites ``{site}/layer{l}/nr`` and ``{site}/layer{l}/rh``.
    ``pointwise_impl`` has the reference's meaning: in the stepwise and
    scheduled engines it picks the cell update ("pallas" = K5, forward only
    as in the reference; "xla" = plain torch); in the fused engine it picks
    the scan when the RH site is inactive (an active RH site's spec picks
    it otherwise).
    """
    ctx = NULL_CTX if ctx is None else ctx
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    run = {"fused": _lstm_stack_fused, "scheduled": _lstm_stack_scheduled,
           "stepwise": _lstm_stack_stepwise}[engine]
    return run(params, x_seq, state, ctx=ctx, site=site, forget_bias=forget_bias,
               pointwise_impl=pointwise_impl, lengths=lengths)
