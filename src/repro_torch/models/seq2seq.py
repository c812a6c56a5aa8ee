"""Luong'15 attention NMT (paper Table 2): 2-layer
unidirectional LSTM encoder-decoder with general attention and input
feeding. Port of ``repro.models.seq2seq``.

Dropout comes from a ``DropoutPlan`` over named sites: "nr" / "rh" resolve
for both stacks (full names "enc/layer0/nr", "dec/feed/nr", ...), "out"
covers the encoder and decoder output dropout. ``cfg.engine`` picks the
recurrent path of BOTH stacks. The decoder's layer-0 fan-in is split,

    [embed_t ; h~_{t-1}] @ W  ==  embed_t @ W  +  h~_{t-1} @ W_feed,

so teacher-forced decoding is two passes: pass 1 is the recurrence, with
the embed half hoisted out of it (Phase A, "dec/layer0/nr", bias folded
in) and the feed half, the RH products, the upper NR products and the
Luong attention in-scan (``engine="fused"``: one ``kernels.decoder_scan``
call, K7/K8 under ``:pallas``; ``"scheduled"``: the same restructure as a
Python loop over pre-sampled masks; ``"stepwise"``: the per-step-mask
oracle); pass 2 is output dropout and the vocab projection over all steps.
Parameters mirror the reference's tree leaf for leaf (``decoder`` W has
embed-only fan-in, ``w_feed`` (H, 4H) is separate).

Free-running inference takes the single-step path: ``init_state`` /
``prefill`` (the encoder in eval, its memory parked in the state, the
target prefix replayed) / ``decode_step``, which serve through
``serving.DecodeEngine`` token by token and update the state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import layers as L
from repro_torch.core import lstm as lstm_mod
from repro_torch.core import metrics
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.sdrop import DropoutSpec
from repro_torch.kernels.decoder_scan import decoder_scan


@dataclasses.dataclass(frozen=True)
class NMTConfig:
    name: str = "luong_nmt"
    src_vocab: int = 50000
    tgt_vocab: int = 50000
    embed: int = 512
    hidden: int = 512
    num_layers: int = 2
    plan: DropoutPlan = DropoutPlan({"nr": DropoutSpec(rate=0.3)})
    engine: str = "scheduled"      # "scheduled" | "fused" | "stepwise"
    param_dtype: Any = torch.float32


def init_params(generator: torch.Generator, cfg: NMTConfig, *, device="cpu"):
    H, dt = cfg.hidden, cfg.param_dtype
    u = lambda shape, s: L.uniform_init(generator, shape, s, dt, device)
    lstm = lambda: lstm_mod.init_lstm_params(generator, cfg.embed, H,
                                             cfg.num_layers, dtype=dt,
                                             device=device)
    return {
        "src_embed": u((cfg.src_vocab, cfg.embed), 0.1),
        "tgt_embed": u((cfg.tgt_vocab, cfg.embed), 0.1),
        "encoder": lstm(),
        # decoder layer 0 consumes the embed only; w_feed is the input-feed
        # half of the joint [embed ; h~] matmul
        "decoder": lstm(),
        "w_feed": u((H, 4 * H), 0.05),
        "w_att": L.init_dense(generator, H, H, bias=False, dtype=dt, device=device),
        "w_comb": L.init_dense(generator, 2 * H, H, bias=False, dtype=dt,
                               device=device),
        "fc": L.init_dense(generator, H, cfg.tgt_vocab, dtype=dt, device=device),
    }


def encode(params, src, cfg: NMTConfig, *, ctx=None, lengths=None):
    """src (B, S) -> (enc_out (B, S, H), final LSTMState); ``lengths``
    freezes each row's encoder state at its last real token."""
    if ctx is None:
        ctx = cfg.plan.bind(None)
    B = src.shape[0]
    x = L.lookup(params["src_embed"], src)
    state = lstm_mod.zero_state(cfg.num_layers, B, cfg.hidden, dtype=x.dtype,
                                device=x.device)
    ys, state = lstm_mod.lstm_stack(params["encoder"], x.transpose(0, 1), state,
                                    ctx=ctx, site="enc", engine=cfg.engine,
                                    lengths=lengths)
    enc = ctx.apply("enc/out", ys.transpose(0, 1))           # (B, S, H)
    return enc, state


def _scan_site_names(nl):
    """The decoder's in-scan dropout sites in ``decoder_scan``'s canonical
    order [feed, rh_0..rh_{nl-1}, nr_1..nr_{nl-1}] ("dec/layer0/nr" is the
    hoisted Phase-A site, not in-scan)."""
    return (["dec/feed/nr"] + [f"dec/layer{l}/rh" for l in range(nl)]
            + [f"dec/layer{l}/nr" for l in range(1, nl)])


def dropout_sites(cfg: NMTConfig, batch: int, src_len: int, tgt_len: int):
    """Every dropout site a loss consumes, in ``lstm_lm.dropout_sites``'
    format: the encoder's per-layer NR/RH schedules and its "enc/out"
    application; the decoder's hoisted "dec/layer0/nr" (embed dim), its
    in-scan sites and "dec/out"."""
    H, E = cfg.hidden, cfg.embed
    sites = []
    for layer in range(cfg.num_layers):
        sites.append((f"enc/layer{layer}/nr", "schedule", src_len, batch,
                      E if layer == 0 else H))
        sites.append((f"enc/layer{layer}/rh", "schedule", src_len, batch, H))
    sites.append(("enc/out", "state", None, (batch, src_len), H))
    sites.append(("dec/layer0/nr", "schedule", tgt_len, batch, E))
    sites += [(name, "schedule", tgt_len, batch, H)
              for name in _scan_site_names(cfg.num_layers)]
    sites.append(("dec/out", "state", None, (batch, tgt_len), H))
    return sites


def _attend(params, cur, enc_proj, enc_out, score_bias):
    """Luong general attention + h~ readout for one step's top state."""
    scores = torch.einsum("bh,bsh->bs", cur, enc_proj) + score_bias
    alpha = torch.softmax(scores, dim=-1)
    ctx_vec = torch.einsum("bs,bsh->bh", alpha, enc_out)
    return torch.tanh(L.dense(params["w_comb"], torch.cat([ctx_vec, cur], -1)))


def _dec_step(params, nl, carry, gx0_t, sts, enc_proj, enc_out, score_bias):
    """One decoder step from the Phase-A gates ``gx0_t`` (bias folded) and
    the in-scan sites' DropoutStates ``sts`` (canonical order)."""
    dec = params["decoder"]
    hs, cs, feed = carry
    g = (gx0_t + L.dense_sdrop({"w": params["w_feed"]}, feed, sts[0])
         + L.dense_sdrop({"w": dec[0]["U"]}, hs[0], sts[1]))
    h, c = lstm_mod.lstm_pointwise(g, cs[0])
    new_h, new_c, cur = [h], [c], h
    for l in range(1, nl):
        g = (L.dense_sdrop({"w": dec[l]["W"], "b": dec[l]["b"]}, cur, sts[nl + l])
             + L.dense_sdrop({"w": dec[l]["U"]}, hs[l], sts[1 + l]))
        h, c = lstm_mod.lstm_pointwise(g, cs[l])
        new_h.append(h)
        new_c.append(c)
        cur = h
    h_tilde = _attend(params, cur, enc_proj, enc_out, score_bias)
    return (torch.stack(new_h), torch.stack(new_c), h_tilde)


def _site_args(sched):
    """MaskSchedule -> decoder_scan's (keep_blocks, dense_mask, bs, scale)."""
    if sched.inactive:
        return (None, None, 1, 1.0)
    if sched.structured:
        return (sched.keep_blocks, None, sched.spec.block_size, sched.scale)
    return (None, sched.dense_mask, 1, sched.scale)


def decode_train(params, tgt_in, enc_out, enc_state, cfg: NMTConfig, *,
                 ctx=None, src_mask=None, tgt_lengths=None):
    """Teacher-forced decoding: tgt_in (B, St), enc_out (B, Ss, H) ->
    logits (B, St, V) float32. ``tgt_lengths`` freezes every decoder carry
    (h_l, c_l, feed) past each row's length, identically in all engines."""
    if ctx is None:
        ctx = cfg.plan.bind(None)
    B, St = tgt_in.shape
    H, nl = cfg.hidden, cfg.num_layers
    dec = params["decoder"]
    x_seq = L.lookup(params["tgt_embed"], tgt_in).transpose(0, 1)
    enc_proj = L.dense(params["w_att"], enc_out)           # plain GEMM
    if src_mask is None:
        src_mask = torch.ones(enc_out.shape[:2], dtype=torch.bool,
                              device=enc_out.device)
    score_bias = torch.where(src_mask.bool(), 0.0, -1e30).to(torch.float32)
    h0, c0 = enc_state.h, enc_state.c
    feed0 = torch.zeros((B, H), dtype=x_seq.dtype, device=x_seq.device)
    site_names = _scan_site_names(nl)

    def freeze(new, old, t):
        if tgt_lengths is None:
            return new
        act = t < tgt_lengths
        return (torch.where(act[None, :, None], new[0], old[0]),
                torch.where(act[None, :, None], new[1], old[1]),
                torch.where(act[:, None], new[2], old[2]))

    if cfg.engine == "stepwise":
        carry, outs = (h0, c0, feed0), []
        for t in range(St):
            gx0_t = L.dense_sdrop({"w": dec[0]["W"], "b": dec[0]["b"]}, x_seq[t],
                                  ctx.state("dec/layer0/nr", B, cfg.embed, t=t))
            sts = [ctx.state(n, B, H, t=t) for n in site_names]
            carry = freeze(_dec_step(params, nl, carry, gx0_t, sts, enc_proj,
                                     enc_out, score_bias), carry, t)
            outs.append(carry[2])
        h_tildes = torch.stack(outs)
    else:
        # Phase A: the hoisted embed-half NR matmul, time-batched at (1-p)
        # FLOPs (K2 under :pallas), bias folded.
        gx0 = L.dense_sdrop_scheduled(
            {"w": dec[0]["W"], "b": dec[0]["b"]}, x_seq,
            ctx.schedule("dec/layer0/nr", St, B, cfg.embed))
        scheds = [ctx.schedule(n, St, B, H) for n in site_names]
        if cfg.engine == "fused":
            nr0 = ctx.spec("dec/layer0/nr")
            impl = next((s.spec.impl for s in scheds if not s.inactive),
                        nr0.impl if nr0.active else "xla")
            h_tildes, _ = decoder_scan(
                gx0, tuple(p["U"] for p in dec), tuple(p["W"] for p in dec[1:]),
                tuple(p["b"] for p in dec[1:]), params["w_feed"],
                params["w_comb"]["w"], enc_proj, enc_out, score_bias, h0, c0,
                feed0, sites=tuple(_site_args(s) for s in scheds), impl=impl,
                lengths=tgt_lengths)
        else:
            rows = [s.scan_rows() for s in scheds]
            consts = [s.state(0) if r is None else None
                      for s, r in zip(scheds, rows)]
            carry, outs = (h0, c0, feed0), []
            for t in range(St):
                sts = [consts[i] if rows[i] is None
                       else scheds[i].state_for_row(rows[i][t])
                       for i in range(len(scheds))]
                carry = freeze(_dec_step(params, nl, carry, gx0[t], sts,
                                         enc_proj, enc_out, score_bias), carry, t)
                outs.append(carry[2])
            h_tildes = torch.stack(outs)
    # pass 2: time-batched output dropout + vocab projection
    ht = ctx.apply("dec/out", h_tildes.transpose(0, 1))    # (B, St, H)
    return L.dense(params["fc"], ht).float()


def loss_fn(params, batch, cfg: NMTConfig, *, seed: Optional[int] = None,
            step: int = 0, injected=None):
    """Masked mean NLL per target token.

    batch: {"src", "tgt_in", "tgt_out", ["src_mask", "tgt_mask",
    "src_lengths", "tgt_lengths"]}; lengths freeze the recurrent carries of
    both stacks and derive the attention/loss masks when those are absent.
    ``seed=None`` runs without dropout; ``injected`` serves precomputed
    masks per site (core/dropout_plan.py)."""
    device = params["fc"]["w"].device
    ctx = cfg.plan.bind(seed, step, device=device, injected=injected)
    src_lengths = batch.get("src_lengths")
    tgt_lengths = batch.get("tgt_lengths")
    if src_lengths is not None:
        src_lengths = src_lengths.to(torch.int32)
    if tgt_lengths is not None:
        tgt_lengths = tgt_lengths.to(torch.int32)
    enc, st = encode(params, batch["src"], cfg, ctx=ctx, lengths=src_lengths)
    src_mask = batch.get("src_mask")
    if src_mask is None and src_lengths is not None:
        src_mask = metrics.length_mask(src_lengths, batch["src"].shape[1]) > 0
    logits = decode_train(params, batch["tgt_in"], enc, st, cfg, ctx=ctx,
                          src_mask=src_mask, tgt_lengths=tgt_lengths)
    lp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(lp, -1, batch["tgt_out"].long()[..., None])[..., 0]
    mask = batch.get("tgt_mask")
    if mask is None and tgt_lengths is not None:
        mask = metrics.length_mask(tgt_lengths, batch["tgt_in"].shape[1])
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# ---------------------------------------------------------------------------
# Serving: free-running inference on the single-step path (the two-pass
# restructure needs all target inputs up front: teacher forcing)
# ---------------------------------------------------------------------------


def init_state(cfg: NMTConfig, batch: int, max_src: int, *, device="cpu"):
    """Fresh decode state, every leaf batch at axis 1: (h, c) per layer, the
    input feed, and the encoder memory (enc_out, enc_proj, score_bias) over
    ``max_src`` positions. score_bias starts at -1e30: before a prefill the
    softmax is uniform over zero memory (finite, contributes nothing)."""
    nl, H = cfg.num_layers, cfg.hidden
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"h": z(nl, batch, H), "c": z(nl, batch, H), "feed": z(1, batch, H),
            "enc_out": z(1, batch, max_src, H), "enc_proj": z(1, batch, max_src, H),
            "score_bias": torch.full((1, batch, max_src), -1e30,
                                     dtype=torch.float32, device=device)}


def _eval_step(params, nl, x_t, h, c, feed, enc_proj, enc_out, score_bias):
    """One no-dropout decoder step (the training step with eval states)."""
    dec = params["decoder"]
    gx0_t = L.dense_sdrop({"w": dec[0]["W"], "b": dec[0]["b"]}, x_t, None)
    return _dec_step(params, nl, (h, c, feed), gx0_t, [None] * (2 * nl),
                     enc_proj, enc_out, score_bias)


def prefill(params, batch, cfg: NMTConfig, state):
    """Fill ``state`` (in place) from an encoder batch {"src" (B, S),
    "tgt_in" (B, T), ["src_mask"]}: the encoder in eval, its memory
    (enc_out, enc_proj, score_bias) parked in the state, then the target
    prefix replayed through eval decoder steps so (h, c, feed) sit where
    teacher-forced decoding left them. Returns (None, state)."""
    if "src" not in batch or "tgt_in" not in batch:
        raise ValueError(
            f"NMT prefill needs an encoder batch {{'src': (B, S), 'tgt_in': "
            f"(B, T)[, 'src_mask']}} (DecodeEngine.prefill takes one); got "
            f"keys {sorted(batch)}: a target prompt alone has no source "
            f"sentence (replay it with prompt_prefill(..., method='replay'))")
    src = batch["src"]
    B, Ss = src.shape
    if Ss > state["enc_out"].shape[2]:
        raise ValueError(f"source of {Ss} tokens exceeds the state's "
                         f"{state['enc_out'].shape[2]} memory positions")
    enc, enc_state = encode(params, src, cfg)              # eval ctx
    src_mask = batch.get("src_mask")
    if src_mask is None:
        src_mask = torch.ones((B, Ss), dtype=torch.bool, device=src.device)
    state["enc_out"][0, :, :Ss] = enc
    state["enc_proj"][0, :, :Ss] = L.dense(params["w_att"], enc)
    state["score_bias"].fill_(-1e30)
    state["score_bias"][0, :, :Ss] = torch.where(src_mask.bool(), 0.0, -1e30)
    nl = cfg.num_layers
    mem = (state["enc_proj"][0], state["enc_out"][0], state["score_bias"][0])
    x = L.lookup(params["tgt_embed"], batch["tgt_in"])
    h, c = enc_state.h, enc_state.c
    feed = torch.zeros((B, cfg.hidden), dtype=enc.dtype, device=enc.device)
    for t in range(x.shape[1]):
        h, c, feed = _eval_step(params, nl, x[:, t], h, c, feed, *mem)
    state["h"].copy_(h)
    state["c"].copy_(c)
    state["feed"][0].copy_(feed)
    return None, state


def decode_step(params, cfg: NMTConfig, state, tokens, pos):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V) float32, state),
    the state updated in place. ``pos`` is unused: the recurrent state is
    O(1) in position."""
    del pos
    x_t = L.lookup(params["tgt_embed"], tokens[:, 0])
    h, c, h_tilde = _eval_step(
        params, cfg.num_layers, x_t, state["h"], state["c"], state["feed"][0],
        state["enc_proj"][0], state["enc_out"][0], state["score_bias"][0])
    state["h"].copy_(h)
    state["c"].copy_(c)
    state["feed"][0].copy_(h_tilde)
    return L.dense(params["fc"], h_tilde).float()[:, None], state
