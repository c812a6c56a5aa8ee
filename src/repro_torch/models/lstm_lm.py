"""LSTM language models from the paper's Table 1 (port of repro.models.lstm_lm).

Zaremba'14 medium (2x650) / large (2x1500) and AWD-LSTM (3x1150, embed
400, tied embeddings). The dropout pattern is a ``DropoutPlan`` over the
sites "embed", "nr", "rh" and "out"; the parameter dict has the reference's
leaves and layouts (``embed`` (V, E), ``lstm`` [{W, U, b}], ``fc`` {w, b}
or, tied, an optional ``proj``).
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


@dataclasses.dataclass(frozen=True)
class LSTMLMConfig:
    name: str = "lstm_lm"
    vocab: int = 10000
    embed: int = 650
    hidden: int = 650
    num_layers: int = 2
    tie_embeddings: bool = False
    init_scale: float = 0.05
    plan: DropoutPlan = DropoutPlan()
    engine: str = "scheduled"          # "scheduled" | "fused" | "stepwise"
    param_dtype: Any = torch.float32


def _mk(defaults: dict, kw: dict) -> LSTMLMConfig:
    return LSTMLMConfig(**{**defaults, **kw})


def zaremba_medium(**kw) -> LSTMLMConfig:
    return _mk(dict(name="zaremba_medium", vocab=10000, embed=650, hidden=650,
                    num_layers=2, init_scale=0.05,
                    plan=DropoutPlan.case("case3", 0.5,
                                          sites=("embed", "nr", "out"))), kw)


def zaremba_large(**kw) -> LSTMLMConfig:
    return _mk(dict(name="zaremba_large", vocab=10000, embed=1500, hidden=1500,
                    num_layers=2, init_scale=0.04,
                    plan=DropoutPlan.case("case3", 0.65,
                                          sites=("embed", "nr", "out"))), kw)


def awd_lstm(**kw) -> LSTMLMConfig:
    return _mk(dict(name="awd_lstm", vocab=10000, embed=400, hidden=1150,
                    num_layers=3, tie_embeddings=True,
                    plan=DropoutPlan({"embed": DropoutSpec(rate=0.4),
                                      "nr": DropoutSpec(rate=0.25),
                                      "rh": DropoutSpec(rate=0.5),
                                      "out": DropoutSpec(rate=0.4)})), kw)


def init_params(generator: torch.Generator, cfg: LSTMLMConfig, *,
                device="cpu"):
    dt = cfg.param_dtype
    p = {
        "embed": L.uniform_init(generator, (cfg.vocab, cfg.embed), 0.1, dt, device),
        "lstm": lstm_mod.init_lstm_params(generator, cfg.embed, cfg.hidden,
                                          cfg.num_layers,
                                          init_scale=cfg.init_scale,
                                          dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        p["fc"] = L.init_dense(generator, cfg.hidden, cfg.vocab,
                               scale=cfg.init_scale, dtype=dt, device=device)
    elif cfg.hidden != cfg.embed:
        p["proj"] = L.init_dense(generator, cfg.hidden, cfg.embed, bias=False,
                                 dtype=dt, device=device)
    return p


def forward(params, tokens: torch.Tensor, cfg: LSTMLMConfig, *, state=None,
            ctx=None, lengths: Optional[torch.Tensor] = None):
    """tokens (B, S) -> (logits (B, S, V) float32, final LSTMState)."""
    if ctx is None:
        ctx = cfg.plan.bind(None)
    B, _ = tokens.shape
    x = L.lookup(params["embed"], tokens)                    # (B, S, E)
    x = ctx.apply("embed", x)
    if state is None:
        state = lstm_mod.zero_state(cfg.num_layers, B, cfg.hidden,
                                    dtype=x.dtype, device=x.device)
    ys, state = lstm_mod.lstm_stack(params["lstm"], x.transpose(0, 1), state,
                                    ctx=ctx, engine=cfg.engine,
                                    lengths=lengths)
    h = ctx.apply("out", ys.transpose(0, 1))                # (B, S, H)
    if cfg.tie_embeddings:
        if "proj" in params:
            h = L.dense(params["proj"], h)
        logits = h @ params["embed"].t()
    else:
        logits = L.dense(params["fc"], h)
    return logits.float(), state


def dropout_sites(cfg: LSTMLMConfig, batch: int, seq: int):
    """Every dropout site a forward consumes, as (name, how, steps, batch,
    dim): "state" for the non-recurrent applications (embed, out),
    "schedule" for the per-layer NR/RH sites."""
    sites = [("embed", "state", None, (batch, seq), cfg.embed),
             ("out", "state", None, (batch, seq), cfg.hidden)]
    for layer in range(cfg.num_layers):
        d = cfg.embed if layer == 0 else cfg.hidden
        sites.append((f"lstm/layer{layer}/nr", "schedule", seq, batch, d))
        sites.append((f"lstm/layer{layer}/rh", "schedule", seq, batch,
                      cfg.hidden))
    return sites


def loss_fn(params, batch, cfg: LSTMLMConfig, *, state=None,
            seed: Optional[int] = None, step: int = 0, injected=None):
    """Mean NLL per token (per real token when the batch has "lengths").

    ``seed=None`` runs without dropout; ``injected`` serves precomputed
    masks per site (core/dropout_plan.py)."""
    device = params["embed"].device
    ctx = cfg.plan.bind(seed, step, device=device, injected=injected)
    lengths = batch.get("lengths")
    logits, _ = forward(params, batch["tokens"], cfg, state=state, ctx=ctx,
                        lengths=lengths)
    lp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(lp, -1, batch["labels"].long()[..., None])
    if lengths is None:
        return nll.mean()
    mask = metrics.length_mask(lengths, batch["tokens"].shape[1])
    return metrics.masked_mean(nll[..., 0], mask)


@torch.no_grad()
def perplexity(params, tokens, labels, cfg: LSTMLMConfig,
               lengths=None) -> float:
    """exp(mean NLL), over real tokens only when ``lengths`` is given."""
    logits, _ = forward(params, tokens, cfg, lengths=lengths)
    lp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(lp, -1, labels.long()[..., None])
    if lengths is None:
        return float(torch.exp(nll.mean()))
    mask = metrics.length_mask(lengths, tokens.shape[1])
    return float(torch.exp(metrics.masked_mean(nll[..., 0], mask)))
