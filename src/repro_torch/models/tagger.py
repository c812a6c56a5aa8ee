"""BiLSTM-CNN-CRF sequence tagger (Ma & Hovy 2016; paper Table 3). Port of
``repro.models.tagger``.

Char-CNN word encoding + word embeddings -> concat -> (structured) dropout
at the "inp" site -> BiLSTM (a forward and a backward one-layer stack, each
with the paper's NR + RH sites under its direction's prefix, "fwd/" or
"bwd/", so the two directions draw independent masks) -> linear-chain CRF
(forward-algorithm loss, Viterbi decode). ``cfg.engine`` picks the
recurrent path of both directions (core/lstm.py): under ``:pallas`` the
fused engine runs K3/K4 once per direction, the scheduled engine K1 every
step of each. The parameter dict has the reference's leaves and layouts
(``char_conv`` w (K, E, F), ``fwd`` / ``bwd`` [{W, U, b}], ``fc``, ``crf``
(T, T)), so ``convert.from_reference`` carries them over leaf for leaf.

A batch is {"words" (B, S), "chars" (B, S, W), "tags" (B, S), ["mask"
(B, S) bool], ["lengths" (B,)]}. With "lengths" the rows are ragged: both
stacks freeze their carries past each row's length and the backward stack
reads each row's valid prefix reversed (``_reverse_valid``), pads in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import layers as L
from repro_torch.core import lstm as lstm_mod
from repro_torch.core import metrics
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.sdrop import DropoutSpec


@dataclasses.dataclass(frozen=True)
class TaggerConfig:
    name: str = "bilstm_crf"
    vocab: int = 20000
    char_vocab: int = 100
    char_embed: int = 30
    char_filters: int = 30
    char_kernel: int = 3
    word_embed: int = 100
    hidden: int = 200
    num_tags: int = 9
    # sites: "inp" on concat(CNN, embed); "rh" recurrent (paper extension)
    plan: DropoutPlan = DropoutPlan({"inp": DropoutSpec(rate=0.5)})
    engine: str = "scheduled"      # "scheduled" | "fused" | "stepwise"
    param_dtype: Any = torch.float32


def init_params(generator: torch.Generator, cfg: TaggerConfig, *,
                device="cpu"):
    dt = cfg.param_dtype
    u = lambda shape, s: L.uniform_init(generator, shape, s, dt, device)
    feat = cfg.word_embed + cfg.char_filters
    lstm = lambda: lstm_mod.init_lstm_params(generator, feat, cfg.hidden, 1,
                                             dtype=dt, device=device)
    K, E = cfg.char_kernel, cfg.char_embed
    return {
        "word_embed": u((cfg.vocab, cfg.word_embed), 0.1),
        "char_embed": u((cfg.char_vocab, E), 0.1),
        "char_conv": {
            "w": u((K, E, cfg.char_filters), (K * E) ** -0.5),
            "b": torch.zeros((cfg.char_filters,), dtype=dt, device=device),
        },
        "fwd": lstm(),
        "bwd": lstm(),
        "fc": L.init_dense(generator, 2 * cfg.hidden, cfg.num_tags, dtype=dt,
                           device=device),
        "crf": u((cfg.num_tags, cfg.num_tags), 0.1),
    }


def char_cnn(params, chars: torch.Tensor, cfg: TaggerConfig) -> torch.Tensor:
    """chars (B, S, W) ids -> (B, S, F): conv over the word's chars (padded
    K // 2 before and K - 1 - K // 2 after), relu, max over W. ``amax``
    splits a tied maximum's gradient evenly, as ``jnp.max`` does."""
    W = chars.shape[-1]
    x = L.lookup(params["char_embed"], chars)                # (B, S, W, E)
    K = cfg.char_kernel
    xp = F.pad(x, (0, 0, K // 2, K - 1 - K // 2))
    w, b = params["char_conv"]["w"], params["char_conv"]["b"]
    conv = sum(xp[:, :, i:i + W, :] @ w[i] for i in range(K)) + b
    return torch.amax(torch.relu(conv), dim=2)


def _reverse_valid(xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-row reversal of each row's valid prefix. xs: (S, B, D).

    Position t maps to ``lengths[b] - 1 - t`` for t < lengths[b] and stays
    put on the padded tail; the gradient scatters back through the same
    indices."""
    S = xs.shape[0]
    t = torch.arange(S, device=xs.device)[:, None]
    n = lengths.to(device=xs.device, dtype=torch.long)[None, :]
    idx = torch.where(t < n, n - 1 - t, t)
    return torch.take_along_dim(xs, idx[:, :, None], dim=0)


def features(params, batch, cfg: TaggerConfig, *, ctx=None) -> torch.Tensor:
    """-> (B, S, 2H) BiLSTM features."""
    if ctx is None:
        ctx = cfg.plan.bind(None)
    words, chars = batch["words"], batch["chars"]
    lengths = batch.get("lengths")
    if lengths is not None:
        lengths = lengths.to(torch.int32)
    B = words.shape[0]
    we = L.lookup(params["word_embed"], words)
    ce = char_cnn(params, chars, cfg)
    x = torch.cat([we, ce], dim=-1)                           # (B, S, feat)
    # paper section 4.3: structured dropout on the concatenated features
    x = ctx.apply("inp", x)

    def run(dirn, xs):
        state = lstm_mod.zero_state(1, B, cfg.hidden, dtype=xs.dtype,
                                    device=xs.device)
        ys, _ = lstm_mod.lstm_stack(params[dirn], xs, state, ctx=ctx,
                                    site=dirn, engine=cfg.engine,
                                    lengths=lengths)
        return ys

    xs = x.transpose(0, 1)                                    # (S, B, feat)
    fwd = run("fwd", xs)
    if lengths is None:
        bwd = run("bwd", xs.flip(0)).flip(0)
    else:
        bwd = _reverse_valid(run("bwd", _reverse_valid(xs, lengths)), lengths)
    return torch.cat([fwd, bwd], dim=-1).transpose(0, 1)


def emissions(params, batch, cfg: TaggerConfig, *, ctx=None) -> torch.Tensor:
    return L.dense(params["fc"], features(params, batch, cfg, ctx=ctx))


def crf_log_norm(emit: torch.Tensor, trans: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Forward algorithm. emit (B, S, T), trans (T, T), mask (B, S) -> (B,)."""
    mask = mask.bool()
    alpha = emit[:, 0]
    for t in range(1, emit.shape[1]):
        scores = alpha[:, :, None] + trans[None] + emit[:, t, None, :]
        alpha = torch.where(mask[:, t, None], torch.logsumexp(scores, dim=1),
                            alpha)
    return torch.logsumexp(alpha, dim=-1)


def crf_score(emit: torch.Tensor, tags: torch.Tensor, trans: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Score of the tag sequence ``tags`` (B, S) -> (B,).

    The transition scores trans[tags[:, t], tags[:, t + 1]] are read through
    one-hot products, whose gradient into ``trans`` is a matrix product: an
    index's backward would add B x (S - 1) terms into T x T entries by
    atomics on the card, in no fixed order."""
    m = mask.to(emit.dtype)
    tags = tags.long()
    e = torch.gather(emit, -1, tags[..., None])[..., 0]
    e = (e * m).sum(-1)
    oh = F.one_hot(tags, trans.shape[0]).to(emit.dtype)       # (B, S, T)
    t_scores = ((oh[:, :-1] @ trans) * oh[:, 1:]).sum(-1)     # (B, S-1)
    return e + (t_scores * m[:, 1:]).sum(-1)


def dropout_sites(cfg: TaggerConfig, batch: int, seq: int):
    """Every dropout site a loss consumes, in ``lstm_lm.dropout_sites``'
    format: "inp" on the (B, S) concatenated features, and each direction's
    one-layer NR and RH schedules."""
    feat = cfg.word_embed + cfg.char_filters
    sites = [("inp", "state", None, (batch, seq), feat)]
    for dirn in ("fwd", "bwd"):
        sites.append((f"{dirn}/layer0/nr", "schedule", seq, batch, feat))
        sites.append((f"{dirn}/layer0/rh", "schedule", seq, batch, cfg.hidden))
    return sites


def loss_fn(params, batch, cfg: TaggerConfig, *, seed: Optional[int] = None,
            step: int = 0, injected=None) -> torch.Tensor:
    """Mean CRF negative log-likelihood per sequence (per real sequence when
    the batch has "lengths": rows of length 0 do not count).

    ``seed=None`` runs without dropout; ``injected`` serves precomputed
    masks per site (core/dropout_plan.py)."""
    ctx = cfg.plan.bind(seed, step, device=params["crf"].device,
                        injected=injected)
    emit = emissions(params, batch, cfg, ctx=ctx)
    mask = batch.get("mask")
    if mask is None:
        lmask = metrics.resolve_mask(batch, batch["words"])
        mask = (lmask > 0 if lmask is not None
                else torch.ones(batch["words"].shape, dtype=torch.bool,
                                device=emit.device))
    log_z = crf_log_norm(emit, params["crf"], mask)
    score = crf_score(emit, batch["tags"], params["crf"], mask)
    if "lengths" in batch:
        real = (batch["lengths"] > 0).to(torch.float32)
        return ((log_z - score) * real).sum() / torch.clamp(real.sum(), min=1.0)
    return (log_z - score).mean()


def viterbi_decode(emit: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Most likely tag path of emissions (B, S, T) under ``trans`` -> (B, S)
    int32. Ties take the first maximal index, as ``jnp.argmax``."""
    alpha, back = emit[:, 0], []
    for t in range(1, emit.shape[1]):
        scores = alpha[:, :, None] + trans[None]
        back.append(torch.argmax(scores, dim=1))              # (B, T)
        alpha = torch.amax(scores, dim=1) + emit[:, t]
    tag = torch.argmax(alpha, dim=-1)
    path = [tag]
    for bp in reversed(back):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return torch.stack(path[::-1], dim=1).to(torch.int32)


@torch.no_grad()
def viterbi(params, batch, cfg: TaggerConfig) -> torch.Tensor:
    """Most likely tag sequence of a batch, without dropout. (B, S) int32."""
    return viterbi_decode(emissions(params, batch, cfg), params["crf"])
