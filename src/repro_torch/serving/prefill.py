"""Shared prompt prefill for every decode-state kind (port of
repro.serving.prefill).

Two ways to turn a prompt into decode state:

  * ``prompt_prefill(method="native")``: the arch's own rectangular prefill
    through ``adapters.prefill_fn`` (the transformer fills its KV cache in
    one attention pass, K9 under ``attn_impl="flash"``; xlstm runs its
    block stack and keeps every final state). Every row must be a
    full-length prompt. An encoder-decoder's or an embeddings-in
    transformer's prefill batch is not a token prompt: it goes through
    ``DecodeEngine.prefill`` (frames, embeddings), as ``launch/serve.py``.
  * ``replay_prefill``: ``decode_step`` over the (padded) prompt tokens
    with per-row lengths, so a RAGGED group prefills in one batched pass:
    each row's final state is the one after its own last token, as a
    dedicated replay of that row would leave it.

Convention (both helpers, the engine and ``launch/serve.py``): prefill
consumes ``prompt[:, :-1]``; decode then starts by feeding ``prompt[:, -1]``
at position ``len - 1``, which gives the logits of the first generated
token.

The state is updated in place (and returned), as ``decode_step`` does.
"""
from __future__ import annotations

import torch

from repro_torch.configs import adapters


def select_rows(old, new, keep):
    """Per-slot decode-state select: every leaf is ``(L, B, ...)`` with the
    slot axis at 1; ``keep`` (B,) bool takes ``new``'s rows where True and
    ``old``'s elsewhere. Returns a new state."""
    def sel(o, nw):
        m = keep.reshape((1, -1) + (1,) * (o.dim() - 2))
        return torch.where(m, nw.to(o.dtype), o)
    return {k: sel(old[k], new[k]) for k in old}


@torch.no_grad()
def replay_prefill(spec, cfg, params, state, tokens, lengths=None, *,
                   start_pos: int = 0):
    """Replay ``tokens`` (B, T) through ``decode_step`` from ``start_pos``.

    ``lengths`` (B,) counts each row's valid tokens (default: all T). Rows
    past their length go on decoding padding, but their state is taken as
    it stood after their last valid token (a copy per distinct length), so
    each row ends as a dedicated length-``lengths[b]`` replay would. Updates
    ``state`` in place and returns it.
    """
    decode = adapters.decode_fn(spec)
    B, T = tokens.shape
    if T == 0:
        return state
    dev = tokens.device
    lens = [T] * B if lengths is None else torch.as_tensor(lengths).tolist()
    # rows that stop short keep their state from their last valid step
    final = None if min(lens) == T else {k: v.clone() for k, v in state.items()}
    lens_d = torch.tensor(lens, device=dev)
    positions = torch.arange(start_pos, start_pos + T, device=dev)
    for t in range(T):
        decode(params, cfg, state, tokens[:, t:t + 1], positions[t])
        if final is not None and t + 1 in lens:
            final = select_rows(final, state, lens_d == t + 1)
    if final is not None:
        for k, v in state.items():
            v.copy_(final[k])
    return state


@torch.no_grad()
def prompt_prefill(spec, cfg, params, prompt, *, state, method: str = "auto"):
    """Rectangular prompt -> decode handoff.

    ``prompt`` (B, L) int, L >= 1. Prefills ``prompt[:, :-1]`` into ``state``
    and returns ``(state, last_tokens (B, 1), start_pos)``: feed
    ``last_tokens`` at ``start_pos`` to generate the first new token.
    method "auto" is "native" (every serving kind of the port has a native
    prefill); "replay" runs the decode steps. NMT's native prefill needs an
    encoder batch, which a token prompt is not: it raises ``ValueError``
    (use ``DecodeEngine.prefill`` or method "replay").
    """
    if method == "auto":
        method = "native" if adapters.has_native_prefill(spec) else "replay"
    if method not in ("native", "replay"):
        raise ValueError(f"unknown prefill method {method!r}")
    body = prompt[:, :-1]
    if body.shape[1]:
        if method == "native":
            _, state = adapters.prefill_fn(spec)(params, {"tokens": body},
                                                 cfg, state)
        else:
            state = replay_prefill(spec, cfg, params, state, body)
    return state, prompt[:, -1:], prompt.shape[1] - 1
