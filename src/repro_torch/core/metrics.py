"""Length-aware loss helpers for ragged batches (port of repro.core.metrics).

``lengths`` is (B,) int32 real-token counts; masks are (B, T) float32 with
1.0 on real positions. Dummy rows of length 0 contribute nothing.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def length_mask(lengths: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) float32 mask; 1.0 where t < lengths[b]."""
    t = torch.arange(seq_len, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(torch.float32)


def resolve_mask(batch: dict, tokens: torch.Tensor,
                 key: str = "lengths") -> Optional[torch.Tensor]:
    """(B, T) mask from ``batch[key]`` lengths, or None if rectangular."""
    lengths = batch.get(key)
    if lengths is None:
        return None
    return length_mask(lengths, tokens.shape[1])


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` where ``mask`` is nonzero; an all-pad batch gives
    0.0, not NaN (the denominator is clamped to 1)."""
    m = mask.to(torch.float32)
    return (values.to(torch.float32) * m).sum() / torch.clamp(m.sum(), min=1.0)


def lm_loss(logits_fn, feats: torch.Tensor, labels: torch.Tensor,
            loss_chunks: int = 8) -> torch.Tensor:
    """Softmax cross-entropy of ``logits_fn(f)`` (float32 (B, s, V)) over
    ``loss_chunks`` sequence chunks ``f`` of ``feats (B, S, D)`` (lowered to
    a divisor of S), summed and divided by B*S: the port's copy of
    ``repro.models.transformer.lm_loss``, each chunk recomputed in the
    backward."""
    B, S, _ = feats.shape
    n = loss_chunks
    while S % n:
        n -= 1
    def chunk_nll(f, lab):
        lp = torch.log_softmax(logits_fn(f), dim=-1)
        return lp.gather(-1, lab.long()[..., None]).sum()

    total = feats.new_zeros((), dtype=torch.float32)
    for f, lab in zip(feats.chunk(n, dim=1), labels.chunk(n, dim=1)):
        # each chunk's logits are recomputed in the backward, as the
        # reference's jax.checkpoint'ed chunk: only one chunk's float32
        # logits and log-softmax are alive at a time
        nll = (checkpoint(chunk_nll, f, lab, use_reentrant=False)
               if torch.is_grad_enabled() else chunk_nll(f, lab))
        total = total - nll
    return total / (B * S)


def masked_lm_loss(w: torch.Tensor, feats: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor, *, chunk: int = 1024) -> torch.Tensor:
    """Mean softmax cross-entropy of ``feats @ w`` over real tokens (``mask``
    (B, T) nonzero), in chunks of ``chunk`` flattened tokens; an all-pad
    batch gives 0.0."""
    f2 = feats.reshape(-1, feats.shape[-1])
    l2 = labels.reshape(-1).long()
    m2 = mask.reshape(-1).to(torch.float32)
    total = feats.new_zeros((), dtype=torch.float32)
    for i in range(0, f2.shape[0], chunk):
        logits = f2[i:i + chunk].float() @ w.float()
        nll = (torch.logsumexp(logits, -1)
               - logits.gather(-1, l2[i:i + chunk, None])[:, 0])
        total = total + (nll * m2[i:i + chunk]).sum()
    return total / torch.clamp(m2.sum(), min=1.0)
