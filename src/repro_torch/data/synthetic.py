"""Deterministic synthetic data (port of repro.data.synthetic: ``lm_stream``
and ``nmt_pairs``).

Pure numpy with an explicit seed, bit-equal to the reference's data: a
Zipfian token stream with a 2nd-order Markov structure, so an LSTM has
something learnable (PTB-like vocabulary sizes), and padded toy
translation pairs for the NMT model.
"""
from __future__ import annotations

import numpy as np


def lm_stream(vocab: int, length: int, *, seed: int = 0,
              zipf_a: float = 1.2) -> np.ndarray:
    """Zipf-distributed tokens with Markov back-off (learnable bigrams)."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(zipf_a, size=length).astype(np.int64)
    base = (base - 1) % vocab
    # with p=.55 the next token is a deterministic function of the previous two
    out = base.copy()
    coin = rng.random(length)
    for t in range(2, length):
        if coin[t] < 0.55:
            out[t] = (out[t - 1] * 31 + out[t - 2] * 17 + 7) % vocab
    return out.astype(np.int32)


def nmt_pairs(n: int, src_vocab: int, tgt_vocab: int, max_len: int = 24,
              *, seed: int = 0):
    """Learnable toy translation: tgt = affine-remapped src with local swaps.

    Returns dict of padded arrays: src, src_mask, tgt_in, tgt_out, tgt_mask.
    Token 0 = pad, 1 = BOS, 2 = EOS. Bit-equal to the reference's pairs.
    """
    rng = np.random.default_rng(seed)
    src = np.zeros((n, max_len), np.int32)
    tgt_in = np.zeros((n, max_len), np.int32)
    tgt_out = np.zeros((n, max_len), np.int32)
    src_mask = np.zeros((n, max_len), bool)
    tgt_mask = np.zeros((n, max_len), bool)
    for i in range(n):
        L = rng.integers(6, max_len - 1)
        s = rng.integers(3, src_vocab, size=L)
        t = (s * 7 + 3) % (tgt_vocab - 3) + 3
        # local permutation noise: swap ~20% of adjacent pairs
        for j in range(0, L - 1, 2):
            if rng.random() < 0.2:
                t[j], t[j + 1] = t[j + 1], t[j]
        src[i, :L] = s
        src_mask[i, :L] = True
        tgt_in[i, 0] = 1
        tgt_in[i, 1:L + 1] = t[:max_len - 1][:L]
        tgt_out[i, :L] = t[:max_len][:L]
        tgt_out[i, L] = 2 if L < max_len else t[-1]
        tgt_mask[i, :min(L + 1, max_len)] = True
    return {"src": src, "src_mask": src_mask, "tgt_in": tgt_in,
            "tgt_out": tgt_out, "tgt_mask": tgt_mask}
