"""Deterministic synthetic data (port of repro.data.synthetic: ``lm_stream``,
``token_batches``, ``nmt_pairs`` and ``ner_examples``).

Pure numpy with an explicit seed, bit-equal to the reference's data: a
Zipfian token stream with a 2nd-order Markov structure, so an LSTM has
something learnable (PTB-like vocabulary sizes), padded toy translation
pairs for the NMT model, and tag-pattern sequences for the NER tagger.
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


def token_batches(stream: np.ndarray, batch: int, seq: int):
    """Contiguous BPTT batching (Zaremba-style): yields (tokens, labels)."""
    n = len(stream) // batch
    data = stream[:n * batch].reshape(batch, n)
    for i in range(0, n - seq - 1, seq):
        yield data[:, i:i + seq], data[:, i + 1:i + seq + 1]


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


def ner_examples(n: int, vocab: int, char_vocab: int, num_tags: int = 9,
                 seq: int = 24, word_len: int = 12, *, seed: int = 0):
    """Tag-pattern NER: trigger classes deterministically open entity spans.

    BIO-style tags over (num_tags-1)//2 entity types; words in an entity
    span come from a type-specific vocabulary band, and each word's char
    ids are a function of its word id. Returns words (n, seq), chars (n,
    seq, word_len), tags (n, seq) int32 and an all-true bool mask.
    """
    rng = np.random.default_rng(seed)
    n_types = (num_tags - 1) // 2
    words = np.zeros((n, seq), np.int32)
    chars = np.zeros((n, seq, word_len), np.int32)
    tags = np.zeros((n, seq), np.int32)
    band = (vocab - 10) // (n_types + 1)
    for i in range(n):
        t = 0
        while t < seq:
            if rng.random() < 0.25 and t < seq - 2:
                typ = rng.integers(0, n_types)
                span = rng.integers(1, 4)
                lo = 10 + (typ + 1) * band
                for j in range(min(span, seq - t)):
                    words[i, t] = rng.integers(lo, min(lo + band, vocab))
                    tags[i, t] = 1 + 2 * typ + (0 if j == 0 else 1)  # B-x/I-x
                    t += 1
            else:
                words[i, t] = rng.integers(10, 10 + band)
                tags[i, t] = 0
                t += 1
        for t in range(seq):
            w = int(words[i, t])
            for c in range(word_len):
                chars[i, t, c] = (w * (c + 3) + c) % (char_vocab - 1) + 1
    mask = np.ones((n, seq), bool)
    return {"words": words, "chars": chars, "tags": tags, "mask": mask}
