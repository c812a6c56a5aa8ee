"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``).

They move data between the reference and the port as numpy arrays and
never import JAX: reference objects are used through their methods
(``ctx.schedule``, ``ctx.state``) and ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import to_tensor
from repro_torch.models import lstm_lm, seq2seq, transformer, xlstm


def to_numpy_tree(tree):
    """Nested dicts/lists/tuples of array-likes -> the same of numpy arrays
    (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [to_numpy_tree(v) for v in tree]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return np.asarray(tree)


# Every dropout site a model's loss consumes, as (name, how, steps, batch,
# dim); the lists live beside their models.
lm_sites = lstm_lm.dropout_sites
nmt_sites = seq2seq.dropout_sites
xlstm_sites = xlstm.dropout_sites
transformer_sites = transformer.dropout_sites


def injection_from_ctx(ctx, sites) -> dict:
    """{site: numpy table} sampled by a bound reference ``DropoutCtx``: a
    (rows, nk) keep-block table or a (rows, *batch, dim) dense mask, one
    row for a "state" site, row t for each "state_t" application at time
    index t (rows no application reads are zeros). Inactive sites are left
    out."""
    out, at_t = {}, {}
    for name, how, steps, batch, dim in sites:
        if how == "schedule":
            s = ctx.schedule(name, steps, batch, dim)
            table = s.keep_blocks if s.keep_blocks is not None else s.dense_mask
        else:
            st = ctx.state(name, batch, dim, t=steps if how == "state_t" else None)
            table = st.keep_blocks if st.keep_blocks is not None else st.dense_mask
            if table is not None and how == "state_t":
                at_t.setdefault(name, {})[steps] = np.asarray(table)
                continue
            table = None if table is None else np.asarray(table)[None]
        if table is not None:
            out[name] = np.asarray(table)
    for name, rows in at_t.items():
        blank = np.zeros_like(next(iter(rows.values())))
        out[name] = np.stack([rows.get(t, blank) for t in range(max(rows) + 1)])
    return out


def to_torch(tree, device="cpu"):
    """numpy tree -> tensors (ints stay ints, None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [to_torch(v, device) for v in tree]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return to_tensor(tree).to(device)


def require_cuda() -> torch.device:
    """The CUDA device for a ``cuda``-marked test; skips the test without one
    (decided when the test runs, never at import or collection)."""
    import pytest
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels)")
    from repro_torch.device import set_full_fp32
    set_full_fp32()
    return torch.device("cuda")


def serve_rectangular(spec, cfg, params, prompt, loop="device", n=10, *,
                      batch=None, max_seq=32, frames=None, **kw):
    """Greedy (or ``kw``-configured) continuation of a rectangular prompt
    (B, L) on a fresh ``DecodeEngine``: NMT prefills the encoder batch
    {"src": prompt, "tgt_in": prompt[:, :-1]}, an encoder-decoder
    transformer {"tokens": prompt[:, :-1], "frames": frames} (B, enc_seq,
    D), the others ``prompt_prefill``.
    ``loop`` "device" is ``generate`` (chunked; CUDA graphs on the card),
    "python" ``generate_python``. Returns (B, n) numpy tokens."""
    from repro_torch.serving import DecodeEngine, prompt_prefill
    eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=max_seq,
                       batch=batch or prompt.shape[0], **kw)
    if spec.kind == "nmt" or frames is not None:
        eng.prefill({"src": prompt, "tgt_in": prompt[:, :-1]}
                    if spec.kind == "nmt" else
                    {"tokens": prompt[:, :-1], "frames": frames})
        tok0, pos0 = prompt[:, -1:], prompt.shape[1] - 1
    else:
        eng.state, tok0, pos0 = prompt_prefill(spec, cfg, params, prompt,
                                               state=eng.state)
    gen = eng.generate if loop == "device" else eng.generate_python
    return gen(tok0, n, start_pos=pos0, seed=3)
