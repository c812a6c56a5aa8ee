"""Parameter conversion between the JAX reference and the port.

The reference's parameter pytrees (nested dicts/lists of arrays, given here
as numpy arrays) and the port's share leaves and layouts one to one — LSTM
W (D, 4H), U (H, 4H), gate order i,f,g,o; xLSTM's stacked per-family
leaves, R (H, dh, 4dh) — so conversion is a leaf-wise copy.
``from_reference`` builds the port's tensors on a device; ``to_reference``
returns numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def from_reference(tree, device="cpu", dtype=None):
    """Nested dicts/lists/tuples of numpy arrays -> the same of tensors
    (None subtrees, e.g. an xLSTM family without blocks, stay None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: from_reference(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [from_reference(v, device, dtype) for v in tree]
        return type(tree)(out) if isinstance(tree, tuple) else out
    t = torch.from_numpy(np.array(tree, copy=True))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def to_reference(tree):
    """Nested dicts/lists/tuples of tensors -> the same of numpy arrays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_reference(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [to_reference(v) for v in tree]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return tree.detach().cpu().numpy()
