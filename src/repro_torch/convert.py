"""Parameter conversion between the JAX reference and the port.

The reference's parameter pytrees (nested dicts/lists of arrays, given here
as numpy arrays) and the port's share leaves and layouts one to one — LSTM
W (D, 4H), U (H, 4H), gate order i,f,g,o; xLSTM's stacked per-family
leaves, R (H, dh, 4dh) — so conversion is a leaf-wise copy.
``from_reference`` builds the port's tensors on a device; ``to_reference``
returns numpy arrays.

bfloat16 crosses bit for bit in both directions without ``ml_dtypes``: a
reference bfloat16 array (``a.dtype.name == "bfloat16"``) is viewed as
uint16 and reinterpreted as ``torch.bfloat16``; a bfloat16 tensor comes back
as float32 numpy, which holds every bfloat16 value exactly (casting it to
bfloat16 gives the same bits).
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
    t = to_tensor(tree)
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def to_tensor(a) -> torch.Tensor:
    """An array-like as a new CPU tensor of its dtype; bfloat16 numpy arrays
    (``ml_dtypes``) by their bits."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 as float32 (exact)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def to_reference(tree):
    """Nested dicts/lists/tuples of tensors -> the same of numpy arrays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_reference(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [to_reference(v) for v in tree]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return to_numpy(tree)
