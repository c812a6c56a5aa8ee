"""Checkpoints with crash-safe manifests (port of repro.checkpoint.store).

The reference's on-disk layout, so that either package reads what the
other wrote (one directory a step):

    ckpt_dir/step_000000123/
        shard_00000_of_00001.npz    # every leaf, keyed by its tree path
        MANIFEST.json               # written LAST: the commit marker

  * Leaves are keyed by their "/"-joined tree paths (dict keys, list and
    tuple indices: "0/fwd/0/W", "1/1/m/crf"), the keys JAX's
    ``tree_flatten_with_path`` gives the same tree; a None subtree has no
    leaves. Tensors are stored as numpy arrays (bfloat16 ones as float32,
    which holds them exactly: a restore casts back to the same bits),
    Python ints as int32, floats as float32, bools as bool.
  * A step without MANIFEST.json is incomplete (a crash mid-write): it is
    ignored, and removed by the next save once a later step is complete.
    ``keep`` complete steps are kept.
  * ``meta`` (JSON, e.g. the run's dropout plan) is stored in the manifest
    verbatim.
  * ``PreemptionHook`` turns SIGTERM into a request for a final save at the
    next step boundary.
  * The data pipeline has no state: batches are a pure function of (seed,
    step), so a restore is (params, optimizer state, step).
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.convert import to_numpy, to_tensor


def _items(tree, prefix=""):
    """(path key, leaf) pairs in tree order (dict keys sorted, as JAX
    flattens them)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _items(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _items(x, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _np(v) -> np.ndarray:
    if torch.is_tensor(v):
        return to_numpy(v)
    if isinstance(v, (bool, np.bool_)):
        return np.asarray(v, np.bool_)
    if isinstance(v, (int, np.integer)):
        return np.asarray(v, np.int32)
    if isinstance(v, (float, np.floating)):
        return np.asarray(v, np.float32)
    return np.asarray(v)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
                    meta: Any = None) -> str:
    """Save every leaf of ``tree`` as step ``step``; returns the step's
    directory. Older complete steps beyond ``keep`` are removed."""
    keyed = dict(_items(tree))
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    os.makedirs(step_dir, exist_ok=True)
    arrays = {k: _np(v) for k, v in sorted(keyed.items())}
    shard = os.path.join(step_dir, "shard_00000_of_00001.npz")
    tmp = shard + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, shard)
    manifest = {"step": step, "host_count": 1, "keys": sorted(keyed),
                "shapes": {k: list(a.shape) for k, a in arrays.items()}}
    if meta is not None:
        manifest["meta"] = meta
    with tempfile.NamedTemporaryFile("w", dir=step_dir, delete=False) as f:
        json.dump(manifest, f)
        tmpname = f.name
    os.replace(tmpname, os.path.join(step_dir, "MANIFEST.json"))  # commit
    _gc(ckpt_dir, keep)
    return step_dir


def _complete_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and os.path.exists(
                      os.path.join(ckpt_dir, d, "MANIFEST.json")))


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = _complete_steps(ckpt_dir)
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_"):
            continue
        s = int(d.split("_")[1])
        complete = s in steps
        stale_incomplete = not complete and steps and s < steps[-1]
        evicted = complete and len(steps) > keep and s in steps[:-keep]
        if stale_incomplete or evicted:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step:09d}", "MANIFEST.json")) as f:
        return json.load(f)


def _like(ref, v: np.ndarray):
    """A stored array as the kind of leaf ``ref`` is: a tensor of ref's
    dtype on ref's device, or a Python scalar."""
    if torch.is_tensor(ref):
        return to_tensor(v).to(device=ref.device, dtype=ref.dtype)
    if isinstance(ref, bool):
        return bool(v)
    if isinstance(ref, int):
        return int(v)
    if isinstance(ref, float):
        return float(v)
    return v


def _rebuild(tree, data: dict, prefix=""):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], data, f"{prefix}{k}/") for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(x, data, f"{prefix}{i}/") for i, x in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return _like(tree, data[prefix[:-1]])


def restore_checkpoint(ckpt_dir: str, tree_like: Any, *,
                       step: Optional[int] = None) -> tuple[Any, int]:
    """(tree, step): the checkpoint (the latest complete one without
    ``step``) in the structure of ``tree_like``, each leaf new, with the
    dtype and on the device of its leaf in ``tree_like``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    manifest = read_manifest(ckpt_dir, step)
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    data = {}
    for fname in os.listdir(step_dir):
        if fname.startswith("shard_") and fname.endswith(".npz"):
            with np.load(os.path.join(step_dir, fname)) as z:
                data.update({k: z[k] for k in z.files})
    missing = set(manifest["keys"]) - set(data)
    if missing:
        raise IOError(f"checkpoint step {step} missing leaves: "
                      f"{sorted(missing)[:5]}...")
    return _rebuild(tree_like, data), step


class PreemptionHook:
    """SIGTERM -> request a final checkpoint at the next step boundary.
    ``restore()`` puts the previous handler back."""

    def __init__(self):
        self.requested = threading.Event()
        self._prev = signal.signal(signal.SIGTERM, self._handler)

    def _handler(self, signum, frame):
        self.requested.set()

    @property
    def should_save(self) -> bool:
        return self.requested.is_set()

    def restore(self) -> None:
        signal.signal(signal.SIGTERM, self._prev)
