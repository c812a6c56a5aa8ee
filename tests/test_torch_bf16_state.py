"""bfloat16 state across the port's boundaries: parameter conversion,
checkpoints, resume, and the clip + AdamW step, against the JAX reference.

* ``convert``: a reference bfloat16 tree (numpy, ``ml_dtypes``) becomes
  ``torch.bfloat16`` tensors with the same bits, and comes back as float32
  numpy that casts to the same bits again.
* checkpoints: a tree of bfloat16 parameters, float32 moments and Python
  ints saves and restores bit for bit; the reference restores the port's
  bfloat16 checkpoint into its own bfloat16 tree bit for bit; a bfloat16
  training run (the qwen3 smoke config, through ``launch.train.run``)
  resumed from its checkpoint gives a straight run's losses and parameters
  bit for bit.
* ``chain(clip_by_global_norm, adamw)`` on bfloat16 parameters with the
  clip active (gradients 40 x the clip's norm): one and three steps against
  the reference's ``update`` + ``apply_updates`` on the same numpy inputs.
  The reference promotes the clipped bfloat16 gradient to float32 (a
  float32 scale), so the moments see it unrounded. Moments within rtol
  1e-5 (float32, the same operations, which XLA contracts into FMAs: the
  last bits drift apart over three steps, up to 1.2e-6; the clipped
  gradient rounded to bfloat16, as the port did before, is 2e-3 off);
  parameters within one bfloat16 ulp
  (the float32 update is rounded once into the bfloat16 parameter, and a
  last-bit difference of the update may round the other way).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as r_ckpt  # noqa: E402
from repro import optim as r_optim  # noqa: E402
from repro.optim import optimizers as r_optimizers  # noqa: E402

from repro_torch import checkpoint as t_ckpt  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.convert import from_reference, to_reference  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.optim import tree_leaves, tree_map  # noqa: E402
from repro_torch.testing import to_numpy_tree  # noqa: E402

torch.set_num_threads(1)

BF = torch.bfloat16
LR, MAX_NORM = 1e-2, 1.0


def _np_tree(seed, scale=1.0):
    """A nested tree of bfloat16 numpy arrays (ml_dtypes) and a float32 leaf."""
    rng = np.random.default_rng(seed)
    b = lambda *s: np.asarray(jnp.asarray(rng.standard_normal(s) * scale, jnp.bfloat16))
    return {"a": b(5, 7), "blocks": [{"w": b(3, 4, 6), "b": b(6)}, {"w": b(2, 2)}],
            "z": (b(9),), "f": (rng.standard_normal(4) * scale).astype(np.float32)}


def _bits(t):
    return t.view(torch.int16) if t.dtype == BF else t


def test_convert_carries_bfloat16_bit_for_bit():
    tree = _np_tree(0)
    t = from_reference(tree)
    for x, a in zip(tree_leaves(t), jax.tree.leaves(tree)):
        want_dt = BF if a.dtype.name == "bfloat16" else torch.float32
        assert x.dtype == want_dt
        if want_dt == BF:
            np.testing.assert_array_equal(x.view(torch.int16).numpy(), a.view(np.int16))
    back = to_reference(t)
    for b, a in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert b.dtype == np.float32                          # lossless widening
        again = np.asarray(jnp.asarray(b, a.dtype))
        np.testing.assert_array_equal(again.view(np.uint8), a.view(np.uint8))
    # float32 numpy back into bfloat16 tensors: the same bits
    for x, y in zip(tree_leaves(from_reference(back, dtype=BF)), tree_leaves(t)):
        if y.dtype == BF:
            assert torch.equal(_bits(x), _bits(y))


def _bf16_state():
    params = from_reference(_np_tree(1))
    opt = t_optim.chain(t_optim.clip_by_global_norm(MAX_NORM), t_optim.adamw(LR))
    state = opt.init(params)
    grads = tree_map(lambda p: (torch.randn(p.shape, generator=torch.Generator()
                                            .manual_seed(p.numel())) * 40).to(p.dtype), params)
    state = opt.update_(grads, state, params)
    return params, state


def test_bf16_checkpoint_round_trips_bit_for_bit(tmp_path):
    params, state = _bf16_state()
    t_ckpt.save_checkpoint(str(tmp_path), 5, (params, state))
    like = (tree_map(torch.zeros_like, params),
            (state[0], {"m": tree_map(torch.zeros_like, state[1]["m"]),
                        "v": tree_map(torch.zeros_like, state[1]["v"]), "step": 0}))
    (p2, s2), step = t_ckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 5 and s2[1]["step"] == state[1]["step"] == 1
    for a, b in zip(tree_leaves((p2, s2)), tree_leaves((params, state))):
        assert torch.is_tensor(a) == torch.is_tensor(b)
        if torch.is_tensor(b):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
        else:
            assert a == b
    # the reference reads it into its own bfloat16 tree, bit for bit
    r_like = jax.tree.map(jnp.asarray, to_numpy_tree(_np_tree(1)))
    (rp, _), _ = r_ckpt.restore_checkpoint(str(tmp_path), (r_like, ((), {
        "m": jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), r_like),
        "v": jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), r_like),
        "step": jnp.zeros((), jnp.int32)})))
    for a, b in zip(jax.tree.leaves(rp), tree_leaves(params)):
        assert str(a.dtype) == str(b.dtype)[6:]
        if b.dtype == BF:
            np.testing.assert_array_equal(np.asarray(a).view(np.int16),
                                          b.view(torch.int16).numpy())


def test_bf16_train_resume_matches_straight_run(tmp_path):
    args = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "8", "--seed", "3"]
    bf16 = lambda c: dataclasses.replace(c, param_dtype=BF, compute_dtype=BF)
    straight = t_train.run(args + ["--steps", "4"], cfg_fn=bf16)
    assert all(p.dtype == BF for p in tree_leaves(straight["params"]))
    d = str(tmp_path / "ck")
    first = t_train.run(args + ["--steps", "2", "--ckpt-dir", d], cfg_fn=bf16)
    resumed = t_train.run(args + ["--steps", "4", "--ckpt-dir", d, "--resume", "auto"],
                          cfg_fn=bf16)
    assert resumed["start"] == 2
    assert first["losses"] + resumed["losses"] == straight["losses"]
    for a, b in zip(tree_leaves(resumed["params"]), tree_leaves(straight["params"])):
        assert a.dtype == b.dtype == BF and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("n_steps", [1, 3])
def test_bf16_clip_adamw_matches_reference(n_steps):
    params_np = _np_tree(2)
    grads_np = [_np_tree(10 + s, scale=40.0) for s in range(n_steps)]
    r_opt = r_optim.chain(r_optim.clip_by_global_norm(MAX_NORM), r_optim.adamw(LR))
    rp = jax.tree.map(jnp.asarray, params_np)
    rs = r_opt.init(rp)
    step = jax.jit(lambda g, s, p: r_opt.update(g, s, p))
    for g in grads_np:
        gj = jax.tree.map(jnp.asarray, g)
        assert float(r_optimizers.global_norm(gj)) > 10 * MAX_NORM     # clip active
        upd, rs = step(gj, rs, rp)
        rp = r_optim.apply_updates(rp, upd)

    t_opt = t_optim.chain(t_optim.clip_by_global_norm(MAX_NORM), t_optim.adamw(LR))
    tp = from_reference(params_np)
    ts = t_opt.init(tp)
    for g in grads_np:
        ts = t_opt.update_(from_reference(g), ts, tp)
    assert ts[1]["step"] == n_steps
    for name in ("m", "v"):
        for a, b in zip(tree_leaves(ts[1][name]), jax.tree.leaves(rs[1][name])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(rp)):
        assert str(a.dtype)[6:] == str(b.dtype)
        got, want = to_reference(a), np.asarray(b, np.float32)
        ulp = np.abs(want) * 2.0 ** -7 if a.dtype == BF else np.abs(want) * 1e-6
        assert np.all(np.abs(got - want) <= ulp + 1e-30), np.abs(got - want).max()
