"""The port's in-place optimizer step (``Optimizer.update_``, which
``launch.steps.make_train_step`` runs) against the out-of-place AdamW and
global-norm clip arithmetic, written out here: the same float32 operations
in the same order, so the parameters and moments must be equal bit for
bit, over three steps of a random tree with clipping active and weight
decay on and off. (Its parity with the JAX reference is
tests/test_torch_engines.py::test_adamw_chain_matches_reference and
tests/test_torch_xlstm.py::test_train_step_update_matches_reference.)
"""
import numpy as np
import pytest
import torch

from repro_torch.optim import (adamw, chain, clip_by_global_norm, tree_leaves,
                               tree_map)

torch.set_num_threads(1)

LR, B1, B2, EPS, MAX_NORM = 1e-2, 0.9, 0.999, 1e-8, 1.0


def _tree(seed):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return {"a": t(5, 7), "blocks": [{"w": t(3, 4, 6), "b": t(6)}, {"w": t(2, 2)}],
            "z": (t(9),)}


def _grads(step):
    # large entries, so the global norm is far above MAX_NORM: clipping on
    return tree_map(lambda x: x * 40.0, _tree(100 + step))


def _written_out(params, grads_seq, weight_decay):
    """Out-of-place clip + AdamW, as the port computed it before the update
    went in place."""
    m = tree_map(torch.zeros_like, params)
    v = tree_map(torch.zeros_like, params)
    for step, grads in enumerate(grads_seq, start=1):
        g = torch.sqrt(sum(torch.sum(torch.square(x.float()))
                           for x in tree_leaves(grads)))
        scale = torch.clamp(MAX_NORM / torch.clamp(g, min=1e-12), max=1.0)
        assert float(scale) < 1.0
        grads = tree_map(lambda x: x * scale, grads)
        m = tree_map(lambda m, g: B1 * m + (1 - B1) * g.float(), m, grads)
        v = tree_map(lambda v, g: B2 * v + (1 - B2) * torch.square(g.float()),
                     v, grads)
        c1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(step))
        c2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(step))
        upd = tree_map(lambda m, v, p: -LR * ((m / c1) / (torch.sqrt(v / c2) + EPS)
                                               + weight_decay * p.float()),
                       m, v, params)
        params = tree_map(lambda p, u: p + u.to(p.dtype), params, upd)
    return params, m, v


def _opt(weight_decay):
    return chain(clip_by_global_norm(MAX_NORM),
                 adamw(LR, B1, B2, EPS, weight_decay=weight_decay))


def _bitwise_equal(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_in_place_step_is_bitwise_the_out_of_place_arithmetic(weight_decay):
    grads_seq = [_grads(s) for s in range(3)]
    want_p, want_m, want_v = _written_out(_tree(0), grads_seq, weight_decay)
    opt = _opt(weight_decay)
    params = _tree(0)
    state = opt.init(params)
    leaves = tree_leaves(params)
    for grads in grads_seq:
        state = opt.update_(tree_map(torch.clone, grads), state, params)
    assert all(a is b for a, b in zip(tree_leaves(params), leaves))   # in place
    assert state[1]["step"] == 3
    _bitwise_equal(params, want_p)
    _bitwise_equal(state[1]["m"], want_m)
    _bitwise_equal(state[1]["v"], want_v)


def test_train_step_updates_in_place():
    """``make_train_step`` returns the tensors it was given, updated."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.launch import steps
    spec = configs.get_arch("zaremba-medium")
    cfg = spec.smoke()
    params = adapters.init_params(spec.kind, torch.Generator().manual_seed(0), cfg)
    opt = steps.default_opt(1e-3)
    state = opt.init(params)
    first = [p.clone() for p in tree_leaves(params)]
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 5), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 5), generator=g)}
    new_params, new_state, loss = steps.make_train_step(spec, cfg, opt)(
        params, state, batch, 0, 0)
    assert new_params is params and np.isfinite(float(loss))
    assert all(a is b for a, b in zip(tree_leaves(new_state[1]["m"]),
                                      tree_leaves(state[1]["m"])))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(params), first))
