"""arctic-480b (a mixture of experts beside a dense-residual FFN) at smoke
size in the port against the JAX reference: the features, loss and every
gradient with ``attn_impl`` "xla" and "flash", ``remat="dots"`` and one
bfloat16 step against float64. The checks, their inputs and their
tolerances are tests/test_torch_transformer_configs.py's (see its
docstring); this file holds arctic, so that the test workers take the
configs in parallel. The full model (~160 GB of training state a layer)
waits for expert parallelism across cards.
"""
import pytest
import torch

pytest.importorskip("jax")

from test_torch_transformer_configs import (  # noqa: E402
    test_bf16_step_against_float64 as _bf16_step,
    test_features_match_reference as _features,
    test_loss_and_grads_match_reference as _loss_and_grads,
    test_remat_dots_matches_full_and_reference as _remat_dots)

torch.set_num_threads(1)

ARCH = "arctic-480b"


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_features_match_reference(attn_impl):
    _features(ARCH, attn_impl)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_loss_and_grads_match_reference(attn_impl):
    _loss_and_grads(ARCH, attn_impl)


def test_remat_dots_matches_full_and_reference():
    _remat_dots(ARCH)


def test_bf16_step_against_float64():
    _bf16_step(ARCH)
