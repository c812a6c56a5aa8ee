"""xlstm-1.3b (port of repro.configs.xlstm_1_3b): 48 blocks, d_model 2048,
4 heads, vocab 50304, every 8th block an sLSTM [arXiv:2405.04517]. The
architecture closest to the paper: sLSTM blocks carry a true h -> h
recurrence, so RH structured dropout applies directly.

Widths, depth, the dropout plan and the dtypes are the reference's:
bfloat16 parameters and compute, float32 recurrent states and optimizer
moments. ``full(param_dtype=torch.float32, compute_dtype=torch.float32)``
gives the float32 model.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.sdrop import DropoutSpec
from repro_torch.models.xlstm import XLSTMConfig


def full(**kw):
    d = dict(
        name="xlstm-1.3b", num_layers=48, d_model=2048, n_heads=4,
        vocab=50304, proj_factor=2.0, slstm_every=8, conv_kernel=4,
        chunk=256, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=128),
                          "rh": DropoutSpec(rate=0.25, block_size=64)}),
    )
    d.update(kw)
    return XLSTMConfig(**d)


def smoke(**kw):
    d = dict(
        name="xlstm-smoke", num_layers=8, d_model=64, n_heads=4, vocab=128,
        proj_factor=2.0, slstm_every=4, chunk=8,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=8),
                          "rh": DropoutSpec(rate=0.5, block_size=1)}),
    )
    d.update(kw)
    return XLSTMConfig(**d)


SPEC = ArchSpec(name="xlstm-1.3b", family="ssm", kind="xlstm", full=full,
                smoke=smoke)
