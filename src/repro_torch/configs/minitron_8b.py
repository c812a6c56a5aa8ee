"""minitron-8b (port of repro.configs.minitron_8b): 32 layers, d_model
4096, 32 query heads over 8 kv heads of 128, d_ff 16384 squared-ReLU MLP,
vocab 256000, untied head; a pruned Nemotron [arXiv:2407.14679].

Widths, depth, ``kv_repeat=2``, the attention chunks, the dropout plan (NR
p=0.25, block 128) and the dtypes (bfloat16) are the reference's;
``attn_impl="flash"`` (``dataclasses.replace``) runs K9-K11.
"""
import torch

from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.sdrop import DropoutSpec
from repro_torch.models.transformer import TransformerConfig


def full(**kw):
    d = dict(
        name="minitron-8b", num_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=16384, vocab=256000,
        mlp="relu2", max_seq=1 << 20,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        kv_repeat=2, q_chunk=1024, kv_chunk=1024,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=128)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


def smoke(**kw):
    d = dict(
        name="minitron-smoke", num_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128, mlp="relu2",
        q_chunk=8, kv_chunk=8, max_seq=64,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=8)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


SPEC = ArchSpec(name="minitron-8b", family="dense", kind="transformer",
                full=full, smoke=smoke, skip_shapes={"long_500k": FULL_ATTN_SKIP})
