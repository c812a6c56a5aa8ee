"""gemma-2b (port of repro.configs.gemma_2b): 18 layers, d_model 2048, 8
query heads over one kv head (MQA) of 256, d_ff 16384 GeGLU, vocab 256000,
embeddings scaled by sqrt(d_model) and tied to the head [arXiv:2403.08295].

Widths, depth, ``kv_repeat=8`` (the kernels see 8 kv heads, one copy per
query head), the attention chunks, the dropout plan (NR p=0.25, block 128)
and the dtypes (bfloat16 parameters and compute) are the reference's, and
so is ``attn_impl="xla"``; ``attn_impl="flash"`` (``dataclasses.replace``)
runs K9-K11, at head_dim 256 on their ``"tf32"`` route.
"""
import torch

from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.sdrop import DropoutSpec
from repro_torch.models.transformer import TransformerConfig


def full(**kw):
    d = dict(
        name="gemma-2b", num_layers=18, d_model=2048, n_heads=8,
        n_kv_heads=1, head_dim=256, d_ff=16384, vocab=256000,
        mlp="geglu", scale_embed=True, tie_embeddings=True, max_seq=1 << 20,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        kv_repeat=8, q_chunk=1024, kv_chunk=1024,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=128)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


def smoke(**kw):
    d = dict(
        name="gemma-smoke", num_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=128, vocab=128, mlp="geglu",
        scale_embed=True, tie_embeddings=True, kv_repeat=4,
        q_chunk=8, kv_chunk=8, max_seq=64,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=8)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


SPEC = ArchSpec(name="gemma-2b", family="dense", kind="transformer", full=full,
                smoke=smoke, skip_shapes={"long_500k": FULL_ATTN_SKIP})
