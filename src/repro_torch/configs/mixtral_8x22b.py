"""mixtral-8x22b (port of repro.configs.mixtral_8x22b): 56 layers, d_model
6144, 48 query heads over 8 kv heads of 128, d_ff 16384 per expert, vocab
32768, 8 experts top-2 (capacity factor 1.25), sliding window 4096, rope
theta 1e6 [arXiv:2401.04088].

Widths, depth, experts, window, ``kv_repeat=2`` (the attention kernels see
16 kv heads, a group of 3 query heads each), the attention chunks and the
dropout plan (NR p=0.25, block 128) are the reference's, and so are the
dtypes: bfloat16 parameters and compute (float32 router, logits, loss and
optimizer moments); ``full(param_dtype=torch.float32,
compute_dtype=torch.float32)`` gives the float32 model.
``moe_impl="pallas"`` (set with ``dataclasses.replace``) runs the expert
products on K12, ``attn_impl="flash"`` the attention on K9-K11.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.sdrop import DropoutSpec
from repro_torch.models.transformer import MoEConfig, TransformerConfig


def full(**kw):
    d = dict(
        name="mixtral-8x22b", num_layers=56, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=16384, vocab=32768,
        moe=MoEConfig(num_experts=8, top_k=2), window=4096,
        mlp="swiglu", rope_theta=1e6, max_seq=1 << 20,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        kv_repeat=2, q_chunk=1024, kv_chunk=1024,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=128)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


def smoke(**kw):
    d = dict(
        name="mixtral-smoke", num_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128,
        moe=MoEConfig(num_experts=4, top_k=2), window=8,
        q_chunk=8, kv_chunk=8, max_seq=64,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=8)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


SPEC = ArchSpec(name="mixtral-8x22b", family="moe", kind="transformer",
                full=full, smoke=smoke)
