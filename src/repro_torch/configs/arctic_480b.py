"""arctic-480b (port of repro.configs.arctic_480b): 35 layers, d_model
7168, 56 query heads over 8 kv heads of 128, a mixture of 128 experts
(d_ff 4864, top-2) beside a dense-residual SwiGLU FFN of 4864, vocab 32000
[hf:Snowflake/snowflake-arctic-base].

Widths, depth, experts, the attention chunks, the dropout plan (NR p=0.25,
block 128) and the dtypes (bfloat16) are the reference's. The full model
does not fit one card: one layer holds 128 x 3 x 7168 x 4864 = 13.4e9
expert parameters, ~160 GB at 12 B a parameter in training (bfloat16
weights and gradients, float32 moments), so it waits for expert
parallelism across cards; the smoke config runs on the CPU.
"""
import torch

from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.sdrop import DropoutSpec
from repro_torch.models.transformer import MoEConfig, TransformerConfig


def full(**kw):
    d = dict(
        name="arctic-480b", num_layers=35, d_model=7168, n_heads=56,
        n_kv_heads=8, head_dim=128, d_ff=4864, vocab=32000,
        moe=MoEConfig(num_experts=128, top_k=2, dense_ff=4864),
        mlp="swiglu", max_seq=1 << 20,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        kv_repeat=1, q_chunk=1024, kv_chunk=1024,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=128)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


def smoke(**kw):
    d = dict(
        name="arctic-smoke", num_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab=128,
        moe=MoEConfig(num_experts=8, top_k=2, dense_ff=96),
        q_chunk=8, kv_chunk=8, max_seq=64,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=8)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


SPEC = ArchSpec(
    name="arctic-480b", family="moe", kind="transformer", full=full,
    smoke=smoke, skip_shapes={"long_500k": FULL_ATTN_SKIP})
