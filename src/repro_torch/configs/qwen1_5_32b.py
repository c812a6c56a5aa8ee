"""qwen1.5-32b (port of repro.configs.qwen1_5_32b): 64 layers, d_model
5120, 40 heads (MHA, 40 kv heads) of 128, d_ff 27392 SwiGLU, vocab 152064,
QKV bias, untied head [hf:Qwen/Qwen1.5 family].

Widths, depth, the attention chunks, the dropout plan (NR p=0.25, block
128) and the dtypes (bfloat16) are the reference's; ``attn_impl="flash"``
(``dataclasses.replace``) runs K9-K11.
"""
import torch

from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.sdrop import DropoutSpec
from repro_torch.models.transformer import TransformerConfig


def full(**kw):
    d = dict(
        name="qwen1.5-32b", num_layers=64, d_model=5120, n_heads=40,
        n_kv_heads=40, head_dim=128, d_ff=27392, vocab=152064,
        qkv_bias=True, mlp="swiglu", max_seq=1 << 20,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        q_chunk=1024, kv_chunk=1024,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=128)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


def smoke(**kw):
    d = dict(
        name="qwen1.5-smoke", num_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab=128, qkv_bias=True,
        q_chunk=8, kv_chunk=8, max_seq=64,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=8)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


SPEC = ArchSpec(
    name="qwen1.5-32b", family="dense", kind="transformer", full=full,
    smoke=smoke, skip_shapes={"long_500k": FULL_ATTN_SKIP})
