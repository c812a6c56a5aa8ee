"""qwen3-8b (port of repro.configs.qwen3_8b): 36 layers, d_model 4096, 32
query heads over 8 kv heads of 128, d_ff 12288, vocab 151936, qk-norm,
rope theta 1e6, untied head [hf:Qwen/Qwen3-8B].

Widths, depth, ``kv_repeat=2`` (the kernels see 16 kv heads), the attention
chunks and the dropout plan (NR p=0.25, block 128) are the reference's, and
so is the default ``attn_impl="xla"``; ``attn_impl="flash"`` (set with
``dataclasses.replace``, as the reference's ``qwen3_flash`` experiment)
runs the flash-attention kernels. The dtypes are the reference's:
bfloat16 parameters and compute (float32 logits, loss and optimizer
moments); ``full(param_dtype=torch.float32, compute_dtype=torch.float32)``
gives the float32 model.
"""
import torch

from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.sdrop import DropoutSpec
from repro_torch.models.transformer import TransformerConfig


def full(**kw):
    d = dict(
        name="qwen3-8b", num_layers=36, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=12288, vocab=151936,
        qk_norm=True, mlp="swiglu", rope_theta=1e6, max_seq=1 << 20,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        kv_repeat=2, q_chunk=1024, kv_chunk=1024,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=128)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


def smoke(**kw):
    d = dict(
        name="qwen3-smoke", num_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128, qk_norm=True,
        q_chunk=8, kv_chunk=8, max_seq=64,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=8)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


SPEC = ArchSpec(name="qwen3-8b", family="dense", kind="transformer", full=full,
                smoke=smoke, skip_shapes={"long_500k": FULL_ATTN_SKIP})
