"""whisper-base (port of repro.configs.whisper_base): an encoder-decoder of
6 + 6 layers, d_model 512, 8 heads (MHA) of 64, d_ff 2048 GELU MLP, vocab
51865, LayerNorm, sinusoidal positions [arXiv:2212.04356]. The conv audio
frontend is a stub, as in the reference: the encoder takes precomputed
(B, 1500, 512) frame embeddings (``enc_seq``).

Widths, depth, the attention chunks, the dropout plan (NR p=0.25, block
64, on the decoder's ``attn/nr`` / ``mlp/nr`` and the encoder's
``enc/attn/nr`` / ``enc/mlp/nr``) and the dtypes (bfloat16) are the
reference's; ``attn_impl="flash"`` (``dataclasses.replace``) runs K9-K11 on
the self-attention of both stacks (non-causal in the encoder), while the
decoder's cross-attention stays the chunked attention in plain PyTorch,
as the reference's.
"""
import torch

from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.sdrop import DropoutSpec
from repro_torch.models.transformer import TransformerConfig


def full(**kw):
    d = dict(
        name="whisper-base", num_layers=6, enc_layers=6, d_model=512,
        n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865,
        is_encoder_decoder=True, enc_seq=1500, norm="layernorm",
        pos="sinusoidal", mlp="gelu_mlp", max_seq=1 << 20,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        kv_repeat=1, q_chunk=1024, kv_chunk=1024,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=64)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


def smoke(**kw):
    d = dict(
        name="whisper-smoke", num_layers=2, enc_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
        is_encoder_decoder=True, enc_seq=12, norm="layernorm",
        pos="sinusoidal", mlp="gelu_mlp", q_chunk=8, kv_chunk=8, max_seq=64,
        plan=DropoutPlan({"nr": DropoutSpec(rate=0.25, block_size=8)}),
    )
    d.update(kw)
    return TransformerConfig(**d)


SPEC = ArchSpec(
    name="whisper-base", family="audio", kind="transformer", full=full,
    smoke=smoke, skip_shapes={"long_500k": FULL_ATTN_SKIP})
