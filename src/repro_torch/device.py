"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU; a missing GPU is
an error, never a silent fallback. Float32 matrix products and convolutions
are pinned to full float32 (no TF32), so results on the card compare with
the CPU and with the JAX reference at float32 tolerances. bfloat16 products
accumulate in float32, as the reference asks of every one
(``preferred_element_type=jnp.float32``): cuBLAS may otherwise reduce a
bfloat16 GEMM's split-K partial sums in bfloat16.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def set_full_fp32() -> None:
    """Disable TF32 for float32 matmuls and cuDNN convolutions, and reduced-
    precision reductions in bfloat16 GEMMs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None``/"cuda" -> the current CUDA device (raises without a GPU);
    "cpu" -> the CPU, on explicit request only."""
    set_full_fp32()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (--device cpu) to "
            "run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
