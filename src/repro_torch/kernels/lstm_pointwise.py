"""Fused LSTM cell update (K5) on a hand-written kernel.

Port of ``repro.kernels.lstm_pointwise``: gates ``(B, 4H)`` in the order
``[i | f | g | o]`` and ``c_prev (B, H)`` give, in float32,

    c' = sigmoid(f + forget_bias) * c_prev + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

returned as ``(h', c')`` in gates' dtype. A CUDA tensor launches
``csrc/lstm_pointwise.cu`` (float32 or bfloat16, any B and H) and bumps
``LAUNCHES``; a CPU tensor runs ``lstm_pointwise_plain``.

Forward only, as the reference: its Pallas kernel has no reverse mode
(``jax.grad`` through it fails to linearize), so the stepwise and scheduled
engines reach it only where nothing is differentiated. A call while
autograd would need its gradient raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

LAUNCHES = {"lstm_pointwise": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lstm_pointwise_plain(gates: torch.Tensor, c_prev: torch.Tensor, *,
                         forget_bias: float = 0.0):
    """K5's plain version (the reference's ``lstm_pointwise_ref``)."""
    i, f, g, o = gates.float().chunk(4, dim=-1)
    c = torch.sigmoid(f + forget_bias) * c_prev.float() + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h.to(gates.dtype), c.to(gates.dtype)


def _lib():
    lib = _build.load("lstm_pointwise")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_pointwise_launch.argtypes = [i, p, p, p, p, i, i, ctypes.c_longlong,
                                              ctypes.c_float, p]
        lib.lstm_pointwise_launch.restype = i
        lib._typed = True
    return lib


def lstm_pointwise_cuda(gates: torch.Tensor, c_prev: torch.Tensor, *,
                        forget_bias: float = 0.0):
    """K5 on CUDA tensors: (h', c') in gates' dtype."""
    if gates.dtype not in _DTYPES or c_prev.dtype != gates.dtype:
        raise TypeError(f"K5 takes float32 or bfloat16 gates and c_prev of the "
                        f"same dtype, got {gates.dtype} and {c_prev.dtype}")
    if gates.stride(-1) != 1:
        gates = gates.contiguous()
    c_prev = c_prev.contiguous()
    B, H = c_prev.shape
    h = torch.empty((B, H), dtype=gates.dtype, device=gates.device)
    c = torch.empty((B, H), dtype=gates.dtype, device=gates.device)
    lib = _lib()
    code = lib.lstm_pointwise_launch(
        _DTYPES[gates.dtype], gates.data_ptr(), c_prev.data_ptr(), h.data_ptr(),
        c.data_ptr(), B, H, gates.stride(0), float(forget_bias),
        torch.cuda.current_stream(gates.device).cuda_stream)
    _build.check(lib, code, "lstm_pointwise")
    LAUNCHES["lstm_pointwise"] += 1
    return h, c


def lstm_pointwise(gates: torch.Tensor, c_prev: torch.Tensor, *,
                   forget_bias: float = 0.0, bm: Optional[int] = None,
                   bh: Optional[int] = None):
    """gates (B, 4H), c_prev (B, H) -> (h', c') each (B, H).

    ``bm``/``bh`` are the reference's VMEM tile sizes, accepted and unused
    (the kernel takes any B and H, so nothing is padded)."""
    del bm, bh
    if gates.dim() != 2 or gates.shape[1] % 4 or tuple(c_prev.shape) != (
            gates.shape[0], gates.shape[1] // 4):
        raise ValueError(f"gates {tuple(gates.shape)} and c_prev "
                         f"{tuple(c_prev.shape)}: expected (B, 4H) and (B, H)")
    if gates.device != c_prev.device:
        raise ValueError(f"gates on {gates.device}, c_prev on {c_prev.device}")
    if torch.is_grad_enabled() and (gates.requires_grad or c_prev.requires_grad):
        raise RuntimeError(
            "lstm_pointwise (K5) is forward-only: the reference's Pallas kernel "
            "(repro/kernels/lstm_pointwise.py) has no reverse mode either. Run "
            "it under torch.no_grad(), or use pointwise_impl='xla' to train.")
    if gates.device.type == "cpu":
        return lstm_pointwise_plain(gates, c_prev, forget_bias=forget_bias)
    if gates.device.type != "cuda":
        raise ValueError(f"unsupported device {gates.device}")
    return lstm_pointwise_cuda(gates, c_prev, forget_bias=forget_bias)
