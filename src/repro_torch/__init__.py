"""PyTorch/CUDA port of ``repro`` for the NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``models/``, ``configs/``, ``optim/``, ``data/``,
``checkpoint/``, ``launch/``) and its parameter pytrees leaf for leaf, so that each module's
counterpart is easy to find and parameters convert one to one
(``repro_torch.convert``).

Every Pallas kernel on a ported path is a hand-written CUDA C++ kernel for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(``kernels/_build.py``) and bound with ``ctypes``. Each wrapper launches its
kernel for a CUDA tensor and runs its plain-PyTorch version for a CPU
tensor, which is what the CPU tests exercise.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
GPU and no such request they raise (``repro_torch.device.resolve_device``).
"""
