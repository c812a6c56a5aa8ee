"""Structured-dropout primitives: ``DropoutSpec`` and ``DropoutState``.

Mirrors ``repro.core.sdrop``. A ``DropoutSpec`` selects one of the paper's
four cases plus the block granularity and the implementation (``"pallas"``
= the hand-written CUDA kernels, ``"xla"`` = plain PyTorch; the names are
the reference's, so plan strings and dicts round-trip unchanged). A
``DropoutState`` is one application's materialized decision: structured
cases carry kept-block ids (compute is reclaimed by core/sparse_matmul.py),
random cases a dense mask. Models draw states from a ``DropoutCtx``
(core/dropout_plan.py), never from ``make_state`` directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import masks
from repro_torch.core.masks import BatchPattern, TimePattern


@dataclasses.dataclass(frozen=True)
class DropoutSpec:
    rate: float = 0.0
    batch_pattern: BatchPattern = BatchPattern.STRUCTURED
    time_pattern: TimePattern = TimePattern.PER_STEP
    block_size: int = 1
    impl: str = "xla"                  # "xla" (plain torch) | "pallas" (CUDA)

    @property
    def structured(self) -> bool:
        return self.batch_pattern == BatchPattern.STRUCTURED and self.rate > 0.0

    @property
    def active(self) -> bool:
        return self.rate > 0.0

    def with_(self, **kw) -> "DropoutSpec":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def case(name: str, rate: float, block_size: int = 1,
             impl: str = "xla") -> "DropoutSpec":
        bp, tp = masks.CASES[name]
        return DropoutSpec(rate=rate, batch_pattern=bp, time_pattern=tp,
                           block_size=block_size, impl=impl)

    def to_dict(self) -> dict:
        return {"rate": self.rate, "batch_pattern": self.batch_pattern.value,
                "time_pattern": self.time_pattern.value,
                "block_size": self.block_size, "impl": self.impl}

    @staticmethod
    def from_dict(d: dict) -> "DropoutSpec":
        return DropoutSpec(rate=float(d["rate"]),
                           batch_pattern=BatchPattern(d["batch_pattern"]),
                           time_pattern=TimePattern(d["time_pattern"]),
                           block_size=int(d.get("block_size", 1)),
                           impl=d.get("impl", "xla"))


def scale_as(scale: float, dtype: torch.dtype) -> float:
    """The inverted-dropout scale as the reference applies it to a tensor of
    ``dtype``: ``jnp.asarray(scale, dtype)``, rounded to that dtype (in
    bfloat16, 4/3 is 1.3359375). For float32 the same bits as multiplying
    by the Python float."""
    return float(torch.tensor(scale, dtype=dtype))


@dataclasses.dataclass
class DropoutState:
    """Materialized dropout decision for one application point.

    Exactly one of ``keep_blocks`` (sorted kept-block ids) / ``dense_mask``
    ((*batch, hidden) 0/1) is set when active.
    """
    spec: DropoutSpec
    keep_blocks: Optional[torch.Tensor] = None
    dense_mask: Optional[torch.Tensor] = None
    scale: float = 1.0

    @property
    def structured(self) -> bool:
        return self.keep_blocks is not None

    @property
    def inactive(self) -> bool:
        return self.keep_blocks is None and self.dense_mask is None

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Mask-multiply (no compute reclamation) for elementwise consumers."""
        if not self.spec.active or self.inactive:
            return x
        if self.structured:
            m = masks.keep_blocks_to_mask(self.keep_blocks, x.shape[-1],
                                          self.spec.block_size)
            return x * m.to(x.dtype) * scale_as(self.scale, x.dtype)
        return x * self.dense_mask.to(x.dtype) * scale_as(self.scale, x.dtype)


def make_state(generator: Optional[torch.Generator], spec: DropoutSpec,
               batch: int, hidden: int, *,
               deterministic: bool = False) -> DropoutState:
    """Sample one application's DropoutState from ``generator``."""
    if deterministic or not spec.active or generator is None:
        return DropoutState(spec=spec)
    if spec.batch_pattern == BatchPattern.STRUCTURED:
        kb = masks.sample_keep_blocks(generator, hidden, spec.rate,
                                      spec.block_size)
        scale = masks.inverted_scale(spec.rate, hidden, spec.block_size)
        return DropoutState(spec=spec, keep_blocks=kb, scale=scale)
    dm = masks.random_mask(generator, batch, hidden, spec.rate)
    return DropoutState(spec=spec, dense_mask=dm, scale=1.0 / (1.0 - spec.rate))
