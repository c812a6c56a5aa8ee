"""ArchSpec: a uniform handle over every selectable architecture (port of
repro.configs.base): a (full, smoke) config factory pair plus metadata and
the shapes (``configs/shapes.py``) an arch skips, with the reason."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio | rnn
    kind: str                     # lstm_lm | nmt | tagger | xlstm | transformer
    full: Callable[..., object]   # full-size config factory (kw overrides ok)
    smoke: Callable[..., object]  # reduced CPU-runnable config factory
    # shapes this arch skips entirely, with the reason
    skip_shapes: dict = dataclasses.field(default_factory=dict)

    def applicable(self, shape_name: str) -> Optional[str]:
        """None if runnable; else the documented skip reason."""
        return self.skip_shapes.get(shape_name)


FULL_ATTN_SKIP = ("full quadratic attention; 500k dense-KV decode is out of "
                  "scope for pure full-attention archs (DESIGN §Arch-applicability)")
