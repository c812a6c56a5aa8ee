"""ArchSpec: a uniform handle over every selectable architecture (port of
repro.configs.base): a (full, smoke) config factory pair plus metadata."""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio | rnn
    kind: str                     # lstm_lm | nmt | tagger | xlstm | transformer
    full: Callable[..., object]   # full-size config factory (kw overrides ok)
    smoke: Callable[..., object]  # reduced CPU-runnable config factory
