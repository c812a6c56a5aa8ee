"""Architecture registry: ``--arch <id>`` -> ArchSpec (the paper's LSTM LMs
and the Luong NMT model in the port so far)."""
from __future__ import annotations

from repro_torch.configs import paper_models
from repro_torch.configs.base import ArchSpec

REGISTRY = {s.name: s for s in paper_models.PAPER_SPECS}


def get_arch(name: str) -> ArchSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
