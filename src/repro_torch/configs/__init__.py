"""Architecture registry: ``--arch <id>`` -> ArchSpec (the paper's LSTM LMs,
the Luong NMT model, the BiLSTM-CNN-CRF tagger, xlstm-1.3b, qwen3-8b and
mixtral-8x22b in the port so far)."""
from __future__ import annotations

from repro_torch.configs import mixtral_8x22b, paper_models, qwen3_8b, xlstm_1_3b
from repro_torch.configs.base import ArchSpec

REGISTRY = {s.name: s for s in [*paper_models.PAPER_SPECS, xlstm_1_3b.SPEC,
                                qwen3_8b.SPEC, mixtral_8x22b.SPEC]}


def get_arch(name: str) -> ArchSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
