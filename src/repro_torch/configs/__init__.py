"""Architecture registry: ``--arch <id>`` -> ArchSpec (port of
repro.configs): the paper's LSTM LMs, the Luong NMT model and the
BiLSTM-CNN-CRF tagger, xlstm-1.3b, and the transformers qwen3-8b,
mixtral-8x22b, arctic-480b, minitron-8b, gemma-2b, qwen1.5-32b,
pixtral-12b and whisper-base. zamba2-1.2b is not ported (ROADMAP A11)."""
from __future__ import annotations

from repro_torch.configs import (arctic_480b, gemma_2b, minitron_8b,
                                 mixtral_8x22b, paper_models, pixtral_12b,
                                 qwen1_5_32b, qwen3_8b, whisper_base,
                                 xlstm_1_3b)
from repro_torch.configs.base import ArchSpec

# the reference's assigned archs that are ported, in its order
ASSIGNED = [
    xlstm_1_3b.SPEC,
    mixtral_8x22b.SPEC,
    arctic_480b.SPEC,
    qwen3_8b.SPEC,
    minitron_8b.SPEC,
    gemma_2b.SPEC,
    qwen1_5_32b.SPEC,
    pixtral_12b.SPEC,
    whisper_base.SPEC,
]

REGISTRY = {s.name: s for s in ASSIGNED + paper_models.PAPER_SPECS}


def get_arch(name: str) -> ArchSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]

