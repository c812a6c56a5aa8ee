"""Uniform model API over arch kinds (port of the lstm_lm, nmt, tagger, xlstm
and dense transformer parts of repro.configs.adapters): ``loss_fn``, ``init_params``, and the
``--dropout`` / ``--engine`` overrides."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchSpec
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.core.lstm import ENGINES
from repro_torch.models import lstm_lm, seq2seq, tagger, transformer, xlstm

_MODULES = {"lstm_lm": lstm_lm, "nmt": seq2seq, "tagger": tagger,
            "xlstm": xlstm, "transformer": transformer}

# Canonical application sites per kind: what ``case3:0.5:bs128`` turns on.
DROPOUT_SITES = {"lstm_lm": ("embed", "nr", "rh", "out"),
                 "nmt": ("nr", "rh", "out"),
                 "tagger": ("inp", "rh"),
                 "xlstm": ("nr", "rh"),
                 "transformer": ("nr",)}

# Kinds with a time-recurrent scan the engine knob applies to.
ENGINE_KINDS = ("lstm_lm", "nmt", "tagger", "xlstm")


def init_params(kind: str, generator, cfg, *, device="cpu"):
    return _MODULES[kind].init_params(generator, cfg, device=device)


def loss_fn(kind: str):
    return _MODULES[kind].loss_fn


def dropout_override(kind: str, text: str) -> DropoutPlan:
    return DropoutPlan.parse(text, sites=DROPOUT_SITES[kind])


def apply_dropout(spec: ArchSpec, cfg, text: str):
    """cfg with its plan replaced by the parsed CLI override."""
    if not text:
        return cfg
    return dataclasses.replace(cfg, plan=dropout_override(spec.kind, text))


def apply_engine(spec: ArchSpec, cfg, text: str):
    """cfg with its recurrent engine replaced by the CLI override."""
    if not text:
        return cfg
    if text not in ENGINES:
        raise ValueError(f"unknown engine {text!r}; expected one of {ENGINES}")
    if spec.kind not in ENGINE_KINDS:
        return cfg
    return dataclasses.replace(cfg, engine=text)
