"""Uniform model API over arch kinds (port of the lstm_lm, nmt, tagger, xlstm
and dense transformer parts of repro.configs.adapters): ``loss_fn``,
``init_params``, the ``--dropout`` / ``--engine`` overrides, and the serving
half (``init_decode_state``, ``decode_fn``, ``has_native_prefill``,
``prefill_fn``) for the kinds transformer, xlstm and nmt.

Serving runs on one device: the decode state is made on ``device`` and the
model functions run where their tensors are. Every decode-state leaf is
``(L, B, ...)`` with the slot axis at 1, and ``decode_fn`` / ``prefill_fn``
update the state in place (they return it too)."""
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


def unused_in_loss(kind: str, cfg) -> tuple:
    """The top-level parameter subtrees the training loss may not read."""
    return getattr(_MODULES[kind], "unused_in_loss", lambda cfg: ())(cfg)


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


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

SERVING_KINDS = ("transformer", "xlstm", "nmt")


def _serving(spec: ArchSpec):
    if spec.kind == "ssm":
        raise NotImplementedError("ssm serving is not ported (ROADMAP A11)")
    if spec.kind not in SERVING_KINDS:
        raise ValueError(f"{spec.kind} has no decode path")
    return _MODULES[spec.kind]


def init_decode_state(spec: ArchSpec, cfg, batch: int, max_seq: int, *,
                      device="cpu"):
    """Fresh decode state on ``device``: the transformer's KV cache over
    ``max_seq`` positions, xlstm's recurrent state, or the NMT state with
    ``max_seq`` encoder-memory positions."""
    mod = _serving(spec)
    if spec.kind == "transformer":
        return mod.init_cache(cfg, batch, max_seq, device=device)
    if spec.kind == "xlstm":
        return mod.init_state(cfg, batch, device=device)
    return mod.init_state(cfg, batch, max_src=max_seq, device=device)


def decode_fn(spec: ArchSpec):
    """(params, cfg, state, tokens (B, 1), pos) -> (logits (B, 1, V), state)."""
    return _serving(spec).decode_step


def has_native_prefill(spec: ArchSpec) -> bool:
    """True where ``prefill_fn`` fills the decode state in one rectangular
    pass: every serving kind of the port (the reference's ssm, whose
    forward emits no state, is not ported)."""
    _serving(spec)
    return True


def prefill_fn(spec: ArchSpec):
    """(params, batch, cfg, state) -> (features or None, state): xlstm reads
    ``batch["tokens"]``, the transformer ``batch["tokens"]`` or, with
    ``embeds_in``, ``batch["embeds"]`` (B, S, D), and an encoder-decoder
    also encodes ``batch["frames"]`` (B, enc_seq, D) into its cross K/V;
    NMT takes an encoder batch {"src", "tgt_in", ["src_mask"]}."""
    mod = _serving(spec)
    if spec.kind == "nmt":
        return mod.prefill
    if spec.kind == "xlstm":
        return lambda params, batch, cfg, state: mod.prefill(
            params, batch["tokens"], cfg, state)

    def f(params, batch, cfg, state):
        memory = (mod.encode(params, batch["frames"], cfg)
                  if cfg.is_encoder_decoder else None)
        inputs = batch["embeds"] if cfg.embeds_in else batch["tokens"]
        return mod.prefill(params, inputs, cfg, state, memory=memory)
    return f
