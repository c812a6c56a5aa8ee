"""Serving (port of repro.serving): the continuous-batching server core.

scheduler (admission / eviction) -> decode engine (chunks of decode steps,
one captured CUDA graph per chunk length on the card) -> shared prompt
prefill (native or masked replay). One device; the reference's mesh
sharding of the engine state is not ported (ROADMAP A10).
"""
from repro_torch.serving.engine import DecodeEngine, sample_logits
from repro_torch.serving.prefill import prompt_prefill, replay_prefill
from repro_torch.serving.scheduler import Request, Scheduler, serve
