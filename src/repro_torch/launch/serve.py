"""Serving entry point of the port (mirrors repro.launch.serve's CLI):
prefill a prompt batch and decode N tokens, or serve a ragged trace.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
        --smoke --batch 4 --prompt-len 16 --gen 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --batch 8 --prompt-len 512 --gen 64

Runs on the current CUDA device; ``--device cpu`` runs on the CPU. Without
a GPU and without ``--device cpu`` it raises. Parameters are random, drawn
from ``--seed`` by a generator on the device (qwen3-8b's 8.2 B parameters
are not drawn on the host), so a CPU run and a card run differ.

``--loop python`` swaps the chunked decode (one captured CUDA graph a chunk
on the card) for the per-token host loop. ``--trace N`` serves N synthetic
ragged requests through the continuous-batching scheduler instead of one
rectangular batch and reports the tokens per second.

whisper-base and pixtral-12b build their own prefill batch, as the
reference's CLI: pixtral prefills ``prompt-len - 1`` random embeddings and
stops (it decodes from embeddings, not token ids); whisper prefills
``prompt[:, :-1]`` with ``enc_seq`` random frames (x 0.02) through
``DecodeEngine.prefill``, which encodes them into the cross K/V, then
decodes from ``prompt[:, -1:]``; both draw from the prompt's generator,
after the prompt.

luong-nmt's rectangular path has no source sentence: a token prompt cannot
feed its encoder, so it stops with a ``ValueError`` naming the encoder
batch ``DecodeEngine.prefill`` takes (``--trace`` replays the target
prompts through decode steps and works).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs import adapters
from repro_torch.device import resolve_device
from repro_torch.serving import DecodeEngine, Request, prompt_prefill, serve


def ragged_trace(n: int, vocab: int, prompt_max: int, gen_max: int,
                 seed: int):
    """n requests with prompts of 2..prompt_max tokens and budgets of
    max(2, gen_max // 4)..gen_max, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(3, vocab,
                                        int(rng.integers(2, prompt_max + 1))),
                    max_new=int(rng.integers(max(2, gen_max // 4),
                                             gen_max + 1)))
            for i in range(n)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--eos", type=int, default=-1)
    ap.add_argument("--loop", choices=("device", "python"), default="device")
    ap.add_argument("--trace", type=int, default=0,
                    help="serve N ragged requests through the "
                         "continuous-batching scheduler instead of one "
                         "rectangular batch")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Serve and return {"tokens": (B, gen) or {rid: tokens}, "ms": ...}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    spec = configs.get_arch(args.arch)
    cfg = spec.smoke() if args.smoke else spec.full()
    max_seq = args.max_seq or (args.prompt_len + args.gen)
    params = adapters.init_params(
        spec.kind, torch.Generator(device=device).manual_seed(args.seed), cfg,
        device=device)
    vocab = cfg.tgt_vocab if spec.kind == "nmt" else cfg.vocab
    engine = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=max_seq,
                          batch=args.batch, temperature=args.temperature,
                          eos_id=args.eos, chunk=args.chunk)

    if args.trace:
        reqs = ragged_trace(args.trace, vocab, args.prompt_len, args.gen,
                            args.seed)
        t0 = time.perf_counter()
        outs = serve(engine, reqs, chunk=args.chunk)
        dt = time.perf_counter() - t0
        total = sum(len(v) for v in outs.values())
        print(f"continuous trace: {args.trace} requests over {args.batch} "
              f"slots -> {total} tokens in {dt * 1e3:.0f} ms "
              f"({total / max(dt, 1e-9):.1f} tok/s, "
              f"{engine.chunks_run} chunks on {device})")
        return {"tokens": outs, "ms": dt * 1e3, "chunks": engine.chunks_run}

    rng = np.random.default_rng(args.seed)
    prompt = torch.as_tensor(
        rng.integers(3, vocab, size=(args.batch, args.prompt_len)),
        dtype=torch.int32).to(device)
    t0 = time.perf_counter()
    if spec.kind == "transformer" and (cfg.embeds_in or cfg.is_encoder_decoder):
        batch = {"tokens": prompt[:, :-1]}
        if cfg.embeds_in:
            batch = {"embeds": torch.from_numpy(rng.standard_normal(
                (args.batch, args.prompt_len - 1, cfg.d_model))).to(
                    device, cfg.compute_dtype)}
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (args.batch, cfg.enc_seq, cfg.d_model)) * 0.02).to(
                    device, cfg.compute_dtype)
        engine.prefill(batch)
        _sync(device)
        if cfg.embeds_in:
            print(f"prefill {args.prompt_len - 1} embeddings: "
                  f"{(time.perf_counter() - t0) * 1e3:.0f} ms on {device}; "
                  "embeds-in archs decode from embeddings, not token ids: "
                  "no token decode loop to run")
            return {"tokens": None, "ms": ((time.perf_counter() - t0) * 1e3, 0.0)}
        tok0, pos0 = prompt[:, -1:], args.prompt_len - 1
    else:
        engine.state, tok0, pos0 = prompt_prefill(spec, cfg, params, prompt,
                                                  state=engine.state)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = engine.generate if args.loop == "device" else engine.generate_python
    out = gen(tok0, args.gen, seed=args.seed, start_pos=pos0)
    t_decode = time.perf_counter() - t0
    print(f"prefill {args.prompt_len} tok: {t_prefill * 1e3:.0f} ms; "
          f"decode {args.gen} tok [{args.loop} loop]: {t_decode * 1e3:.0f} ms "
          f"({args.gen * args.batch / max(t_decode, 1e-9):.1f} tok/s) on {device}")
    print("sample continuation ids:", out[0, :16].tolist())
    return {"tokens": out, "ms": (t_prefill * 1e3, t_decode * 1e3)}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
