"""Training entry point of the port (mirrors repro.launch.train's CLI).

    PYTHONPATH=src python -m repro_torch.launch.train --arch zaremba-medium \
        --batch 20 --seq 35 --dropout case3:0.5:pallas --engine fused
    PYTHONPATH=src python -m repro_torch.launch.train --arch luong-nmt \
        --batch 64 --seq 50 --dropout case3:0.3:pallas --engine fused
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b \
        --layers 16 --batch 2 --seq 2048 --dropout case3:0.25:bs64:pallas \
        --engine fused
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --layers 4 --batch 1 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
        --batch 32 --seq 448
    PYTHONPATH=src python -m repro_torch.launch.train --arch bilstm-ner \
        --batch 32 --seq 64 --dropout case3:0.5:pallas --engine fused \
        --ckpt-dir /path/to/ckpt --resume auto

``--seq`` is the unroll of an LM, the ``max_len`` of an NMT pair and the
sentence length of a tagger batch; ``--layers`` overrides the arch's depth.

Runs on the current CUDA device; ``--device cpu`` runs on the CPU (the
kernels' plain versions). Without a GPU and without ``--device cpu`` it
raises. Prints each step's loss and wall time (ms, ending in a device
synchronisation) and, on the card, the run's peak device memory
(``torch.cuda.max_memory_allocated``). Configs train in their own dtypes:
the full transformers and xlstm-1.3b in bfloat16 (float32 moments), the
smoke configs and the paper's models in float32. ``--seq`` of whisper-base
is its decoder's token count; its encoder always takes ``enc_seq`` frames.

Checkpoints as the reference trainer: with ``--ckpt-dir``, every
``--ckpt-every`` steps, at the last step, and at the step boundary after a
SIGTERM (then it stops), (params, optimizer state) go to
``checkpoint.save_checkpoint`` with the plan that ran in the manifest's
``meta``; ``--resume auto`` restores the latest complete checkpoint and goes
on from its step. Batches and masks are functions of (seed, step), so a
resumed run takes the steps a straight run would.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_mod
from repro_torch import configs
from repro_torch.configs import adapters
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod


def _to_device(d: dict, device) -> dict:
    """numpy arrays -> tensors on ``device``; on CUDA through pinned memory
    and asynchronous copies, so the host runs ahead."""
    out = {}
    for k, v in d.items():
        x = torch.from_numpy(v)
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
        out[k] = x
    return out


def make_batch_fn(kind: str, cfg, batch: int, seq: int, seed: int, device):
    """step -> the batch dict the reference trainer makes for ``kind``:
    lstm_lm, xlstm and transformer {"tokens", "labels"} (B, S) int32,
    contiguous windows of a deterministic ``lm_stream`` (an ``embeds_in``
    transformer gets {"embeds" (B, S, d_model) float32, "labels"} and an
    encoder-decoder also "frames" (B, enc_seq, d_model) float32 x 0.02,
    each drawn by ``np.random.default_rng(seed + step)``, as the
    reference's); nmt ``nmt_pairs(batch, ..., max_len=seq, seed=seed +
    step)`` (src, tgt_in, tgt_out and their bool masks); tagger
    ``ner_examples(batch, ..., seq=seq, seed=seed + step)`` (words, chars,
    tags, mask)."""
    if kind == "nmt":
        return lambda step: _to_device(synthetic.nmt_pairs(
            batch, cfg.src_vocab, cfg.tgt_vocab, max_len=seq,
            seed=seed + step), device)
    if kind == "tagger":
        return lambda step: _to_device(synthetic.ner_examples(
            batch, cfg.vocab, cfg.char_vocab, cfg.num_tags, seq=seq,
            seed=seed + step), device)
    if kind not in ("lstm_lm", "xlstm", "transformer"):
        raise ValueError(f"no batches for kind {kind!r}")
    stream = synthetic.lm_stream(cfg.vocab, batch * (seq + 1) * 64, seed=seed)

    def fn(step):
        n = batch * (seq + 1)
        off = (step * n) % (len(stream) - n - 1)
        d = {"c": stream[off:off + n].reshape(batch, seq + 1)}
        if getattr(cfg, "embeds_in", False):
            d["embeds"] = np.random.default_rng(seed + step).standard_normal(
                (batch, seq, cfg.d_model), dtype=np.float32)
        if getattr(cfg, "is_encoder_decoder", False):
            d["frames"] = np.random.default_rng(seed + step).standard_normal(
                (batch, cfg.enc_seq, cfg.d_model), dtype=np.float32) * 0.02
        d = _to_device(d, device)
        chunk = d.pop("c")
        d["labels"] = chunk[:, 1:]
        if "embeds" not in d:
            d["tokens"] = chunk[:, :-1]
        return d
    return fn


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--layers", type=int, default=0,
                    help="number of layers (blocks); 0 keeps the arch's own")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--no-dropout", action="store_true")
    ap.add_argument("--dropout", default="",
                    help="dropout-plan override: 'case{1..4}:<rate>[:bs<int>]"
                         "[:pallas]' or 'off', at the arch's canonical sites; "
                         ":pallas selects the hand-written CUDA kernels")
    ap.add_argument("--engine", default="",
                    choices=["", "scheduled", "stepwise", "fused"])
    ap.add_argument("--device", default=None,
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    return ap.parse_args(argv)


def run(argv=None, cfg_fn=None) -> dict:
    """Train and return {"losses": [...], "ms": [...], "cfg": cfg, "params":
    params, "start": the first step run (> 0 after a resume)}. ``cfg_fn``
    maps the built config to the one trained (a variant such as
    ``launch.profile.VARIANTS["qwen3_flash"]``)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    spec = configs.get_arch(args.arch)
    cfg = spec.smoke() if args.smoke else spec.full()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.dropout:
        cfg = adapters.apply_dropout(spec, cfg, args.dropout)
        print(f"[dropout] plan override {args.dropout!r} -> sites "
              f"{list(cfg.plan.active_sites())}")
    if args.engine:
        cfg = adapters.apply_engine(spec, cfg, args.engine)
        print(f"[engine] recurrent engine -> {cfg.engine!r}")
    if cfg_fn is not None:
        cfg = cfg_fn(cfg)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator().manual_seed(args.seed)
    params = adapters.init_params(spec.kind, gen, cfg, device=device)
    opt = steps_mod.default_opt(args.lr)
    opt_state = opt.init(params)
    train_step = steps_mod.make_train_step(spec, cfg, opt,
                                           use_dropout=not args.no_dropout)
    batch_fn = make_batch_fn(spec.kind, cfg, args.batch, args.seq, args.seed,
                             device)
    start = 0
    if args.ckpt_dir and args.resume == "auto" and \
            ckpt_mod.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start = ckpt_mod.restore_checkpoint(
            args.ckpt_dir, (params, opt_state))
        print(f"[resume] restored step {start} from {args.ckpt_dir}")
    # the pattern that ran: --no-dropout passes no seed, so no site is active
    plan_ran = DropoutPlan.off() if args.no_dropout else cfg.plan
    meta = {"dropout_plan": plan_ran.to_dict()}
    # a SIGTERM asks for a last checkpoint, so it is caught only with a dir
    hook = ckpt_mod.PreemptionHook() if args.ckpt_dir else None
    losses, times = [], []
    try:
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            params, opt_state, loss = train_step(params, opt_state,
                                                 batch_fn(step), step, args.seed)
            loss = float(loss)          # waits for the device
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            losses.append(loss)
            times.append(dt * 1e3)
            if step % args.log_every == 0:
                print(f"step {step:5d}  loss {loss:.4f}  {dt * 1e3:.1f} ms")
            if hook is not None and ((step + 1) % args.ckpt_every == 0
                                      or hook.should_save
                                      or step + 1 == args.steps):
                ckpt_mod.save_checkpoint(args.ckpt_dir, step + 1,
                                         (params, opt_state), meta=meta)
                if hook.should_save:
                    print(f"[preempt] final checkpoint at step {step + 1}; "
                          f"exiting")
                    break
    finally:
        if hook is not None:
            hook.restore()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    print(f"done: {len(losses)} steps on {device}, median "
          f"{float(np.median(times)) if times else float('nan'):.1f} ms/step, "
          f"final loss {losses[-1] if losses else float('nan'):.4f}"
          + ("" if peak is None else f", peak memory {peak} bytes "
             f"({peak / 2**30:.2f} GiB)"))
    return {"losses": losses, "ms": times, "cfg": cfg, "params": params,
            "start": start}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
