"""Continuous-batching decode engine (port of repro.serving.engine).

  * chunked decode: ``decode_chunk(n)`` advances every active slot by up to
    ``n`` tokens, carrying (state, last token, position, budget, active) and
    writing the sampled tokens into a (B, n) buffer (-1 where a slot is
    inactive). On the card the ``n`` steps are ONE captured CUDA graph
    (``torch.cuda.CUDAGraph``), captured once for each ``n`` and replayed:
    one dispatch a chunk, as the reference's jitted ``lax.while_loop``. A
    graph cannot exit early, so it runs all ``n`` steps; an inactive slot
    freezes its token and writes -1, so the outputs equal the reference's
    early-exiting loop. On the CPU the same step runs eagerly and the chunk
    stops once no slot is active. A decode step that cannot be captured
    raises with the reason; the engine never falls back to the eager loop
    on the card.
  * slot admission / eviction: ``admit`` prefills a ragged group in one
    batched masked replay (``serving/prefill.py``) and scatters its state
    rows into the slots; ``serving/scheduler.py`` evicts and refills them.

Every decode buffer (the state, ``tok``, ``pos``, ``gen_left``, ``active``)
is allocated once and updated in place, so the graphs' addresses stay
valid: ``reset`` refills them, and a state handed in by rebinding
``engine.state`` is copied into them before the next step. An
encoder-decoder's state holds its cross K/V (``xk``, ``xv``) among these
buffers: ``prefill`` encodes the batch's frames into them in place, and
every decode step reads them. Sampled
decoding draws from the engine's own generator (registered with each
graph, so replays advance it); greedy decoding draws nothing.

The transformer decodes every slot at one position (the largest ``pos``,
kept on the device), so it serves rectangularly: all slots admitted
together with equal prompt lengths (``admit`` raises otherwise), as the
reference. The reference's mesh-sharded engine state is not ported
(ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import adapters
from repro_torch.configs.base import ArchSpec
from repro_torch.optim import tree_leaves
from repro_torch.serving.prefill import replay_prefill

I32 = torch.int32


def sample_logits(logits, *, temperature: float = 1.0, top_k: int = 0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits (B, 1, V) -> token ids (B, 1) int32.

    ``temperature <= 0`` is greedy (argmax, first maximum on ties). Else a
    categorical draw from ``generator`` by the Gumbel-max trick, as
    ``jax.random.categorical``; top-k rejects are masked with ``finfo.min``
    of the logits' dtype (not a hard-coded constant), so masked entries
    stay finite and even a constant row samples a valid id.
    """
    lg = logits[:, 0, :].float()
    if temperature <= 0.0:
        return lg.argmax(-1, keepdim=True).to(I32)
    lg = lg / temperature
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, torch.finfo(lg.dtype).min, lg)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (lg + gumbel).argmax(-1, keepdim=True).to(I32)


def _bucket(n: int, quantum: int = 8) -> int:
    """Round a ragged replay length up to a multiple of ``quantum``, as the
    reference buckets its jitted replay shapes."""
    return max(quantum, -(-n // quantum) * quantum)


@dataclasses.dataclass
class DecodeEngine:
    """Slot-batched decode engine over one device's state (the device of
    ``params``). ``eos_id < 0`` disables EOS stopping."""
    spec: ArchSpec
    cfg: Any
    params: Any
    max_seq: int
    batch: int
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int = -1
    chunk: int = 16
    chunks_run: int = 0          # host-visible dispatch counter

    def __post_init__(self):
        self.device = tree_leaves(self.params)[0].device
        B, dev = self.batch, self.device
        self._decode = adapters.decode_fn(self.spec)
        self._buf = self._fresh_state(B)
        self.state = self._buf
        self.tok = torch.zeros((B, 1), dtype=I32, device=dev)     # last token
        self.pos = torch.zeros((B,), dtype=I32, device=dev)       # tokens consumed
        self.gen_left = torch.zeros((B,), dtype=I32, device=dev)  # budget left
        self.active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(0)
        self._graphs: dict = {}      # n -> (CUDAGraph, out (B, n))
        self._pool = None

    # ------------------------------------------------------------------
    # state lifecycle
    # ------------------------------------------------------------------

    def _fresh_state(self, batch: int):
        return adapters.init_decode_state(self.spec, self.cfg, batch,
                                          self.max_seq, device=self.device)

    def _buffers(self):
        return (*self._buf.values(), self.tok, self.pos, self.gen_left,
                self.active)

    def _own_state(self) -> None:
        """Copy a state handed in by rebinding ``self.state`` into the
        engine's buffers, which the graphs read and write."""
        if self.state is not self._buf:
            for k, v in self._buf.items():
                if self.state[k] is not v:
                    v.copy_(self.state[k])
            self.state = self._buf

    @torch.no_grad()
    def reset(self, seed: int = 0) -> None:
        """Clear every slot (fresh state, all inactive) for a new trace."""
        blank = self._fresh_state(1)
        for k, v in self._buf.items():
            v.copy_(blank[k].expand_as(v))
        self.state = self._buf
        for x in (self.tok, self.pos, self.gen_left, self.active):
            x.zero_()
        self._gen.manual_seed(seed)
        self.chunks_run = 0

    # ------------------------------------------------------------------
    # rectangular prefill (the scheduler path uses admit)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch) -> None:
        """Native prefill of every slot from ``batch``: {"tokens"} for the
        transformer and xlstm ({"embeds"} for an embeddings-in transformer,
        {"tokens", "frames"} for an encoder-decoder), the encoder batch
        {"src", "tgt_in", ["src_mask"]} for NMT."""
        self._own_state()
        adapters.prefill_fn(self.spec)(self.params, batch, self.cfg, self.state)

    # ------------------------------------------------------------------
    # slot admission (continuous batching)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def admit(self, slots: Sequence[int], prompts: Sequence,
              budgets: Sequence[int]) -> None:
        """Prefill newly admitted ragged prompts into free slots.

        ``prompts``: 1-D int token arrays (len >= 1). The whole group
        replays batched (padded to a bucket, per-row lengths) into a fresh
        state of its own, whose rows are then scattered into ``slots``
        (one ``index_copy_`` a leaf); each slot then holds ``pos = len - 1``
        with the prompt's last token queued (the serving/prefill.py
        convention).
        """
        g = len(slots)
        assert g == len(prompts) == len(budgets) and g > 0
        lens = np.array([len(p) for p in prompts], np.int64)
        if lens.min() < 1 or min(budgets) < 1:
            raise ValueError("prompts must be non-empty, budgets >= 1")
        if self.spec.kind == "transformer":
            uniform = len(set(lens.tolist())) == 1
            if bool(self.active.any()) or not uniform:
                raise NotImplementedError(
                    "per-slot ragged positions need recurrent O(1) state; "
                    "the KV decode step writes at one scalar position — "
                    "serve transformers rectangularly (all slots admitted "
                    "together with equal prompt lengths)")
        self._own_state()
        T = int(lens.max()) - 1
        part = self._fresh_state(g)
        if T > 0:
            toks = np.zeros((g, _bucket(T)), np.int32)
            for r, p in enumerate(prompts):
                toks[r, :lens[r] - 1] = np.asarray(p, np.int32)[:-1]
            replay_prefill(self.spec, self.cfg, self.params, part,
                           torch.from_numpy(toks).to(self.device), lens - 1)
        idx = torch.as_tensor(np.asarray(slots, np.int64)).to(self.device)
        for k, v in self._buf.items():
            v.index_copy_(1, idx, part[k].to(v.dtype))
        host = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(self.device)
        self.tok[idx, 0] = host([np.asarray(p)[-1] for p in prompts])
        self.pos[idx] = host(lens - 1)
        self.gen_left[idx] = host(budgets)
        self.active[idx] = True

    # ------------------------------------------------------------------
    # chunked decode
    # ------------------------------------------------------------------

    def _step(self, i: int, out: torch.Tensor, generator=None) -> None:
        """One decode step of every slot, all on the device: the step a
        chunk repeats (and a graph captures)."""
        logits, _ = self._decode(self.params, self.cfg, self.state, self.tok,
                                 self.pos.max())
        nxt = sample_logits(logits, temperature=self.temperature,
                            top_k=self.top_k, generator=generator or self._gen)
        # inactive slots freeze their token (their state rows are dead
        # until the next admission overwrites them)
        nxt = torch.where(self.active[:, None], nxt, self.tok)
        out[:, i] = torch.where(self.active, nxt[:, 0], -1)
        act = self.active.to(I32)
        self.pos.add_(act)
        self.gen_left.sub_(act)
        self.active.logical_and_((self.gen_left > 0) & (nxt[:, 0] != self.eos_id))
        self.tok.copy_(nxt)

    def _warm_up(self) -> None:
        """One step on a side stream before the first capture, so that
        libraries set themselves up outside it; everything the step changes
        is restored, and it draws from a generator of its own."""
        saved = [x.clone() for x in self._buffers()]
        out = torch.full((self.batch, 1), -1, dtype=I32, device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step(0, out, torch.Generator(device=self.device))
        torch.cuda.current_stream(self.device).wait_stream(side)
        for x, s in zip(self._buffers(), saved):
            x.copy_(s)

    def _graph(self, n: int):
        """The captured graph of ``n`` decode steps and its (B, n) output."""
        if n in self._graphs:
            return self._graphs[n]
        if not self._graphs:
            self._warm_up()
        out = torch.full((self.batch, n), -1, dtype=I32, device=self.device)
        graph = torch.cuda.CUDAGraph()
        if self.temperature > 0:
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    "sampled decoding in a CUDA graph needs "
                    "CUDAGraph.register_generator_state, which this PyTorch "
                    f"{torch.__version__} lacks; decode greedily "
                    "(temperature 0) or use generate_python")
            register(self._gen)
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out.fill_(-1)
                for i in range(n):
                    self._step(i, out)
        except RuntimeError as e:
            raise RuntimeError(
                f"decode_chunk: the {self.spec.kind} decode step could not be "
                f"captured in a CUDA graph ({type(e).__name__}: {e})") from e
        self._pool = graph.pool()
        self._graphs[n] = (graph, out)
        return self._graphs[n]

    def _run_eager(self, n: int) -> torch.Tensor:
        out = torch.full((self.batch, n), -1, dtype=I32, device=self.device)
        for i in range(n):
            if not bool(self.active.any()):
                break
            self._step(i, out)
        return out

    @torch.no_grad()
    def decode_chunk(self, n: Optional[int] = None):
        """Advance every active slot by up to ``n`` tokens in one dispatch.

        Returns host arrays ``(tokens (B, n), n_gen (B,), active (B,))``:
        slot ``s`` generated ``tokens[s, :n_gen[s]]`` this chunk (a slot
        that hits EOS or its budget mid-chunk stops there and reports
        ``active[s] = False``, so the scheduler can evict and refill it).
        """
        n = int(n or self.chunk)
        self._own_state()
        prev = self.pos.clone()
        if self.device.type == "cuda":
            graph, out = self._graph(n)
            graph.replay()
        else:
            out = self._run_eager(n)
        self.chunks_run += 1
        host = torch.cat([out, (self.pos - prev)[:, None],
                          self.active[:, None].to(I32)], 1).cpu().numpy()
        return host[:, :n], host[:, n], host[:, n + 1].astype(bool)

    # ------------------------------------------------------------------
    # rectangular generation
    # ------------------------------------------------------------------

    @torch.no_grad()
    def generate(self, prompt_tokens, n_steps: int, *, seed: int = 0,
                 start_pos: int = 0) -> np.ndarray:
        """Greedy or sampled continuation of (B, 1) last-prompt tokens, in
        chunks of ``chunk`` steps (one graph replay each on the card).
        ``start_pos`` = the tokens already in the cache or state. Returns
        (B, n_steps) int32, -1 after a slot stopped (EOS)."""
        self._own_state()
        self.tok.copy_(torch.as_tensor(prompt_tokens).reshape(self.batch, 1))
        self.pos.fill_(start_pos)
        self.gen_left.fill_(n_steps)
        self.active.fill_(True)
        self._gen.manual_seed(seed)
        out = np.full((self.batch, n_steps), -1, np.int32)
        done = 0
        while done < n_steps:
            n = min(self.chunk, n_steps - done)
            toks, _, active = self.decode_chunk(n)
            out[:, done:done + n] = toks
            done += n
            if not active.any():
                break
        return out

    @torch.no_grad()
    def generate_python(self, prompt_tokens, n_steps: int, *, seed: int = 0,
                        start_pos: int = 0) -> np.ndarray:
        """The per-token host loop: one eager step and one host sync per
        generated token (no EOS or budget), the baseline the chunked loop
        is held to (greedy tokens equal) and timed against."""
        self._own_state()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tok = torch.as_tensor(prompt_tokens).to(self.device, I32).reshape(
            self.batch, 1)
        positions = torch.arange(start_pos, start_pos + n_steps,
                                 device=self.device)
        out = []
        for t in range(n_steps):
            logits, _ = self._decode(self.params, self.cfg, self.state, tok,
                                     positions[t])
            tok = sample_logits(logits, temperature=self.temperature,
                                top_k=self.top_k, generator=gen)
            out.append(tok.cpu().numpy())
        return np.concatenate(out, axis=1)
