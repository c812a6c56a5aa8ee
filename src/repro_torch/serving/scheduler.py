"""Request scheduler: slot admission / eviction for continuous batching
(port of repro.serving.scheduler; pure numpy, no device work).

Requests arrive with ragged prompt lengths and per-request token budgets.
The scheduler owns a FIFO queue and the slot table; the engine owns the
device state. Two refill policies:

  * ``"continuous"``: admit whenever a slot is free. A request that hits
    EOS or its budget is evicted at the next chunk boundary and its slot
    refills at once, so short requests never hold the batch hostage;
  * ``"batch"``: admit only when ALL slots are free, the rectangular
    fixed-slot baseline (every group decodes until its longest member
    finishes).

``serve()`` drives the admit -> decode-chunk -> evict cycle to completion.
Under greedy decoding a request's output depends only on its own prompt
(slots are independent), so the same request set gives identical
per-request outputs under any arrival order or slot assignment.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

POLICIES = ("continuous", "batch")


@dataclasses.dataclass
class Request:
    """One generation request: prompt tokens and a new-token budget."""
    rid: int
    prompt: np.ndarray            # (len,) int32, len >= 1
    max_new: int                  # token budget (EOS may stop earlier)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new must be >= 1")


class Scheduler:
    """Slot table and FIFO admission queue.

    Invariants: a request occupies at most one slot; a slot is reused only
    after eviction; every submitted request is admitted exactly once and
    eventually evicted.
    """

    def __init__(self, num_slots: int, policy: str = "continuous"):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.num_slots = num_slots
        self.policy = policy
        self.queue: deque = deque()
        self.slot_rid: List[Optional[int]] = [None] * num_slots
        self._seen: set = set()
        self.admitted = 0
        self.evicted = 0

    def submit(self, req: Request) -> None:
        if req.rid in self._seen:
            raise ValueError(f"duplicate rid {req.rid}")
        self._seen.add(req.rid)
        self.queue.append(req)

    @property
    def free_slots(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_rid) if r is None]

    @property
    def busy_slots(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_rid) if r is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.busy_slots)

    def admit(self) -> List[Tuple[int, Request]]:
        """Pop queued requests FIFO into free slots (policy-gated)."""
        free = self.free_slots
        if self.policy == "batch" and len(free) < self.num_slots:
            return []
        out = []
        for slot in free:
            if not self.queue:
                break
            req = self.queue.popleft()
            self.slot_rid[slot] = req.rid
            self.admitted += 1
            out.append((slot, req))
        return out

    def evict(self, slot: int) -> int:
        rid = self.slot_rid[slot]
        if rid is None:
            raise ValueError(f"slot {slot} is not busy")
        self.slot_rid[slot] = None
        self.evicted += 1
        return rid


def serve(engine, requests, *, chunk: Optional[int] = None,
          policy: str = "continuous", seed: int = 0) -> Dict[int, np.ndarray]:
    """Serve ``requests`` to completion on ``engine``.

    Each admitted group is prefilled in one batched masked replay
    (``DecodeEngine.admit``); decode advances every active slot ``chunk``
    tokens per ``decode_chunk``; finished slots are evicted at chunk
    boundaries and refilled (policy "continuous") or held until the whole
    batch drains ("batch"). Raises if three chunks in a row admit, generate
    and evict nothing. Returns ``{rid: generated tokens}`` (an emitted EOS
    included).
    """
    sched = Scheduler(engine.batch, policy=policy)
    engine.reset(seed=seed)
    outputs: Dict[int, list] = {}
    for r in requests:
        sched.submit(r)
        outputs[r.rid] = []
    guard = 0
    while sched.has_work:
        admitted = sched.admit()
        if admitted:
            engine.admit([s for s, _ in admitted],
                         [r.prompt for _, r in admitted],
                         [r.max_new for _, r in admitted])
        toks, n_gen, active = engine.decode_chunk(chunk)
        progressed = bool(admitted)
        for slot in sched.busy_slots:
            k = int(n_gen[slot])
            if k:
                outputs[sched.slot_rid[slot]].extend(toks[slot, :k].tolist())
                progressed = True
            if not active[slot]:
                sched.evict(slot)
        guard = 0 if progressed else guard + 1
        if guard > 2:
            raise RuntimeError(
                "serve loop stalled: no admission, generation, or eviction "
                f"for {guard} chunks (queue={len(sched.queue)}, "
                f"busy={sched.busy_slots})")
    assert sched.evicted == sched.admitted == len(outputs)
    return {rid: np.asarray(v, np.int32) for rid, v in outputs.items()}
