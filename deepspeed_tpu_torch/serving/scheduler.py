"""Continuous-batching request scheduler (Orca-style iteration-level
scheduling): the port's own copy of ``deepspeed_tpu/serving/scheduler.py``.

Admission decisions happen BETWEEN decode iterations: whenever a slot frees
(EOS / token budget / deadline), the next queued request is prefilled and
joins the running batch on the very next decode chunk. Host-side only. The
engine (serving/engine.py) drives it:

    while scheduler.has_work():
        for req in scheduler.admit():        # prefill + slot insert
            ...; scheduler.record_first_token(req, tok)
        finished = scheduler.step_tokens_chunk({slot: [t0, t1, ...], ...})

Backpressure: the queue is bounded; ``submit`` rejects with a reason
(``queue_full`` / ``prompt_too_long``) instead of buffering unboundedly.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

REJECT_QUEUE_FULL = "queue_full"
REJECT_PROMPT_TOO_LONG = "prompt_too_long"
REJECT_DEADLINE_EXPIRED = "deadline_expired"
REJECT_KV_OOM = "kv_blocks_exhausted"

_uid_counter = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request plus its lifecycle record."""
    prompt: np.ndarray                     # [prompt_len] int32 token ids
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    deadline_s: Optional[float] = None     # absolute clock() time budget
    uid: int = dataclasses.field(default_factory=lambda: next(_uid_counter))
    # distributed trace id (fleet journeys): minted at submit by the
    # frontend/router, preserved across a crash-reroute
    trace_id: Optional[str] = None
    # billing/accounting identity — admission rate-limits per tenant and
    # TraceLog aggregates per-tenant goodput under this label; direct
    # engine callers that never set one land in the "default" bucket so
    # aggregation never silently drops untagged requests
    tenant: str = "default"

    # ---- filled in by the scheduler ----
    status: str = "new"   # new|queued|running|done|expired|rejected|cancelled
    reject_reason: Optional[str] = None
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    submit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def output_ids(self) -> np.ndarray:
        """prompt + generated tokens, the ``generate`` output contract."""
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token: submit -> first sampled token."""
        if self.submit_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t


class ContinuousBatchScheduler:
    """Bounded FIFO queue + iteration-level admission + per-request
    termination (EOS / max_new_tokens / deadline / cache-row exhaustion).

    ``allocator`` is a :class:`~deepspeed_tpu_torch.serving.kv_cache.SlotAllocator`
    (or the manager wrapping one); ``clock`` is injectable for
    deterministic tests."""

    def __init__(self, allocator, *, max_queue: int = 64,
                 max_prompt_len: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.allocator = allocator
        self.max_queue = max_queue
        self.max_prompt_len = max_prompt_len
        self.clock = clock
        self.queue: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}          # slot -> request
        self.finished: List[Request] = []
        self.n_rejected = 0
        self.n_expired = 0
        self.n_cancelled = 0

    # ------------------------------------------------------------- submit
    def submit(self, req: Request) -> bool:
        """Enqueue, or reject-with-reason (bounded queue backpressure /
        a prompt the fixed shapes cannot serve). Returns acceptance."""
        req.submit_t = self.clock()
        limit = self.max_prompt_len
        seq_cap = getattr(self.allocator, "max_seq_len", None)
        too_long = (limit is not None and req.prompt_len > limit) or (
            seq_cap is not None
            and req.prompt_len + req.max_new_tokens > seq_cap)
        if too_long:
            return self._reject(req, REJECT_PROMPT_TOO_LONG)
        # paged allocators expose a finite token pool: a request no EMPTY
        # pool could hold can never be admitted — reject-with-reason now
        # instead of wedging the FIFO head forever
        pool_cap = getattr(self.allocator, "pool_capacity_tokens", None)
        if (pool_cap is not None
                and req.prompt_len + req.max_new_tokens > pool_cap):
            return self._reject(req, REJECT_KV_OOM)
        # an already-expired deadline can never be met: reject here rather
        # than admit, prefill, and kill at the first chunk boundary
        if req.deadline_s is not None and req.submit_t >= req.deadline_s:
            return self._reject(req, REJECT_DEADLINE_EXPIRED)
        if len(self.queue) >= self.max_queue:
            return self._reject(req, REJECT_QUEUE_FULL)
        req.status = "queued"
        self.queue.append(req)
        return True

    def _reject(self, req: Request, reason: str) -> bool:
        req.status = "rejected"
        req.reject_reason = reason
        self.n_rejected += 1
        return False

    # ---------------------------------------------------------- admission
    def admit(self, token_budget: Optional[int] = None,
              lane_cost=None) -> List[Request]:
        """FIFO admission while slots are free. Deadline-expired queued
        requests are shed here (never prefilled). Returned requests have
        ``.slot`` leased; the caller prefills, inserts into the arena, and
        reports the prefill's sampled token via ``record_first_token``.

        Fused chunked-prefill engines pass a ``token_budget`` (the chunk
        token budget's free headroom) and a ``lane_cost(req)`` callable
        (the per-scan-step cost the new lane adds — its first prompt
        chunk, or one decode token): admission stops at the first request
        that would overflow the budget, EXCEPT that an otherwise-idle
        engine always admits one (a budget must never starve an empty
        scan). Both default to None — plain slot-bound FIFO admission."""
        admitted: List[Request] = []
        budget = token_budget
        while self.queue:
            req = self.queue[0]
            if (req.deadline_s is not None
                    and self.clock() >= req.deadline_s):
                self.queue.popleft()
                self._finish(req, "expired")
                continue
            if budget is not None and lane_cost is not None:
                cost = lane_cost(req)
                if cost > budget and (self.running or admitted):
                    break
                budget -= cost
            slot = self._lease(req)
            if slot is None:
                break
            self.queue.popleft()
            req.slot = slot
            req.status = "running"
            self.running[slot] = req
            admitted.append(req)
        return admitted

    def _lease(self, req: Request) -> Optional[int]:
        """Request-shaped lease when the allocator supports it (the paged
        allocator plans block reservations / prefix sharing per request);
        plain fill-length lease otherwise (the dense slot arena)."""
        alloc_request = getattr(self.allocator, "alloc_request", None)
        if alloc_request is not None:
            return alloc_request(req)
        return self.allocator.alloc(req.prompt_len)

    # ---------------------------------------------------------- lifecycle
    def record_first_token(self, req: Request, token: int) -> None:
        """The prefill program samples token #1; a request may terminate
        right here (max_new_tokens == 1, or an immediate EOS)."""
        req.first_token_t = self.clock()
        self._append(req, token)

    def step_tokens(self, tokens_by_slot: Dict[int, int]) -> List[Request]:
        """Apply one decode iteration's sampled token per slot; returns the
        requests that finished this step (their slots are already free for
        the next admission pass)."""
        before = len(self.finished)
        for slot, token in tokens_by_slot.items():
            req = self.running.get(slot)
            if req is None:
                raise KeyError(f"no running request in slot {slot}")
            self._append(req, token)
        return self.finished[before:]

    def step_tokens_chunk(self, tokens_by_slot: Dict[int, List[int]]
                          ) -> List[Request]:
        """Apply one fused multi-step decode chunk: a SEQUENCE of sampled
        tokens per slot (serving/engine.py's device-resident K-step loop
        syncs once per chunk and hands the whole token buffer here).
        Per-token semantics are identical to K ``step_tokens`` calls for
        that slot: the allocator fill advances one row per consumed token
        (so the cache-row safety net in ``_append`` sees the same
        remaining count the per-token loop would), and consumption stops
        at the request's own termination — trailing tokens a speculative
        chunk produced past EOS/budget/deadline are dropped, never
        appended. Returns the requests finished within this chunk."""
        before = len(self.finished)
        for slot, tokens in tokens_by_slot.items():
            req = self.running.get(slot)
            if req is None:
                raise KeyError(f"no running request in slot {slot}")
            for token in tokens:
                if req.status != "running":
                    break
                self.allocator.advance([slot])
                self._append(req, token)
        return self.finished[before:]

    def _append(self, req: Request, token: int) -> None:
        req.tokens.append(int(token))
        # a non-final token must be fed back through decode (written at the
        # slot's fill position), so a row with no space left terminates the
        # request — unreachable when submit()'s length guard ran, kept as
        # the safety net for allocators without a max_seq_len
        done = (len(req.tokens) >= req.max_new_tokens
                or (req.eos_token_id is not None
                    and int(token) == req.eos_token_id)
                or (req.slot is not None
                    and self.allocator.remaining(req.slot) <= 0))
        expired = (req.deadline_s is not None
                   and self.clock() >= req.deadline_s)
        if expired and not done:
            self._finish(req, "expired")
        elif done:
            self._finish(req, "done")

    def cancel(self, req: Request) -> bool:
        """Caller-initiated termination. A queued request is removed
        before it ever prefills; a running request frees its slot for the
        very next admission pass (the engine deactivates the device lane
        at the next chunk launch). Returns False when the request is
        already terminal (or was never submitted here)."""
        if req.status == "queued":
            # identity scan, not deque.remove: the dataclass __eq__
            # compares the numpy prompt arrays, which raises on bool()
            for i, queued in enumerate(self.queue):
                if queued is req:
                    del self.queue[i]
                    self._finish(req, "cancelled")
                    return True
            return False
        if req.status == "running" and self.running.get(req.slot) is req:
            self._finish(req, "cancelled")
            return True
        return False

    def _finish(self, req: Request, status: str) -> None:
        req.status = status
        req.finish_t = self.clock()
        if status == "expired":
            self.n_expired += 1
        elif status == "cancelled":
            self.n_cancelled += 1
        if req.slot is not None:
            self.running.pop(req.slot, None)
            self.allocator.free(req.slot)
        self.finished.append(req)

    # ------------------------------------------------------------ queries
    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def has_work(self) -> bool:
        return bool(self.queue or self.running)
