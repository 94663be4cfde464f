"""ServingEngine: continuous-batching server over the inference stack.

Counterpart of ``deepspeed_tpu/serving/engine.py`` (dense arena subset). It
composes

  * an :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
    (device placement and dtype),
  * a slotted KV arena with per-slot fills (serving/kv_cache.py),
  * an iteration-level scheduler (serving/scheduler.py),
  * serving counters (serving/metrics.py),

into a chunked serve loop:

  prefill  bucketed: the admitted prompts are padded to the smallest
           bucket (16/32/64/... up to ``max_prompt_len``) covering the
           group's longest prompt; one cacheless forward per bucket group
           samples token #1 and its K/V moves into the leased slot rows;
  decode   ``decode_chunk`` (K) decode steps per host iteration over all
           ``max_batch`` lanes: sampling, per-slot EOS / token-budget stop
           masking and KV writes stay on the device; retired lanes pin their
           write index at ``max_seq_len`` (the model drops the write). The
           host syncs once per chunk and hands the token buffer to the
           scheduler.

``megakernel=True`` routes every decode step's attention through the
hand-written decode kernel (``decode_impl="auto"``) and every sampling call
through the sort-free sampling kernel (``fused_sample_tokens``). On a CPU
device both wrappers run their plain PyTorch versions.

Not in this slice (see ROADMAP.md): paged KV, the prefix cache, tiered KV,
speculative decoding, fused prefill, the int8 cache, tp, disaggregation,
migration, telemetry spans and the double-buffered ``pump`` loop.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..utils.logging import log_dist
from .kv_cache import SlotKVCacheManager
from .metrics import ServingMetrics
from .sampling import fused_sample_tokens, sample_tokens
from .scheduler import ContinuousBatchScheduler, Request


def default_prefill_buckets(max_prompt_len: int) -> List[int]:
    """Power-of-two prefill buckets from 16 up to ``max_prompt_len`` (which
    always caps the list so every admissible prompt has a bucket)."""
    out: List[int] = []
    b = 16
    while b < max_prompt_len:
        out.append(b)
        b *= 2
    out.append(max_prompt_len)
    return out


class ServingEngine:
    """Continuous-batching server over a decoder LM. Minimal use::

        serving = ServingEngine(model, max_batch=8, megakernel=True)
        results = serving.run([prompt_ids_1, prompt_ids_2, ...],
                              max_new_tokens=32)
        results[0].output_ids      # prompt + generated tokens

    Pass an existing ``InferenceEngine`` as ``engine=``, or ``model`` (plus
    an optional ``model_parameters`` state_dict and the ``InferenceEngine``
    keywords ``dtype`` / ``device``) to build one. ``decode_chunk`` is the
    number of decode steps per host sync; greedy outputs are identical for
    every value."""

    def __init__(self, model=None, model_parameters=None, *,
                 engine=None,
                 max_batch: int = 8,
                 max_prompt_len: Optional[int] = None,
                 max_queue: int = 64,
                 decode_chunk: int = 8,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 megakernel: bool = False,
                 seed: int = 0,
                 **inference_kwargs):
        if engine is None:
            from ..inference.engine import InferenceEngine
            engine = InferenceEngine(model, model_parameters=model_parameters,
                                     **inference_kwargs)
        self.engine = engine
        self.device = engine.device
        self.module = engine.module
        cfg = self.module.cfg
        self.megakernel = bool(megakernel)
        # the megakernel switch: decode attention through the kernel wrapper
        # and sampling through the fused epilogue
        self._decode_impl = "auto" if self.megakernel else cfg.decode_impl
        self._sample = (fused_sample_tokens if self.megakernel
                        else sample_tokens)
        self.max_batch = int(max_batch)
        self.max_seq_len = int(cfg.max_seq_len)
        self.max_prompt_len = int(max_prompt_len or self.max_seq_len)
        if self.max_prompt_len > self.max_seq_len:
            raise ValueError(f"max_prompt_len {self.max_prompt_len} exceeds "
                             f"the model's max_seq_len {self.max_seq_len}")
        self.decode_chunk = int(decode_chunk)
        if self.decode_chunk < 1:
            raise ValueError(
                f"decode_chunk must be >= 1, got {decode_chunk}")
        if prefill_buckets is None:
            self._buckets = default_prefill_buckets(self.max_prompt_len)
        else:
            self._buckets = sorted(
                {int(b) for b in prefill_buckets
                 if 0 < int(b) <= self.max_prompt_len}
                | {self.max_prompt_len})
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.kv = SlotKVCacheManager(cfg, self.max_batch, self.device)
        self.scheduler = ContinuousBatchScheduler(
            self.kv.allocator, max_queue=max_queue,
            max_prompt_len=self.max_prompt_len)
        self.metrics = ServingMetrics()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))
        self._last_token = np.zeros(self.max_batch, np.int32)
        # distinct (batch, bucket) prefill shapes seen so far
        self._prefill_shapes: Set[Tuple[int, int]] = set()
        log_dist(f"serving engine ready: slots={self.max_batch} "
                 f"prefill_buckets={self._buckets} "
                 f"decode_chunk={self.decode_chunk} "
                 f"max_seq={self.max_seq_len} megakernel={self.megakernel} "
                 f"device={self.device}", ranks=[0])

    # --------------------------------------------------------------- API
    def submit(self, prompt: Union[Request, Sequence[int], np.ndarray],
               **request_kwargs) -> Request:
        """Enqueue one request (token-id prompt or a prebuilt Request).
        Rejections (bounded queue, oversized prompt) come back as
        ``status == "rejected"`` with ``reject_reason`` set."""
        req = prompt if isinstance(prompt, Request) else Request(
            prompt=np.asarray(prompt, np.int32), **request_kwargs)
        self.metrics.start()
        if not self.scheduler.submit(req):
            self.metrics.on_rejected()
        return req

    def step(self) -> List[Request]:
        """One continuous-batching iteration: admit newly-runnable requests
        (bucketed prefill + arena insert), then one K-step decode chunk over
        all live slots. Returns the requests finished in this iteration."""
        before = len(self.scheduler.finished)
        self._admit()
        if self.scheduler.running:
            self._decode_chunk()
        return self.scheduler.finished[before:]

    def run(self, prompts: Optional[Sequence] = None,
            **request_kwargs) -> List[Request]:
        """Serve until drained. ``prompts``: token-id sequences (or Request
        objects) submitted up front; ``request_kwargs`` (max_new_tokens,
        eos_token_id, deadline_s) apply to all of them. Returns the
        submitted requests in submission order (rejected ones included,
        flagged by status)."""
        submitted = [self.submit(p, **request_kwargs)
                     for p in (prompts or [])]
        while self.scheduler.has_work():
            self.step()
        return submitted

    # ---------------------------------------------------------- internals
    def _bucket_for(self, prompt_len: int) -> int:
        for b in self._buckets:
            if prompt_len <= b:
                return b
        return self._buckets[-1]    # unreachable: submit() length guard

    def _admit(self) -> None:
        """Admit every currently-runnable request: group by prefill bucket,
        one batched prefill and one arena insert per group."""
        admitted = self.scheduler.admit()
        groups: Dict[int, List[Request]] = {}
        for req in admitted:
            groups.setdefault(self._bucket_for(req.prompt_len),
                              []).append(req)
        for bucket, reqs in sorted(groups.items()):
            self._prefill(bucket, reqs)

    @torch.inference_mode()
    def _prefill(self, bucket: int, reqs: List[Request]) -> None:
        n = len(reqs)
        ids = np.zeros((n, bucket), np.int64)
        lens = np.empty(n, np.int64)
        for i, r in enumerate(reqs):
            ids[i, :r.prompt_len] = r.prompt
            lens[i] = r.prompt_len
        self._prefill_shapes.add((n, bucket))
        dev = self.device
        hidden, keys, values = self.module.prefill(
            torch.from_numpy(ids).to(dev))
        last = hidden[torch.arange(n, device=dev),
                      torch.from_numpy(lens - 1).to(dev)]
        toks = self._sample(self.module.logits(last), self._generator,
                            self.temperature, self.top_k, self.top_p)
        self.kv.insert_batch(keys, values, [r.slot for r in reqs])
        toks_host = toks.cpu().numpy()
        self.metrics.on_prefill(n, bucket, int(lens.sum()),
                                len(self._prefill_shapes))
        self.metrics.on_tokens(n)
        for i, r in enumerate(reqs):
            first = int(toks_host[i])
            self._last_token[r.slot] = first
            # may retire the request at once (max_new_tokens == 1 or an
            # immediate EOS): its slot frees before any decode
            self.scheduler.record_first_token(r, first)

    def _host_state(self):
        """Chunk-input lane state from the scheduler/allocator mirrors."""
        B = self.max_batch
        tokens = np.zeros(B, np.int64)
        positions = np.zeros(B, np.int64)
        active = np.zeros(B, bool)
        remaining = np.zeros(B, np.int64)
        eos = np.full(B, -1, np.int64)
        for slot, req in self.scheduler.running.items():
            tokens[slot] = self._last_token[slot]
            positions[slot] = self.kv.fill[slot]
            remaining[slot] = min(req.max_new_tokens - len(req.tokens),
                                  self.kv.allocator.remaining(slot))
            active[slot] = True
            if req.eos_token_id is not None:
                eos[slot] = int(req.eos_token_id)
        return tokens, positions, active, remaining, eos

    @torch.inference_mode()
    def _decode_chunk(self) -> None:
        """K decode steps over all lanes (the TPU package's
        ``decode_chunk_fn`` scan as a loop), one host sync, then the
        scheduler consumes the token buffer."""
        t0 = time.perf_counter()
        dev, S = self.device, self.max_seq_len
        tok, pos, act, rem, eos = (torch.from_numpy(a).to(dev)
                                   for a in self._host_state())
        slots = dict(self.scheduler.running)
        toks, valid = [], []
        for _ in range(self.decode_chunk):
            write_pos = torch.where(act, pos, S)        # masked lanes drop
            logits = self.module.decode(
                tok[:, None], pos.clamp(max=S - 1)[:, None],
                self.kv.cache_k, self.kv.cache_v, write_pos,
                decode_impl=self._decode_impl)
            nxt = self._sample(logits[:, -1], self._generator,
                               self.temperature, self.top_k,
                               self.top_p).to(tok.dtype)
            nxt = torch.where(act, nxt, tok)            # frozen lanes hold
            emitted = act
            rem = torch.where(act, rem - 1, rem)
            hit_eos = (eos >= 0) & (nxt == eos)
            act = act & (rem > 0) & ~hit_eos
            pos = torch.where(emitted, pos + 1, pos)
            tok = nxt
            toks.append(nxt)
            valid.append(emitted)
        toks_host = torch.stack(toks, dim=1).cpu().numpy()
        valid_host = torch.stack(valid, dim=1).cpu().numpy()
        seconds = time.perf_counter() - t0
        per_slot: Dict[int, List[int]] = {}
        for slot in slots:
            seq = [int(t) for t, v in zip(toks_host[slot], valid_host[slot])
                   if v]
            if seq:
                per_slot[slot] = seq
                self._last_token[slot] = seq[-1]
        finished = self.scheduler.step_tokens_chunk(per_slot)
        self.metrics.on_tokens(sum(len(v) for v in per_slot.values()))
        self.metrics.on_decode_step(seconds)
        self.metrics.on_finished(finished)
