"""ServingEngine: continuous-batching server over the inference stack.

Counterpart of ``deepspeed_tpu/serving/engine.py`` (dense and paged arenas,
bf16/f32 or int8 KV). It composes

  * an :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
    (device placement and dtype),
  * a KV arena: the slotted one with per-slot fills
    (serving/kv_cache.py), or with ``paged=True`` a block pool with block
    tables, a prefix cache and copy-on-write forks (serving/paged_kv.py);
    ``kv_dtype="int8"`` stores either as int8 with per-position scales,
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

Paged admission: a prefix-cache hit (an exact repeat of a cached prompt,
greedy only) skips prefill: its full prompt blocks are shared, its partial
tail block is copied, and the cached first token seeds decode. Hit forks are
enqueued before the misses' prefill inserts (one stream: enqueue order is
write order), and each miss publishes its prompt blocks after its first
token, before the request can retire.

``megakernel=True`` routes every decode step's attention through the
hand-written decode kernels (``decode_impl="auto"``: dense or paged, int8 or
not) and every sampling call through the sort-free sampling kernel
(``fused_sample_tokens``). On a CPU device the wrappers run their plain
PyTorch versions.

Not in this slice (see ROADMAP.md): tiered KV, speculative decoding, fused
prefill, tp, disaggregation, migration, telemetry spans and the
double-buffered ``pump`` loop. Each keyword of the TPU package's
``ServingEngine`` that selects one of them raises ``NotImplementedError``
naming its ROADMAP item when set away from its default
(:data:`NOT_PORTED_KNOBS`); nothing is silently dropped.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..runtime.engine import _not_ported
from ..utils.logging import log_dist
from .kv_cache import SlotKVCacheManager
from .metrics import ServingMetrics
from .paged_kv import PagedAdmitPlan, PagedKVCacheManager
from .sampling import fused_sample_tokens, sample_tokens
from .scheduler import ContinuousBatchScheduler, Request


# The TPU package's ServingEngine keywords this port does not have yet:
# name -> (the TPU engine's default, the ROADMAP item that ports it).
NOT_PORTED_KNOBS = {
    "speculative": (False, "A1"),
    "spec_k": (4, "A1"),
    "spec_ngram": (2, "A1"),
    "drafter": (None, "A1"),
    "fused_prefill": (False, "A7"),
    "prefill_chunk": (16, "A7"),
    "chunk_token_budget": (None, "A7"),
    "sp_prefill_threshold": (None, "A9"),
    "monitor": (None, "A11"),
    "emit_every_steps": (16, "A11"),
    "tp": (1, "A11"),
    "disaggregate_prefill": (False, "A11"),
    "tiered_kv": (False, "A11"),
    "tier_dram_bytes": (256 << 20, "A11"),
    "tier_nvme_bytes": (None, "A11"),
    "tier_spill_dir": (None, "A11"),
    "tuned_config": (None, "A11"),
}


def _reject_not_ported(kwargs: dict) -> None:
    """Pop the not-ported knobs from ``kwargs``; raise on one set away from
    its default."""
    for name, (default, item) in NOT_PORTED_KNOBS.items():
        if name not in kwargs:
            continue
        value = kwargs.pop(name)
        if value is not default and value != default:
            raise _not_ported(f"ServingEngine({name}={value!r})", item)


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
    every value.

    ``paged=True`` serves from a block pool of ``kv_pool_blocks`` blocks of
    ``kv_block_size`` positions (default: as many positions as the dense
    arena), with the prefix cache (``prefix_cache_capacity`` entries) on
    when ``prefix_cache`` and greedy sampling (temperature 0). Greedy
    outputs equal the dense arena's. ``kv_dtype="int8"`` quantizes the KV
    cache (either layout) to int8 with per-position f32 scales.

    The TPU engine's other keywords (:data:`NOT_PORTED_KNOBS`) raise
    ``NotImplementedError`` when set away from their defaults; with
    ``engine=``, any other leftover keyword raises ``TypeError``."""

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
                 paged: bool = False,
                 kv_block_size: int = 16,
                 kv_pool_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefix_cache_capacity: int = 64,
                 kv_dtype: str = "auto",
                 **inference_kwargs):
        _reject_not_ported(inference_kwargs)
        if engine is not None and inference_kwargs:
            raise TypeError(
                f"ServingEngine(engine=...) got keywords it does not take: "
                f"{sorted(inference_kwargs)} (the InferenceEngine keywords "
                f"apply only when it builds the engine)")
        if engine is None:
            from ..inference.engine import InferenceEngine
            engine = InferenceEngine(model, model_parameters=model_parameters,
                                     **inference_kwargs)
        self.engine = engine
        self.device = engine.device
        self.module = engine.module
        cfg = self.module.cfg
        self.kv_dtype = str(kv_dtype)
        if self.kv_dtype not in ("auto", "int8"):
            raise ValueError(f"kv_dtype must be 'auto' or 'int8', "
                             f"got {kv_dtype!r}")
        if self.kv_dtype == "int8" and cfg.kv_cache_dtype != "int8":
            # the module rebuilt with the int8 cache config over the same
            # parameter tensors (no copy), as the TPU engine rebuilds it
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
            module = type(self.module)(cfg, device="meta")
            module.load_state_dict(self.module.state_dict(), assign=True)
            self.module = module
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
        self.paged = bool(paged)
        if self.paged:
            # prefix reuse replays a stored first token, which is faithful
            # only when sampling is deterministic: greedy only
            self.kv = PagedKVCacheManager(
                cfg, self.max_batch, self.device, block_size=kv_block_size,
                num_blocks=kv_pool_blocks,
                prefix_cache_capacity=prefix_cache_capacity,
                prefix_caching=prefix_cache and self.temperature == 0.0)
        else:
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
                 f"paged={self.paged} kv_dtype={self.kv_dtype} "
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
        one batched prefill and one arena insert per group. Paged:
        prefix-cache hits skip prefill (a fork and the cached first token)
        and are enqueued before the misses' prefills, so a fork's copy
        precedes anything that could recycle its source block."""
        admitted = self.scheduler.admit()
        plans: Dict[int, PagedAdmitPlan] = {}
        if self.paged:
            misses = []
            for req in admitted:
                plan = self.kv.take_plan(req.slot)
                if plan.hit:
                    self._admit_prefix_hit(req, plan)
                else:
                    plans[req.slot] = plan
                    misses.append(req)
            admitted = misses
        groups: Dict[int, List[Request]] = {}
        for req in admitted:
            groups.setdefault(self._bucket_for(req.prompt_len),
                              []).append(req)
        for bucket, reqs in sorted(groups.items()):
            self._prefill(bucket, reqs, plans)

    @torch.inference_mode()
    def _admit_prefix_hit(self, req: Request, plan: PagedAdmitPlan) -> None:
        """A cached prompt: share its full blocks, copy its tail, replay the
        stored first token. No prefill runs."""
        self.kv.apply_fork(plan)
        self.metrics.on_prefix(True)
        if plan.cow is not None:
            self.metrics.on_cow()
        first = int(plan.first_token)
        self._last_token[req.slot] = first
        self.metrics.on_tokens(1)
        self.scheduler.record_first_token(req, first)

    @torch.inference_mode()
    def _prefill(self, bucket: int, reqs: List[Request],
                 plans: Dict[int, PagedAdmitPlan]) -> None:
        n = len(reqs)
        ids = np.zeros((n, bucket), np.int64)
        lens = np.empty(n, np.int64)
        for i, r in enumerate(reqs):
            ids[i, :r.prompt_len] = r.prompt
            lens[i] = r.prompt_len
        self._prefill_shapes.add((n, bucket))
        dev = self.device
        # (hidden, keys, values) or, under the int8 cache, also the scales
        hidden, *kv = self.module.prefill(torch.from_numpy(ids).to(dev))
        last = hidden[torch.arange(n, device=dev),
                      torch.from_numpy(lens - 1).to(dev)]
        toks = self._sample(self.module.logits(last), self._generator,
                            self.temperature, self.top_k, self.top_p)
        self.kv.insert_batch(*kv[:2], [r.slot for r in reqs], *kv[2:])
        toks_host = toks.cpu().numpy()
        self.metrics.on_prefill(n, bucket, int(lens.sum()),
                                len(self._prefill_shapes))
        self.metrics.on_tokens(n)
        for i, r in enumerate(reqs):
            first = int(toks_host[i])
            self._last_token[r.slot] = first
            plan = plans.get(r.slot)
            if plan is not None:
                # publish the prompt blocks before the request can retire
                # (retiring drops its refs; the cache holds its own); may
                # enqueue the tail's copy
                cow = self.kv.commit_prefix(plan, first)
                if self.kv.prefix_enabled:
                    self.metrics.on_prefix(False)
                if cow is not None:
                    self.metrics.on_cow()
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
                decode_impl=self._decode_impl,
                block_tables=self.kv.block_tables, k_scale=self.kv.k_scale,
                v_scale=self.kv.v_scale)
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
