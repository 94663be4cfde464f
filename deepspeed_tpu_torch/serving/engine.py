"""ServingEngine: continuous-batching server over the inference stack.

Counterpart of ``deepspeed_tpu/serving/engine.py`` (dense and paged arenas,
bf16/f32 or int8 KV, speculative decoding, the double-buffered serve loop).
It composes

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
  decode   ``decode_chunk`` (K) decode steps per launch over all
           ``max_batch`` lanes: sampling, per-slot EOS / token-budget stop
           masking and KV writes stay on the device; retired lanes pin their
           write index past the arena (the model drops the write). The
           host reads the token buffer once per chunk and hands it to the
           scheduler. ``speculative=True`` makes each step draft k tokens
           per lane from its history (serving/speculative.py), score all
           k + 1 positions in one forward and emit the accepted prefix plus
           one correction or bonus token.

``run()`` double-buffers whenever ``decode_chunk > 1`` or speculative: the
next chunk is launched from the previous chunk's device-carried state before
the host waits for the previous chunk's tokens, so the host's bookkeeping
overlaps the card's work. ``pump()`` is one iteration of that loop for an
external driver; ``cancel()`` retires a request at once on the host and
deactivates its lane at the next launch. A launch issues work and returns:
no host read of device data inside it (tokens reach pinned host memory
behind a recorded CUDA event, host corrections go up the same way).

Paged admission: a prefix-cache hit (an exact repeat of a cached prompt,
greedy only) skips prefill: its full prompt blocks are shared, its partial
tail block is copied, and the cached first token seeds decode. Hit forks are
enqueued before the misses' prefill inserts (one stream: enqueue order is
write order), and each miss publishes its prompt blocks after its first
token, before the request can retire.

``megakernel=True`` routes every decode step's attention through the
hand-written decode kernels (``decode_impl="auto"``: dense or paged, int8 or
not, at s_q = 1 or the k + 1 verify width), every sampling call through the
sort-free sampling kernel (``fused_sample_tokens``) and the speculative
verifier's filter through the same kernel (``fused_filter_logits``). On a
CPU device the wrappers run their plain PyTorch versions.

Not in this slice (see ROADMAP.md): CUDA-graph capture of a chunk, tiered
KV, fused prefill (with or without speculative decoding), tp,
disaggregation, migration and telemetry spans. Each keyword of the TPU
package's ``ServingEngine`` that selects one of them raises
``NotImplementedError`` naming its ROADMAP item when set away from its
default (:data:`NOT_PORTED_KNOBS`); nothing is silently dropped.
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
from .sampling import fused_filter_logits, fused_sample_tokens, sample_tokens
from .scheduler import ContinuousBatchScheduler, Request
from .speculative import NGramDrafter, verify_greedy, verify_rejection


# The TPU package's ServingEngine keywords this port does not have yet:
# name -> (the TPU engine's default, the ROADMAP item that ports it).
NOT_PORTED_KNOBS = {
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


@dataclasses.dataclass
class _InflightChunk:
    """One launched decode chunk (the TPU engine's ``_InflightChunk``,
    deepspeed_tpu/serving/engine.py:90): the slot -> request-uid snapshot
    at launch, so tokens are never credited to a slot's next occupant; the
    token and valid buffers, on a CUDA device pinned host copies that land
    behind ``ready``; and the device carry the next chunk launches from."""
    slot_uids: Dict[int, int]
    tokens: torch.Tensor     # [B, K] ([B, K*(k+1)] speculative)
    valid: torch.Tensor      # same shape: the token is real output
    state: Tuple             # tok, pos, act, rem, eos [B] (+ hist [B, S+1])
    ready: Optional[torch.cuda.Event]
    wall_t0: float           # host clock at launch


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
    number of decode steps per launch; greedy outputs are identical for
    every value. With ``decode_chunk > 1`` or ``speculative``, ``run()`` is
    double-buffered (see :meth:`pump`); ``cancel(req)`` ends a request.

    ``speculative=True`` drafts ``spec_k`` tokens per lane and step by
    prompt lookup over ``spec_ngram``-grams (or with ``drafter``, any object
    with ``k`` and ``propose(hist, tok, pos)``) and verifies them in one
    k + 1-token forward: greedy outputs equal the non-speculative engine's;
    sampled outputs follow the same distribution (rejection resampling).

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
                 speculative: bool = False,
                 spec_k: int = 4,
                 spec_ngram: int = 2,
                 drafter=None,
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
        self.speculative = bool(speculative)
        if self.speculative:
            self.drafter = (drafter if drafter is not None
                            else NGramDrafter(spec_k, spec_ngram))
            self.spec_k = int(self.drafter.k)
        else:
            self.drafter = None
            self.spec_k = 0
        # the verifier's filter: the sampling kernel under the megakernel
        self._spec_filter = fused_filter_logits if self.megakernel else None
        # the TPU engine's rule (engine.py:351): the chunked, double-buffered
        # loop whenever a launch holds more than one step or verifies drafts
        self._chunked = self.decode_chunk > 1 or self.speculative
        self.paged = bool(paged)
        # a verify step reads and writes k + 1 positions from a lane's fill:
        # the arena holds spec_k positions past max_seq_len, so no lane's
        # cache length is ever clamped (kv_cache.py, paged_kv.py)
        if self.paged:
            # prefix reuse replays a stored first token, which is faithful
            # only when sampling is deterministic: greedy only
            self.kv = PagedKVCacheManager(
                cfg, self.max_batch, self.device, block_size=kv_block_size,
                num_blocks=kv_pool_blocks,
                prefix_cache_capacity=prefix_cache_capacity,
                prefix_caching=prefix_cache and self.temperature == 0.0,
                lookahead=self.spec_k)
            self._kv_extent = (self.kv.block_tables.shape[1]
                               * self.kv.block_size)
        else:
            self.kv = SlotKVCacheManager(cfg, self.max_batch, self.device,
                                         lookahead=self.spec_k)
            self._kv_extent = self.kv.cache_k.shape[2]
        self.scheduler = ContinuousBatchScheduler(
            self.kv.allocator, max_queue=max_queue,
            max_prompt_len=self.max_prompt_len)
        self.metrics = ServingMetrics()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))
        self._last_token = np.zeros(self.max_batch, np.int32)
        # distinct (batch, bucket) prefill shapes seen so far
        self._prefill_shapes: Set[Tuple[int, int]] = set()
        # host corrections to the device-carried chunk state, applied at
        # the next launch (_device_state)
        self._deact_slots: Set[int] = set()
        self._admit_patches: Dict[int, Tuple] = {}
        # the at-most-one launched, unconsumed chunk of the pipelined loop
        self._pending: Optional[_InflightChunk] = None
        log_dist(f"serving engine ready: slots={self.max_batch} "
                 f"prefill_buckets={self._buckets} "
                 f"decode_chunk={self.decode_chunk} "
                 f"max_seq={self.max_seq_len} megakernel={self.megakernel} "
                 f"paged={self.paged} kv_dtype={self.kv_dtype} "
                 f"speculative={self.speculative} spec_k={self.spec_k} "
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

    def cancel(self, req: Request) -> bool:
        """Caller-initiated termination (deepspeed_tpu/serving/engine.py:956):
        a queued request never prefills; a running one frees its slot at
        once (host side) and its device lane is deactivated at the next
        chunk launch (``_deact_slots``), so at most one chunk of device work
        is wasted, and none of it is delivered: the launch-time slot -> uid
        snapshot drops tokens from retired occupants. Returns False if the
        request was already terminal.

        Paged arena: the freed blocks may be leased again while a launched
        chunk still writes the cancelled lane through its old table. All
        device work goes to one stream in enqueue order, and every insert,
        fork copy or table install for a new owner is enqueued after that
        chunk, so it overwrites the stale writes; a stale write at or past
        the new owner's fill stays masked until the owner's own decode
        writes that position (the argument that covers rejected drafts)."""
        slot = req.slot if req.status == "running" else None
        cancelled = self.scheduler.cancel(req)
        if cancelled and slot is not None:
            self._deact_slots.add(slot)
            self._admit_patches.pop(slot, None)
        return cancelled

    def pump(self) -> List[Request]:
        """One iteration of the double-buffered serve loop for external
        drivers (deepspeed_tpu/serving/engine.py:1141): admit, keep one
        chunk in flight, and return every request that reached a terminal
        state during the call. The in-flight chunk carries over between
        calls: the next chunk is launched from its device-carried state
        before the host waits for its tokens. Call until ``has_work()`` is
        False and ``chunk_in_flight`` is False to drain."""
        before = len(self.scheduler.finished)
        if not self._chunked:
            self.step()
            return self.scheduler.finished[before:]
        if self._pending is None:
            self._admit()
            if self.scheduler.running:
                self._pending = self._launch_chunk(self._host_state())
            return self.scheduler.finished[before:]
        nxt = None
        if self._may_outlive_chunk():
            nxt = self._launch_chunk(self._device_state(self._pending))
        self._consume_chunk(self._pending)
        self._admit()
        self._pending = nxt
        return self.scheduler.finished[before:]

    @property
    def chunk_in_flight(self) -> bool:
        """True while a launched decode chunk has not been consumed
        (deepspeed_tpu/serving/engine.py:1169): drain loops keep pumping
        until this clears even after the scheduler reports no work."""
        return self._pending is not None

    def step(self) -> List[Request]:
        """One synchronous continuous-batching iteration: admit
        newly-runnable requests (bucketed prefill + arena insert), then one
        K-step decode chunk over all live slots, launched from the host's
        state and consumed at once. Returns the requests finished in this
        iteration."""
        before = len(self.scheduler.finished)
        self._admit()
        if self.scheduler.running:
            self._consume_chunk(self._launch_chunk(self._host_state()))
        return self.scheduler.finished[before:]

    def run(self, prompts: Optional[Sequence] = None,
            **request_kwargs) -> List[Request]:
        """Serve until drained. ``prompts``: token-id sequences (or Request
        objects) submitted up front; ``request_kwargs`` (max_new_tokens,
        eos_token_id, deadline_s) apply to all of them. With
        ``decode_chunk > 1`` or ``speculative`` the loop is double-buffered
        (:meth:`pump`). Returns the submitted requests in submission order
        (rejected ones included, flagged by status)."""
        submitted = [self.submit(p, **request_kwargs)
                     for p in (prompts or [])]
        if self._chunked:
            self._serve_pipelined()
        else:
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
        if self._chunked:
            self._record_admit_patch(req)

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
            if self._chunked:
                self._record_admit_patch(r)

    def _record_admit_patch(self, req: Request) -> None:
        """Lane state of a freshly admitted request for the next launch
        from device-carried state (deepspeed_tpu/serving/engine.py:1628):
        its first token, fill, token budget, EOS id and, speculative, its
        history row. A request retired on its first token keeps its lane
        dead instead."""
        slot = req.slot
        if req.status == "running":
            rem = min(req.max_new_tokens - len(req.tokens),
                      self.kv.allocator.remaining(slot))
            eos = -1 if req.eos_token_id is None else int(req.eos_token_id)
            patch = (int(req.tokens[-1]), req.prompt_len, rem, eos)
            if self.speculative:
                # the drafter mines the lane's full history: the prompt and
                # the first token
                patch = patch + (self._history_row(req),)
            self._admit_patches[slot] = patch
            self._deact_slots.discard(slot)
        else:
            self._admit_patches.pop(slot, None)
            self._deact_slots.add(slot)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a host wait: on a
        CUDA device through a pinned copy, asynchronously (the caching host
        allocator keeps the pinned block until the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        """Start the copy of a device buffer to pinned host memory; read it
        only after the chunk's ``ready`` event."""
        if t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _history_row(self, req: Request) -> np.ndarray:
        """One lane's token history (prompt + emitted) padded to
        ``max_seq_len`` + 1 (deepspeed_tpu/serving/engine.py:1741): the
        drafter's corpus. Column ``max_seq_len`` is the sink of the chunk's
        dropped history writes and is never read. Invariant:
        ``row[fill] == last_token``."""
        S = self.max_seq_len
        row = np.zeros(S + 1, np.int64)
        seq = list(np.asarray(req.prompt).tolist()) + \
            [int(t) for t in req.tokens]
        n = min(len(seq), S)
        row[:n] = seq[:n]
        return row

    @torch.inference_mode()
    def _host_state(self) -> Tuple:
        """Chunk-input lane state rebuilt from the scheduler and allocator
        mirrors (deepspeed_tpu/serving/engine.py:1692), on the device.
        Authoritative: pending patches are subsumed."""
        B = self.max_batch
        tokens = np.zeros(B, np.int64)
        positions = np.zeros(B, np.int64)
        active = np.zeros(B, bool)
        remaining = np.zeros(B, np.int64)
        eos = np.full(B, -1, np.int64)
        hist = (np.zeros((B, self.max_seq_len + 1), np.int64)
                if self.speculative else None)
        for slot, req in self.scheduler.running.items():
            tokens[slot] = self._last_token[slot]
            positions[slot] = self.kv.fill[slot]
            remaining[slot] = min(req.max_new_tokens - len(req.tokens),
                                  self.kv.allocator.remaining(slot))
            active[slot] = True
            if req.eos_token_id is not None:
                eos[slot] = int(req.eos_token_id)
            if hist is not None:
                hist[slot] = self._history_row(req)
        self._deact_slots.clear()
        self._admit_patches.clear()
        arrays = (tokens, positions, active, remaining, eos)
        if hist is not None:
            arrays = arrays + (hist,)
        return tuple(self._upload(a) for a in arrays)

    @torch.inference_mode()
    def _device_state(self, chunk: _InflightChunk) -> Tuple:
        """Chunk-input state carried on the device from the previous chunk
        (no host read), with the host's corrections patched in
        (deepspeed_tpu/serving/engine.py:1752): lanes the scheduler retired
        for its own reasons (deadline, cancel) go inactive; fresh
        admissions get their whole lane state (``_admit_patches``)."""
        tok, pos, act, rem, eos = chunk.state[:5]
        hist = chunk.state[5] if self.speculative else None
        if self._deact_slots:
            idx = self._upload(np.array(sorted(self._deact_slots), np.int64))
            act = act.index_fill(0, idx, False)
        if self._admit_patches:
            slots = sorted(self._admit_patches)
            vals = [self._admit_patches[s] for s in slots]
            # one upload: slot, token, fill, budget, eos per row
            cols = self._upload(np.array([(s,) + tuple(v[:4])
                                          for s, v in zip(slots, vals)],
                                         np.int64))
            idx = cols[:, 0]
            tok = tok.index_copy(0, idx, cols[:, 1])
            pos = pos.index_copy(0, idx, cols[:, 2])
            rem = rem.index_copy(0, idx, cols[:, 3])
            eos = eos.index_copy(0, idx, cols[:, 4])
            act = act.index_fill(0, idx, True)
            if hist is not None:
                hist = hist.index_copy(0, idx, self._upload(
                    np.stack([v[4] for v in vals])))
        self._deact_slots.clear()
        self._admit_patches.clear()
        out = (tok, pos, act, rem, eos)
        return out if hist is None else out + (hist,)

    @torch.inference_mode()
    def _launch_chunk(self, state: Tuple) -> _InflightChunk:
        """Enqueue one K-step decode chunk from ``state`` and return at once
        (deepspeed_tpu/serving/engine.py:1807): the token and valid buffers
        start their copies to pinned host memory behind a recorded event,
        which :meth:`_consume_chunk` waits on. Nothing here reads device
        data on the host."""
        wall_t0 = time.perf_counter()
        if self.speculative:
            toks, valid, carry = self._spec_chunk(*state)
        else:
            toks, valid, carry = self._plain_chunk(*state)
        toks, valid = self._to_host(toks), self._to_host(valid)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return _InflightChunk(
            slot_uids={s: r.uid for s, r in self.scheduler.running.items()},
            tokens=toks, valid=valid, state=carry, ready=ready,
            wall_t0=wall_t0)

    def _decode(self, inputs, positions, write_pos) -> torch.Tensor:
        """``GPT.decode`` over this engine's arena: logits [B, s, V]."""
        kv = self.kv
        return self.module.decode(
            inputs, positions, kv.cache_k, kv.cache_v, write_pos,
            decode_impl=self._decode_impl, block_tables=kv.block_tables,
            k_scale=kv.k_scale, v_scale=kv.v_scale)

    def _plain_chunk(self, tok, pos, act, rem, eos):
        """K one-token decode steps over all lanes (the TPU package's
        ``decode_chunk_fn`` scan, deepspeed_tpu/serving/engine.py:583, as a
        loop). Returns (tokens [B, K], valid [B, K], carry)."""
        S, W = self.max_seq_len, self._kv_extent
        toks, valid = [], []
        for _ in range(self.decode_chunk):
            write_pos = torch.where(act, pos, W)        # masked lanes drop
            logits = self._decode(tok[:, None],
                                  pos.clamp(max=S - 1)[:, None], write_pos)
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
        return (torch.stack(toks, dim=1), torch.stack(valid, dim=1),
                (tok, pos, act, rem, eos))

    def _spec_chunk(self, tok, pos, act, rem, eos, hist):
        """The speculative chunk (the TPU package's ``decode_chunk_spec_fn``,
        deepspeed_tpu/serving/engine.py:616-693, as a loop of K steps). Each
        step drafts k tokens per lane from its history, scores all k + 1
        positions in one ``GPT.decode`` and emits the accepted prefix plus
        the correction or bonus token: up to k + 1 tokens a lane. The
        accepted length n advances ``pos``; the KV rows written for rejected
        drafts sit above the new fill, dead (masked by every later read)
        until a later step overwrites them. The TPU scan's dropped writes
        (``mode="drop"``) go to sinks here: history column ``max_seq_len``,
        and for the cache the write index past the arena (dense: dropped by
        ``_kv_write``; paged: the sink block of ``paged_write_index``).
        Returns (tokens [B, K*(k+1)], valid [B, K*(k+1)], carry)."""
        B, k, S = self.max_batch, self.spec_k, self.max_seq_len
        W = self._kv_extent
        kp1 = k + 1
        dev = tok.device
        rows = torch.arange(B, device=dev)
        j = torch.arange(kp1, device=dev)[None, :]
        hist = hist.clone()                  # the chunk writes its own copy
        toks, valid = [], []
        for _ in range(self.decode_chunk):
            # the invariant hist[b, pos[b]] == tok[b] (idempotent after the
            # first step; admissions are patched in by the host)
            hist[rows, torch.where(act, pos, S)] = tok
            drafts = self.drafter.propose(hist[:, :S], tok, pos).to(
                tok.dtype)                                   # [B, k]
            inputs = torch.cat([tok[:, None], drafts], dim=1)
            write_pos = torch.where(act, pos, W)
            # positions past the model's table are clamped, as the TPU
            # package's embedding gather clamps them; only queries of
            # rejected or dead columns sit there
            qpos = (pos[:, None] + j).clamp(max=S - 1)
            logits = self._decode(inputs, qpos, write_pos)  # [B, k+1, V]
            if self.temperature == 0.0:
                emitted, acc = verify_greedy(logits, drafts)
            else:
                emitted, acc = verify_rejection(
                    logits, drafts, self._generator, self.temperature,
                    self.top_k, self.top_p, filter_fn=self._spec_filter)
            # candidate validity: live lane, within the accepted prefix
            # (+ the correction/bonus at j == acc), within the budget
            cand = act[:, None] & (j <= acc[:, None]) & (j < rem[:, None])
            hit = (eos[:, None] >= 0) & (emitted == eos[:, None])
            cut = (cand & hit).long()
            prior_hits = cut.cumsum(dim=1) - cut
            ok = cand & (prior_hits == 0)           # stop after first EOS
            n = ok.long().sum(dim=1)                                 # [B]
            last = torch.gather(emitted, 1,
                                (n - 1).clamp(0, k)[:, None])[:, 0]
            tok_n = torch.where(n > 0, last, tok)
            stopped = (ok & hit).any(dim=1)
            rem = rem - n
            act = act & (rem > 0) & ~stopped
            # emitted token j lands at history index pos + 1 + j
            hist[rows[:, None], torch.where(ok, pos[:, None] + 1 + j, S)] = \
                emitted
            pos = pos + n
            tok = tok_n
            toks.append(emitted)
            valid.append(ok)
        return (torch.stack(toks, dim=1).reshape(B, -1),
                torch.stack(valid, dim=1).reshape(B, -1),
                (tok, pos, act, rem, eos, hist))

    @torch.inference_mode()
    def _consume_chunk(self, chunk: _InflightChunk) -> List[Request]:
        """Wait for the chunk's token buffer (the one host wait per chunk)
        and feed it through the scheduler (deepspeed_tpu/serving/
        engine.py:1870). Tokens of a slot whose occupant changed since the
        launch are dropped; speculative acceptance is counted from the
        valid mask."""
        if chunk.ready is not None:
            chunk.ready.synchronize()
        toks = chunk.tokens.numpy()
        valid = chunk.valid.numpy()
        seconds = time.perf_counter() - chunk.wall_t0
        fin_before = len(self.scheduler.finished)
        per_slot: Dict[int, List[int]] = {}
        for slot, uid in chunk.slot_uids.items():
            req = self.scheduler.running.get(slot)
            if req is None or req.uid != uid:
                continue        # slot retired or re-leased since the launch
            seq = [int(t) for t, v in zip(toks[slot], valid[slot]) if v]
            if seq:
                per_slot[slot] = seq
                self._last_token[slot] = seq[-1]
        self.scheduler.step_tokens_chunk(per_slot)
        finished = self.scheduler.finished[fin_before:]
        if self.speculative:
            # a step is live iff its first column (the correction or bonus
            # token, always valid on a live lane) is; accepted drafts are
            # the valid tokens beyond that one
            v3 = valid.reshape(self.max_batch, -1, self.spec_k + 1)
            live = v3[:, :, 0]
            accepted = int(np.maximum(
                np.where(live, v3.sum(axis=2), 0) - live, 0).sum())
            self.metrics.on_spec(int(live.sum()) * self.spec_k, accepted)
        self.metrics.on_tokens(sum(len(v) for v in per_slot.values()))
        self.metrics.on_decode_step(seconds)
        self.metrics.on_finished(finished)
        for req in finished:
            if req.slot is not None:
                self._deact_slots.add(req.slot)
        return finished

    def _may_outlive_chunk(self) -> bool:
        """Could any lane still be live after the in-flight chunk
        (deepspeed_tpu/serving/engine.py:2071)? The host mirrors are
        pre-chunk here, and every live step emits at least one token, so a
        lane survives only if its remaining budget exceeds K. Gates the
        next launch so the drain tail pays no dead chunk."""
        K = self.decode_chunk
        for slot, req in self.scheduler.running.items():
            rem = min(req.max_new_tokens - len(req.tokens),
                      self.kv.allocator.remaining(slot))
            if rem > K:
                return True
        return False

    def _serve_pipelined(self) -> None:
        """The double-buffered host loop (deepspeed_tpu/serving/
        engine.py:2088): keep one chunk in flight and launch its successor
        from device-carried state before waiting on its tokens. Host-only
        events (cancellation, deadlines, admissions) take effect one chunk
        late; device-detected stops (EOS, budget) at once through the
        carried active mask. One :meth:`pump` per iteration."""
        while self.scheduler.has_work() or self._pending is not None:
            self.pump()
