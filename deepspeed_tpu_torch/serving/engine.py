"""ServingEngine: continuous-batching server over the inference stack.

Counterpart of ``deepspeed_tpu/serving/engine.py`` (dense and paged arenas,
bf16/f32 or int8 KV, speculative decoding, fused chunked prefill, the
double-buffered serve loop). It composes

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
  fused    ``fused_prefill=True`` (Sarathi-style chunked prefill, the TPU
           engine's ``decode_chunk_fused_fn``): no bucketed prefill runs.
           An admitted prompt enters the decode loop in prefill mode and
           each step consumes its next ``prefill_chunk`` (C) tokens through
           the same C-wide ``GPT.decode`` that serves the decoding lanes
           (their token broadcast across the columns, sampled at column 0);
           the step that consumes a prompt's last chunk samples token #1 at
           its last real column. ``chunk_token_budget`` caps the tokens a
           step takes (prompt chunks plus decode tokens) and so paces
           admission. With ``speculative`` the step is max(C, k + 1) wide
           (greedy only).

``run()`` double-buffers whenever ``decode_chunk > 1``, speculative or
fused: the next chunk is launched from the previous chunk's device-carried
state before the host waits for the previous chunk's tokens, so the host's
bookkeeping overlaps the card's work. ``pump()`` is one iteration of that
loop for an external driver; ``cancel()`` retires a request at once on the
host and deactivates its lane at the next launch. A launch issues work and
returns: no host read of device data inside it (tokens reach pinned host
memory behind a recorded CUDA event, host corrections go up the same way).

Paged admission: a prefix-cache hit (an exact repeat of a cached prompt,
greedy only) skips prefill: its full prompt blocks are shared, its partial
tail block is copied, and the cached first token seeds decode. Hit forks are
enqueued before the misses' prefill inserts (one stream: enqueue order is
write order), and each miss publishes its prompt blocks after its first
token, before the request can retire.

``megakernel=True`` routes every decode step's attention through the
hand-written decode kernels (``decode_impl="auto"``: dense or paged, int8 or
not, at s_q = 1, the k + 1 verify width or the fused step's width), every
sampling call through the sort-free sampling kernel
(``fused_sample_tokens``) and the speculative verifier's filter through the
same kernel (``fused_filter_logits``). On a CPU device the wrappers run
their plain PyTorch versions.

An MoE model (``GPTConfig(moe=True)``) serves in every mode: each prefill,
decode, verify and fused step routes every row it runs (bucket padding,
idle lanes, pad columns) at the eval capacity with no random draw, as the
TPU engine's ``deterministic`` calls do; ``GPT.decode`` and
``GPT.prefill`` return no aux loss, so there is nothing to unwrap. An
engine over ``ep_size > 1`` raises (ROADMAP A9).

``tp=n`` serves a model split over n tensor-parallel ranks (the
``InferenceEngine``'s ``mp_size``; every rank runs the engine on the same
requests): the arenas hold each rank's heads, the gathered logits are
whole and bitwise alike on every rank, so the scheduler, the sampler (its
generator seeded alike) and the prefix cache decide alike everywhere. A
disagreement would stall the next collective. Unlike the TPU engine's, the
megakernel switch does not turn the model's ``tp_overlap`` on: the model's
config says (over gloo the split is three collectives for one).

``sp_prefill_threshold=n`` sends every prompt of n tokens or more through
one bucketed prefill instead of the inline chunks or the plain prefill; the
lane then joins the decode chunks in decode mode. The TPU engine runs that
prefill through a ``sequence_parallel`` copy of its model, but its mesh,
like this one's, has sp 1 there, where that layout is the identity: the
model's own prefill computes the same, so the route runs that.

Not in this slice (see ROADMAP.md): CUDA-graph capture of a chunk, tiered
KV, disaggregation, migration and telemetry spans. Each keyword of the TPU
package's ``ServingEngine`` that selects one of them raises
``NotImplementedError`` naming its ROADMAP item when set away from its
default (:data:`NOT_PORTED_KNOBS`); nothing is silently dropped.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

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
    "monitor": (None, "A11"),
    "emit_every_steps": (16, "A11"),
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
    tokens: torch.Tensor     # [B, K] ([B, K*(k+1)] speculative, [B, K*W]
    #                          fused speculative)
    valid: torch.Tensor      # same shape: the token is real output
    state: Tuple             # tok, pos, act, rem, eos [B] (+ pf [B] fused)
    #                          (+ hist [B, S+1] speculative)
    ready: Optional[torch.cuda.Event]
    wall_t0: float           # host clock at launch


def _with_config(module, cfg):
    """A copy of ``module`` whose submodules hold ``cfg`` in place of the
    module's config, over the same parameter and buffer tensors (no copy;
    tp-split and int8 layers included)."""
    old = module.cfg
    memo = {id(t): t for t in list(module.parameters())
            + list(module.buffers())}
    memo[id(old)] = old
    new = copy.deepcopy(module, memo)
    for m in new.modules():
        if getattr(m, "cfg", None) is old:
            m.cfg = cfg
    return new


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

    ``fused_prefill=True`` consumes prompts ``prefill_chunk`` tokens a step
    inside the decode chunk instead of in a bucketed prefill (clamped to
    ``max_prompt_len``), admitting against ``chunk_token_budget`` tokens a
    step (default 2 * prefill_chunk + max_batch); greedy outputs equal the
    bucketed engine's.

    ``sp_prefill_threshold``: prompts of that many tokens or more skip the
    inline chunks (or the plain prefill) and run one bucketed prefill,
    then decode; a fused step prices admitting one at a decode token
    (``_lane_cost``). ``sp_prefill_tokens`` counts their prompt tokens.

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
                 fused_prefill: bool = False,
                 prefill_chunk: int = 16,
                 chunk_token_budget: Optional[int] = None,
                 sp_prefill_threshold: Optional[int] = None,
                 tp: int = 1,
                 **inference_kwargs):
        _reject_not_ported(inference_kwargs)
        if engine is not None and inference_kwargs:
            raise TypeError(
                f"ServingEngine(engine=...) got keywords it does not take: "
                f"{sorted(inference_kwargs)} (the InferenceEngine keywords "
                f"apply only when it builds the engine)")
        if engine is None:
            from ..inference.engine import InferenceEngine
            if int(tp) > 1:
                # the serving tp rides the inference engine's mp_size
                inference_kwargs.setdefault("mp_size", int(tp))
            engine = InferenceEngine(model, model_parameters=model_parameters,
                                     **inference_kwargs)
        if getattr(engine, "ep_world_size", 1) > 1:
            raise _not_ported(
                f"ServingEngine over an InferenceEngine(ep_size="
                f"{engine.ep_world_size})", "A9")
        self.tp = int(getattr(engine, "mp_world_size", 1))
        if int(tp) > 1 and self.tp != int(tp):
            raise ValueError(
                f"tp={tp} requested but the engine's mesh has tp={self.tp} "
                f"(pass mp_size={tp} when building the InferenceEngine, or "
                f"drop the engine= argument)")
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
            self.module = _with_config(self.module, cfg)
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
        # fused chunked prefill (the TPU engine's checks, engine.py:289-320)
        self.fused_prefill = bool(fused_prefill)
        self.prefill_chunk = min(int(prefill_chunk), self.max_prompt_len)
        if self.fused_prefill and self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if self.fused_prefill and speculative and self.temperature != 0.0:
            raise ValueError(
                "fused_prefill + speculative supports greedy sampling only "
                "(temperature=0): the fused step verifies drafts with the "
                "greedy rule")
        # one token budget a step shared by prompt chunks and decode lanes:
        # by default room for two prompt chunks on top of a full decode
        # batch
        self.chunk_token_budget = (
            int(chunk_token_budget) if chunk_token_budget is not None
            else 2 * self.prefill_chunk + self.max_batch)
        if self.fused_prefill and self.chunk_token_budget < 1:
            raise ValueError(f"chunk_token_budget must be >= 1, got "
                             f"{chunk_token_budget}")
        # prompts at or above the threshold take the sp leg: one bucketed
        # prefill (the TPU engine's prefill_sp_fn, at sp 1), then decode mode
        self.sp_prefill_threshold = (None if sp_prefill_threshold is None
                                     else int(sp_prefill_threshold))
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
        # loop whenever a launch holds more than one step, verifies drafts
        # or carries prompt chunks
        self._chunked = (self.decode_chunk > 1 or self.speculative
                         or self.fused_prefill)
        # a step's width: 1, the verify's k + 1, the fused step's C or, fused
        # and speculative, max(C, k + 1) (spec_k is 0 unless speculative)
        self._width = max(self.prefill_chunk if self.fused_prefill else 1,
                          self.spec_k + 1)
        self.paged = bool(paged)
        if self.paged and any(cfg.window(i) is not None
                              for i in range(cfg.num_layers)):
            # the TPU model raises at its first paged decode step
            raise NotImplementedError(
                "paged KV decode has no local-window path (attn_windows)")
        # a step reads and writes width positions from a lane's fill: the
        # arena holds width - 1 positions past max_seq_len, so no lane's
        # cache length is ever clamped by the decode kernel (kv_cache.py,
        # paged_kv.py)
        lookahead = self._width - 1
        if self.paged:
            # prefix reuse replays a stored first token, which is faithful
            # only when sampling is deterministic: greedy only
            self.kv = PagedKVCacheManager(
                cfg, self.max_batch, self.device, block_size=kv_block_size,
                num_blocks=kv_pool_blocks,
                prefix_cache_capacity=prefix_cache_capacity,
                prefix_caching=prefix_cache and self.temperature == 0.0,
                lookahead=lookahead, tp=self.tp)
            self._kv_extent = (self.kv.block_tables.shape[1]
                               * self.kv.block_size)
        else:
            self.kv = SlotKVCacheManager(cfg, self.max_batch, self.device,
                                         lookahead=lookahead, tp=self.tp)
            self._kv_extent = self.kv.cache_k.shape[2]
        self.scheduler = ContinuousBatchScheduler(
            self.kv.allocator, max_queue=max_queue,
            max_prompt_len=self.max_prompt_len)
        self.metrics = ServingMetrics()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))
        self._last_token = np.zeros(self.max_batch, np.int32)
        # distinct (batch, bucket) prefill shapes seen so far (the sp leg's
        # tagged "sp", as the TPU engine keys its program family)
        self._prefill_shapes: Set[Tuple] = set()
        # host corrections to the device-carried chunk state, applied at
        # the next launch (_device_state)
        self._deact_slots: Set[int] = set()
        self._admit_patches: Dict[int, Tuple] = {}
        # the at-most-one launched, unconsumed chunk of the pipelined loop
        self._pending: Optional[_InflightChunk] = None
        # fused-prefill host mirrors, by slot (deepspeed_tpu/serving/
        # engine.py:463-481). A prefilling lane cannot stop (no EOS or
        # budget before token #1), so the host tracks its prompt cursor
        # without reading the device: _pf_consumed advances when a chunk is
        # consumed, _pf_launched when one is launched (one chunk ahead under
        # the double-buffered loop; the next prompt_buf is built from it)
        self._pf_consumed: Dict[int, int] = {}
        self._pf_launched: Dict[int, int] = {}
        # slots whose token #1 has not been read yet: it goes through
        # scheduler.record_first_token (the time to first token)
        self._pf_first_pending: Set[int] = set()
        # paged misses: the prefix commit waits for token #1
        self._pf_plans: Dict[int, PagedAdmitPlan] = {}
        # prompt tokens consumed inside decode chunks, and by the sp leg
        self.inline_prefill_tokens = 0
        self.sp_prefill_tokens = 0
        log_dist(f"serving engine ready: slots={self.max_batch} "
                 f"prefill_buckets={self._buckets} "
                 f"decode_chunk={self.decode_chunk} "
                 f"max_seq={self.max_seq_len} megakernel={self.megakernel} "
                 f"paged={self.paged} kv_dtype={self.kv_dtype} "
                 f"speculative={self.speculative} spec_k={self.spec_k} "
                 f"fused_prefill={self.fused_prefill} "
                 f"prefill_chunk={self.prefill_chunk} "
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
            self._clear_pf_slot(slot)
        return cancelled

    def _clear_pf_slot(self, slot: int) -> None:
        """Drop a slot's fused-prefill mirrors (deepspeed_tpu/serving/
        engine.py:973): its lane retired, or it was admitted without inline
        prefill. An uncommitted paged miss plan releases its pending-prompt
        key, so an identical prompt can admit again."""
        self._pf_consumed.pop(slot, None)
        self._pf_launched.pop(slot, None)
        self._pf_first_pending.discard(slot)
        plan = self._pf_plans.pop(slot, None)
        if plan is not None:
            self.kv.abandon_plan(plan)

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
        precedes anything that could recycle its source block. Fused: the
        running lanes' step cost is taken from ``chunk_token_budget`` and
        admission fills the rest (an idle engine always admits one), then
        :meth:`_fused_admit`."""
        if self.fused_prefill:
            admitted = self.scheduler.admit(
                token_budget=max(0, self.chunk_token_budget
                                 - self._budget_drain()),
                lane_cost=self._lane_cost)
            if admitted:
                self._fused_admit(admitted)
            return
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
        self._prefill_groups(admitted, plans)

    def _prefill_groups(self, reqs: List[Request],
                        plans: Dict[int, PagedAdmitPlan]) -> None:
        """One bucketed prefill per (bucket, sp leg) group of ``reqs``."""
        groups: Dict[Tuple[int, bool], List[Request]] = {}
        for req in reqs:
            key = (self._bucket_for(req.prompt_len), self._takes_sp(req))
            groups.setdefault(key, []).append(req)
        for (bucket, sp), group in sorted(groups.items()):
            self._prefill(bucket, group, plans, sp)

    def _takes_sp(self, req: Request) -> bool:
        """Whether ``req`` takes the sp prefill leg."""
        return (self.sp_prefill_threshold is not None
                and req.prompt_len >= self.sp_prefill_threshold)

    def _budget_drain(self) -> int:
        """Tokens the running lanes take a fused step
        (deepspeed_tpu/serving/engine.py:1392): a prompt chunk (<= C) while
        a lane prefills, one decode token (k + 1 speculative) after."""
        C = self.prefill_chunk
        base = (1 + self.spec_k) if self.speculative else 1
        drain = 0
        for slot, req in self.scheduler.running.items():
            done = self._pf_consumed.get(slot, req.prompt_len)
            drain += (min(C, req.prompt_len - done)
                      if done < req.prompt_len else base)
        return drain

    def _lane_cost(self, req: Request) -> int:
        """A fused step's cost of admitting ``req`` now: its first prompt
        chunk (deepspeed_tpu/serving/engine.py:1407; a prefix-cache hit is
        known only after the lease and is priced the same), or one decode
        token (k + 1 speculative) when it takes the sp leg and joins in
        decode mode."""
        if self._takes_sp(req):
            return (1 + self.spec_k) if self.speculative else 1
        return min(self.prefill_chunk, req.prompt_len)

    def _fused_admit(self, admitted: List[Request]) -> None:
        """Fused admission (deepspeed_tpu/serving/engine.py:1419): no
        prefill. A lane enters the next chunk in prefill mode at position 0
        with its whole prompt outstanding; a paged miss installs its block
        table now (the chunk writes the prompt's K/V through it) and
        commits its prefix at token #1; a prefix hit forks and replays its
        first token as in the bucketed path, joining in decode mode; a
        prompt for the sp leg runs its bucketed prefill after the loop and
        joins in decode mode too."""
        sp_reqs: List[Request] = []
        sp_plans: Dict[int, PagedAdmitPlan] = {}
        for req in admitted:
            plan = self.kv.take_plan(req.slot) if self.paged else None
            if plan is not None and plan.hit:
                self._admit_prefix_hit(req, plan)
                continue
            if self._takes_sp(req):
                self._clear_pf_slot(req.slot)
                sp_reqs.append(req)
                if plan is not None:
                    sp_plans[req.slot] = plan
                continue
            if plan is not None:
                self.kv.install_table(req.slot)
                self._pf_plans[req.slot] = plan
            self._pf_consumed[req.slot] = 0
            self._pf_launched[req.slot] = 0
            self._pf_first_pending.add(req.slot)
            self._record_fused_admit_patch(req)
        if sp_reqs:
            self._prefill_groups(sp_reqs, sp_plans)

    def _record_fused_admit_patch(self, req: Request) -> None:
        """Lane state of a freshly admitted inline-prefill lane
        (deepspeed_tpu/serving/engine.py:1462): position 0, the whole
        prompt outstanding, nothing emitted; the carried token is unused
        until the completing step samples token #1."""
        slot = req.slot
        rem = min(req.max_new_tokens, self.kv.allocator.remaining(slot))
        eos = -1 if req.eos_token_id is None else int(req.eos_token_id)
        patch = (0, 0, rem, eos, req.prompt_len)
        if self.speculative:
            patch = patch + (self._history_row(req),)
        self._admit_patches[slot] = patch
        self._deact_slots.discard(slot)

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
                 plans: Dict[int, PagedAdmitPlan], sp: bool = False) -> None:
        """The bucketed prefill of ``reqs``; ``sp``: the sp leg's, kept
        apart in the shape set and counted in ``sp_prefill_tokens``."""
        n = len(reqs)
        ids = np.zeros((n, bucket), np.int64)
        lens = np.empty(n, np.int64)
        for i, r in enumerate(reqs):
            ids[i, :r.prompt_len] = r.prompt
            lens[i] = r.prompt_len
        self._prefill_shapes.add((n, bucket, "sp") if sp else (n, bucket))
        dev = self.device
        # (hidden, keys, values) or, under the int8 cache, also the scales
        hidden, *kv = self.module.prefill(torch.from_numpy(ids).to(dev))
        last = hidden[torch.arange(n, device=dev),
                      torch.from_numpy(lens - 1).to(dev)]
        toks = self._sample(self.module.logits(last), self._generator,
                            self.temperature, self.top_k, self.top_p)
        if sp:
            self.sp_prefill_tokens += int(lens.sum())
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
        its first token, fill, token budget, EOS id, (fused) no prompt
        outstanding and, speculative, its history row. A request retired on
        its first token keeps its lane dead instead."""
        slot = req.slot
        if self.fused_prefill:
            # admitted without inline prefill (a prefix hit): it joins in
            # decode mode, whatever the slot's last occupant left
            self._clear_pf_slot(slot)
        if req.status == "running":
            rem = min(req.max_new_tokens - len(req.tokens),
                      self.kv.allocator.remaining(slot))
            eos = -1 if req.eos_token_id is None else int(req.eos_token_id)
            patch = (int(req.tokens[-1]), req.prompt_len, rem, eos)
            if self.fused_prefill:
                patch = patch + (0,)
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
        pf = np.zeros(B, np.int64) if self.fused_prefill else None
        for slot, req in self.scheduler.running.items():
            done = self._pf_consumed.get(slot, req.prompt_len)
            if done < req.prompt_len:
                # mid-prompt: resumes in prefill mode from its cursor
                positions[slot] = done
                pf[slot] = req.prompt_len - done
            else:
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
        # a rebuild from the host brings the launch cursors back to the
        # consumed ones (no chunk is in flight)
        self._pf_launched = dict(self._pf_consumed)
        arrays = (tokens, positions, active, remaining, eos)
        if pf is not None:
            arrays = arrays + (pf,)
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
        pf = chunk.state[5] if self.fused_prefill else None
        hist = chunk.state[-1] if self.speculative else None
        if self._deact_slots:
            idx = self._upload(np.array(sorted(self._deact_slots), np.int64))
            act = act.index_fill(0, idx, False)
        if self._admit_patches:
            slots = sorted(self._admit_patches)
            vals = [self._admit_patches[s] for s in slots]
            # one upload: slot, token, fill, budget, eos (, prompt
            # outstanding) per row
            n = 5 if pf is not None else 4
            cols = self._upload(np.array([(s,) + tuple(v[:n])
                                          for s, v in zip(slots, vals)],
                                         np.int64))
            idx = cols[:, 0]
            tok = tok.index_copy(0, idx, cols[:, 1])
            pos = pos.index_copy(0, idx, cols[:, 2])
            rem = rem.index_copy(0, idx, cols[:, 3])
            eos = eos.index_copy(0, idx, cols[:, 4])
            act = act.index_fill(0, idx, True)
            if pf is not None:
                pf = pf.index_copy(0, idx, cols[:, 5])
            if hist is not None:
                hist = hist.index_copy(0, idx, self._upload(
                    np.stack([v[-1] for v in vals])))
        self._deact_slots.clear()
        self._admit_patches.clear()
        out = (tok, pos, act, rem, eos)
        if pf is not None:
            out = out + (pf,)
        return out if hist is None else out + (hist,)

    @torch.inference_mode()
    def _launch_chunk(self, state: Tuple) -> _InflightChunk:
        """Enqueue one K-step decode chunk from ``state`` and return at once
        (deepspeed_tpu/serving/engine.py:1807): the token and valid buffers
        start their copies to pinned host memory behind a recorded event,
        which :meth:`_consume_chunk` waits on. Nothing here reads device
        data on the host."""
        wall_t0 = time.perf_counter()
        if self.fused_prefill:
            pbuf = self._upload(self._build_prompt_buf())
            if self.speculative:
                toks, valid, carry = self._fused_spec_chunk(*state, pbuf)
            else:
                toks, valid, carry = self._fused_chunk(*state, pbuf)
        elif self.speculative:
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

    def _fused_chunk(self, tok, pos, act, rem, eos, pf, pbuf):
        """K fused steps (the TPU package's ``decode_chunk_fused_fn`` scan,
        deepspeed_tpu/serving/engine.py:695-765, as a loop). Each step is
        one C-wide ``GPT.decode`` over all lanes: a prefilling lane (act,
        pf > 0) feeds its next prompt chunk from ``pbuf`` [K, B, C] and
        consumes min(pf, C) tokens, emitting nothing until the step that
        completes its prompt samples token #1 at its last real column; a
        decoding lane feeds its token in every column and samples at column
        0. Every column writes K/V from the lane's position on: columns
        past a lane's real ones write above its fill (or to the sinks),
        masked until a later step overwrites them. Returns (tokens [B, K],
        valid [B, K], carry)."""
        B, C, S = self.max_batch, self.prefill_chunk, self.max_seq_len
        ext = self._kv_extent
        rows = torch.arange(B, device=tok.device)
        cspan = torch.arange(C, device=tok.device)[None, :]
        toks, valid = [], []
        for k in range(self.decode_chunk):
            is_pf = act & (pf > 0)
            n_cons = torch.where(is_pf, pf.clamp(max=C), 0)
            completing = is_pf & (pf <= C)
            inputs = torch.where(is_pf[:, None], pbuf[k], tok[:, None])
            write_pos = torch.where(act, pos, ext)
            # positions past the model's table are clamped, as the TPU
            # package's embedding gather clamps them; only pad columns sit
            # there
            logits = self._decode(inputs, (pos[:, None] + cspan).clamp(
                max=S - 1), write_pos)                          # [B, C, V]
            sel = torch.where(is_pf, (n_cons - 1).clamp(min=0), 0)
            nxt = self._sample(logits[rows, sel], self._generator,
                               self.temperature, self.top_k,
                               self.top_p).to(tok.dtype)
            emits = act & (completing | ~is_pf)
            nxt = torch.where(emits, nxt, tok)
            rem = torch.where(emits, rem - 1, rem)
            hit_eos = (eos >= 0) & (nxt == eos) & emits
            act = act & torch.where(emits, (rem > 0) & ~hit_eos, True)
            pos = pos + torch.where(is_pf, n_cons, emits.long())
            pf = pf - n_cons
            tok = nxt
            toks.append(nxt)
            valid.append(emits)
        return (torch.stack(toks, dim=1), torch.stack(valid, dim=1),
                (tok, pos, act, rem, eos, pf))

    def _fused_spec_chunk(self, tok, pos, act, rem, eos, pf, hist, pbuf):
        """K fused speculative steps (``decode_chunk_fused_spec_fn``,
        deepspeed_tpu/serving/engine.py:766-870, as a loop), greedy. A step
        is W = max(C, k + 1) wide: prefilling lanes consume their chunk
        through the first C columns, decoding lanes verify k drafts through
        the first k + 1. A completing prefill lane's token #1 is the argmax
        at its last real column and is emitted at column 0 of the step's W
        outputs. Returns (tokens [B, K*W], valid [B, K*W], carry)."""
        B, k, S = self.max_batch, self.spec_k, self.max_seq_len
        C, W, ext = self.prefill_chunk, self._width, self._kv_extent
        kp1 = k + 1
        dev = tok.device
        rows = torch.arange(B, device=dev)
        j = torch.arange(kp1, device=dev)[None, :]
        wspan = torch.arange(W, device=dev)[None, :]
        hist = hist.clone()                  # the chunk writes its own copy
        toks, valid = [], []
        for step in range(self.decode_chunk):
            is_pf = act & (pf > 0)
            n_cons = torch.where(is_pf, pf.clamp(max=C), 0)
            completing = is_pf & (pf <= C)
            is_dec = act & ~is_pf
            # hist[b, pos] == tok for decode lanes only: a prefilling lane's
            # row holds its prompt, and pos points inside it
            hist[rows, torch.where(is_dec, pos, S)] = tok
            drafts = self.drafter.propose(hist[:, :S], tok, pos).to(
                tok.dtype)                                       # [B, k]
            dec_in = F.pad(torch.cat([tok[:, None], drafts], dim=1),
                           (0, W - kp1))
            inputs = torch.where(is_pf[:, None], F.pad(pbuf[step], (0, W - C)),
                                 dec_in)
            write_pos = torch.where(act, pos, ext)
            logits = self._decode(inputs, (pos[:, None] + wspan).clamp(
                max=S - 1), write_pos)                          # [B, W, V]
            # decode lanes: greedy verify over the first k + 1 columns
            emitted, acc = verify_greedy(logits[:, :kp1], drafts)
            cand = is_dec[:, None] & (j <= acc[:, None]) & (j < rem[:, None])
            hitv = (eos[:, None] >= 0) & (emitted == eos[:, None])
            cut = (cand & hitv).long()
            dvalid = cand & ((cut.cumsum(dim=1) - cut) == 0)
            n = dvalid.long().sum(dim=1)
            last = torch.gather(emitted, 1,
                                (n - 1).clamp(0, k)[:, None])[:, 0]
            # prefilling lanes: token #1 at column n_cons - 1
            t1 = torch.argmax(logits[rows, (n_cons - 1).clamp(min=0)],
                              dim=-1).to(tok.dtype)
            pf_emit = act & completing
            t1_eos = (eos >= 0) & (t1 == eos) & pf_emit
            tok_n = torch.where(is_pf, torch.where(pf_emit, t1, tok),
                                torch.where(n > 0, last, tok))
            stopped = (dvalid & hitv).any(dim=1) | t1_eos
            rem_n = rem - torch.where(is_pf, pf_emit.long(), n)
            act = act & torch.where(is_pf & ~pf_emit, True,
                                    (rem_n > 0) & ~stopped)
            # W outputs a step: decode lanes at columns 0..k, a completing
            # prefill lane's token #1 at column 0
            ys_tok = torch.where(is_pf[:, None], t1[:, None].expand(B, kp1),
                                 emitted)
            ys_val = torch.where(is_pf[:, None], pf_emit[:, None] & (j == 0),
                                 dvalid)
            # history: decode-lane token j at pos + 1 + j, a completing
            # lane's token #1 at its prompt length (sinks: column S)
            hist[rows[:, None], torch.where(dvalid, pos[:, None] + 1 + j,
                                            S)] = emitted
            hist[rows, torch.where(pf_emit, pos + n_cons, S)] = t1
            pos = pos + torch.where(is_pf, n_cons, n)
            pf = pf - n_cons
            rem, tok = rem_n, tok_n
            toks.append(F.pad(ys_tok, (0, W - kp1)))
            valid.append(F.pad(ys_val, (0, W - kp1)))
        return (torch.stack(toks, dim=1).reshape(B, -1),
                torch.stack(valid, dim=1).reshape(B, -1),
                (tok, pos, act, rem, eos, pf, hist))

    def _build_prompt_buf(self) -> np.ndarray:
        """The prompt chunks [K, B, C] of one launch for the lanes still in
        prefill mode (deepspeed_tpu/serving/engine.py:2019), advancing the
        launch cursors (one chunk ahead of the consumed ones under the
        double-buffered loop): a prefilling lane's evolution on the device
        is deterministic, so this host mirror stays exact without a read of
        device data."""
        K, B, C = self.decode_chunk, self.max_batch, self.prefill_chunk
        buf = np.zeros((K, B, C), np.int64)
        for slot, req in self.scheduler.running.items():
            done = self._pf_launched.get(slot)
            if done is None:
                continue
            L = req.prompt_len
            for k in range(K):
                if done >= L:
                    break
                n = min(C, L - done)
                buf[k, slot, :n] = req.prompt[done:done + n]
                done += n
            self._pf_launched[slot] = done
        return buf

    def _sim_chunk_prefill(self, chunk: _InflightChunk
                           ) -> Tuple[Dict[int, int], np.ndarray]:
        """The host's replay of a consumed chunk's prefill-mode steps
        (deepspeed_tpu/serving/engine.py:2043): each step a mid-prompt lane
        consumes min(pf, C) tokens. Returns the advanced consumed cursors
        and the [B, K] mask of steps each lane spent in prefill mode (its
        completing step included)."""
        K, C = self.decode_chunk, self.prefill_chunk
        pf_steps = np.zeros((self.max_batch, K), bool)
        consumed: Dict[int, int] = {}
        for slot, uid in chunk.slot_uids.items():
            req = self.scheduler.running.get(slot)
            if req is None or req.uid != uid:
                continue
            done = self._pf_consumed.get(slot)
            if done is None or done >= req.prompt_len:
                continue
            for k in range(K):
                if done >= req.prompt_len:
                    break
                pf_steps[slot, k] = True
                done += min(C, req.prompt_len - done)
            consumed[slot] = done
        return consumed, pf_steps

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
        pf_steps = None
        if self.fused_prefill:
            # the host's replay of the chunk's prompt consumption
            consumed, pf_steps = self._sim_chunk_prefill(chunk)
            for slot, done in consumed.items():
                self.inline_prefill_tokens += max(
                    done - self._pf_consumed.get(slot, done), 0)
                self._pf_consumed[slot] = done
        fin_before = len(self.scheduler.finished)
        per_slot: Dict[int, List[int]] = {}
        n_first = 0
        for slot, uid in chunk.slot_uids.items():
            req = self.scheduler.running.get(slot)
            if req is None or req.uid != uid:
                continue        # slot retired or re-leased since the launch
            seq = [int(t) for t, v in zip(toks[slot], valid[slot]) if v]
            if seq and slot in self._pf_first_pending:
                # the lane completed its prompt in this chunk: token #1
                # goes through record_first_token (the time to first token;
                # no allocator advance, as after a bucketed prefill), and a
                # paged miss publishes its prompt blocks now
                self._pf_first_pending.discard(slot)
                first = seq.pop(0)
                n_first += 1
                plan = self._pf_plans.pop(slot, None)
                if plan is not None:
                    cow = self.kv.commit_prefix(plan, first)
                    if self.kv.prefix_enabled:
                        self.metrics.on_prefix(False)
                    if cow is not None:
                        self.metrics.on_cow()
                self._last_token[slot] = first
                self.scheduler.record_first_token(req, first)
                if req.status != "running":
                    seq = []            # retired on token #1
            if seq:
                per_slot[slot] = seq
                self._last_token[slot] = seq[-1]
        self.scheduler.step_tokens_chunk(per_slot)
        finished = self.scheduler.finished[fin_before:]
        if self.speculative:
            # a step is live iff its first column (the correction or bonus
            # token, always valid on a live lane) is; accepted drafts are
            # the valid tokens beyond that one. A fused lane's prompt steps
            # verified no drafts (its completing step's column 0 is token
            # #1): the replay's mask leaves them out
            v3 = valid.reshape(self.max_batch, -1, self._width)
            live = v3[:, :, 0]
            if pf_steps is not None:
                live = live & ~pf_steps
            accepted = int(np.maximum(
                np.where(live, v3.sum(axis=2), 0) - live, 0).sum())
            self.metrics.on_spec(int(live.sum()) * self.spec_k, accepted)
        self.metrics.on_tokens(n_first
                               + sum(len(v) for v in per_slot.values()))
        self.metrics.on_decode_step(seconds)
        self.metrics.on_finished(finished)
        for req in finished:
            if req.slot is not None:
                self._deact_slots.add(req.slot)
                self._clear_pf_slot(req.slot)
        return finished

    def _may_outlive_chunk(self) -> bool:
        """Could any lane still be live after the in-flight chunk
        (deepspeed_tpu/serving/engine.py:2071)? The host mirrors are
        pre-chunk here, and every live step emits at least one token, so a
        lane survives only if its remaining budget exceeds K. Gates the
        next launch so the drain tail pays no dead chunk."""
        K = self.decode_chunk
        for slot, req in self.scheduler.running.items():
            if self._pf_consumed.get(slot, req.prompt_len) < req.prompt_len:
                return True      # mid-prompt: more chunks to come
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
