"""Fused chunked prefill in the port's ServingEngine
(deepspeed_tpu_torch/serving/engine.py, ``fused_prefill=True``) against the
TPU package's fused engine and the port's bucketed one, on the CPU in f32,
greedy, at the JAX tests' size (``max_batch=3``, ``decode_chunk=4``,
weights carried over by ``convert.py``) with ``max_prompt_len`` 32, so a
chunk of 24 is not clamped to the prompt limit:

  * greedy tokens equal to the JAX fused engine's and to the port's
    unfused engine's at ``prefill_chunk`` 4, 12 and 24 over the dense,
    paged, int8 and speculative engines, every prompt token consumed inside
    the decode chunks and no bucketed prefill;
  * EOS in mid-chunk and on token #1, staggered admission while other
    lanes are mid-prompt (``pump()`` by ``pump()``), a paged prefix hit
    that skips every chunk, a lane cancelled mid-prompt (its blocks freed,
    an identical prompt admitted after it);
  * the chunk token budget (``_budget_drain``, ``_lane_cost``, the
    scheduler's budget rule, a tight budget) and the constructor's checks,
    as the JAX engine makes them;
  * the decode wrapper's pieces (query widths past 16 as consecutive
    launches, each with its own fill) against one full-width plain call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import ServingEngine
from deepspeed_tpu_torch.serving import (ContinuousBatchScheduler, Request,
                                         SlotAllocator)

from torch_port_helpers import model_pair
from torch_test_threads import one_torch_thread  # noqa: F401

BASE = dict(max_batch=3, max_prompt_len=32, max_queue=16, decode_chunk=4)
# prompts of 1 to 8 chunks of 4 (one to two of 24), more than the slots
LENS = (3, 7, 5, 9, 4, 13, 6, 11, 20, 31)
ARENAS = {"dense": {}, "paged": dict(paged=True, kv_block_size=8),
          "int8": dict(kv_dtype="int8"),
          "spec": dict(speculative=True, spec_k=3)}
NEW = 8


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=0)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 256, n).astype(np.int32) for n in LENS]


def _port(pair, **kw):
    return ServingEngine(pair[2], device="cpu", dtype=torch.float32,
                         megakernel=True, **{**BASE, **kw})


def _jax(pair, **kw):
    from deepspeed_tpu.serving import ServingEngine as JaxServing
    jmodel, params, _ = pair
    return JaxServing(jmodel, model_parameters=params, dtype=jnp.float32,
                      **{**BASE, **kw})


def _ids(reqs):
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    return [r.output_ids.tolist() for r in reqs]


def _run(eng, prompts, **kw):
    return eng.run([p.copy() for p in prompts], max_new_tokens=NEW, **kw)


@pytest.fixture(scope="module")
def unfused(pair, prompts):
    """The port's bucketed engine's tokens on each arena."""
    return {name: _ids(_run(_port(pair, **kw), prompts))
            for name, kw in ARENAS.items()}


@pytest.mark.parametrize("chunk", [4, 12, 24])
@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_fused_equals_jax_fused_and_unfused(pair, prompts, unfused, arena,
                                            chunk):
    kw = dict(ARENAS[arena], fused_prefill=True, prefill_chunk=chunk)
    eng = _port(pair, **kw)
    out = _ids(_run(eng, prompts))
    assert out == unfused[arena]
    assert out == _ids(_run(_jax(pair, **kw), prompts))
    assert eng.inline_prefill_tokens == sum(LENS)
    assert eng.metrics.prefill_programs == 0
    assert eng.metrics.prefill_prompt_tokens == 0
    assert not (eng._pf_consumed or eng._pf_launched
                or eng._pf_first_pending or eng._pf_plans)


def test_mid_chunk_and_first_token_eos(pair, prompts, unfused):
    """EOS inside a chunk and EOS on token #1 (the step completing the
    prompt) end requests as the bucketed engine and the JAX fused engine
    end them."""
    ref = unfused["dense"]
    mid_eos = ref[0][LENS[0] + 2]
    first_eos = ref[1][LENS[1]]
    for eos in (mid_eos, first_eos):
        kw = dict(fused_prefill=True, prefill_chunk=4)
        got = _run(_port(pair, **kw), prompts, eos_token_id=eos)
        assert _ids(got) == _ids(_run(_port(pair), prompts,
                                      eos_token_id=eos))
        assert _ids(got) == _ids(_run(_jax(pair, **kw), prompts,
                                      eos_token_id=eos))
        if eos == first_eos:
            assert any(len(r.tokens) == 1 for r in got)


def _drive(eng, prompts):
    """Two requests at the start, then one more every second ``pump()``
    while earlier lanes are mid-prompt."""
    pending = [p.copy() for p in prompts]
    reqs = []
    for _ in range(2):
        reqs.append(eng.submit(pending.pop(0), max_new_tokens=NEW))
    pumps = 0
    while eng.scheduler.has_work() or eng.chunk_in_flight or pending:
        if pending and pumps % 2 == 1:
            reqs.append(eng.submit(pending.pop(0), max_new_tokens=NEW))
        eng.pump()
        pumps += 1
    return reqs


def test_staggered_mid_prompt_admission(pair, prompts):
    kw = dict(fused_prefill=True, prefill_chunk=4)
    got = _ids(_drive(_port(pair, **kw), prompts))
    assert got == _ids(_drive(_port(pair), prompts))
    assert got == _ids(_drive(_jax(pair, **kw), prompts))


def test_paged_prefix_hit_skips_every_chunk(pair, prompts):
    """A cached prompt forks and replays its first token: it joins in
    decode mode and consumes no prompt chunk."""
    eng = _port(pair, max_batch=2, paged=True, kv_block_size=8,
                fused_prefill=True, prefill_chunk=4)
    shared = prompts[5]                              # 13 tokens: 4 chunks
    first = _ids(eng.run([shared.copy()], max_new_tokens=6))
    inline = eng.inline_prefill_tokens
    assert inline == len(shared) and eng.metrics.n_prefix_misses == 1
    again = _ids(eng.run([shared.copy()], max_new_tokens=6))
    assert again == first
    assert eng.metrics.n_prefix_hits == 1
    assert eng.inline_prefill_tokens == inline


def test_cancel_mid_prompt_frees_blocks_and_admits_a_twin(pair, prompts):
    """A paged lane cancelled while its prompt is half consumed frees its
    blocks and drops its pending-prompt key: an identical prompt then
    admits (a miss, not deferred behind a commit that never comes) and
    serves what a fresh engine serves."""
    long = prompts[-1]                               # 31 tokens: 8 chunks
    eng = _port(pair, paged=True, kv_block_size=8, fused_prefill=True,
                prefill_chunk=4, decode_chunk=2)
    free0 = eng.kv.allocator.blocks.n_free
    req = eng.submit(long.copy(), max_new_tokens=NEW)
    eng.pump()                                       # chunk 1 launched
    eng.pump()                                       # chunk 2 launched
    assert 0 < eng._pf_consumed[req.slot] < len(long)
    key = eng._pf_plans[req.slot].key
    assert key in eng.kv.allocator._pending
    assert eng.cancel(req) and req.status == "cancelled"
    assert key not in eng.kv.allocator._pending
    assert not (eng._pf_consumed or eng._pf_plans)
    twin = eng.submit(long.copy(), max_new_tokens=NEW)
    while eng.scheduler.has_work() or eng.chunk_in_flight:
        eng.pump()
    assert twin.status == "done"
    assert eng.kv.allocator.blocks.n_free + eng.kv.prefix_cache.blocks_held \
        == free0
    fresh = _port(pair, paged=True, kv_block_size=8, fused_prefill=True,
                  prefill_chunk=4, decode_chunk=2)
    assert twin.output_ids.tolist() == _ids(
        fresh.run([long.copy()], max_new_tokens=NEW))[0]


def test_budget_accounting_matches_jax(pair):
    """``_lane_cost`` prices a new lane at its first prompt chunk;
    ``_budget_drain`` charges a prefilling lane its next chunk and a
    decoding one its token (k + 1 speculative); the default budget is
    2 C + max_batch; the JAX engine's numbers on the same states."""
    for spec in (False, True):
        kw = dict(fused_prefill=True, prefill_chunk=4)
        if spec:
            kw.update(speculative=True, spec_k=3)
        port, jeng = _port(pair, **kw), _jax(pair, **kw)
        for eng in (port, jeng):
            assert eng.chunk_token_budget == 2 * 4 + 3
            short = Request(prompt=np.zeros(3, np.int32), max_new_tokens=4)
            multi = Request(prompt=np.zeros(9, np.int32), max_new_tokens=4)
            assert eng._lane_cost(short) == 3
            assert eng._lane_cost(multi) == 4
            assert eng._budget_drain() == 0
            for n in (9, 6):
                eng.submit(np.arange(1, n + 1, dtype=np.int32),
                           max_new_tokens=4)
            eng._admit()
            a, b = sorted(eng.scheduler.running)
            assert eng._budget_drain() == 4 + 4
            eng._pf_consumed[a] = 8                  # 1 of 9 left
            eng._pf_consumed[b] = 6                  # prompt done
            assert eng._budget_drain() == 1 + (4 if spec else 1)


def test_scheduler_budget_rule_as_jax():
    """The three JAX budget cases on the port's scheduler: admission stops
    at the first request over the budget (no later one jumps it), an idle
    engine always admits one, and no budget is plain FIFO."""
    def sched(max_batch=4):
        return ContinuousBatchScheduler(SlotAllocator(max_batch, 32),
                                        max_queue=16)

    def cost(r):
        return min(4, r.prompt_len)

    s = sched()
    for n in (4, 8, 2):
        s.submit(Request(prompt=np.zeros(n, np.int32), max_new_tokens=4))
    assert [r.prompt_len for r in s.admit(token_budget=6, lane_cost=cost)] \
        == [4]
    assert [r.prompt_len for r in s.queue] == [8, 2]
    s = sched()
    s.submit(Request(prompt=np.zeros(8, np.int32), max_new_tokens=4))
    assert len(s.admit(token_budget=0, lane_cost=cost)) == 1
    s = sched(max_batch=2)
    for n in (4, 8, 2):
        s.submit(Request(prompt=np.zeros(n, np.int32), max_new_tokens=4))
    assert [r.prompt_len for r in s.admit()] == [4, 8]


def test_tight_budget_staggers_admission(pair, prompts, unfused):
    """A budget of 4 affords one prompt chunk a step: admission staggers
    and the tokens still equal the bucketed engine's."""
    eng = _port(pair, fused_prefill=True, prefill_chunk=4,
                chunk_token_budget=4)
    assert _ids(_run(eng, prompts)) == unfused["dense"]


def test_constructor_checks_as_jax(pair):
    """prefill_chunk clamps to max_prompt_len; a chunk or budget below 1
    raises ValueError; fused + speculative + temperature > 0 raises the
    JAX engine's ValueError; knobs off the fused path are not checked."""
    eng = _port(pair, fused_prefill=True, prefill_chunk=64)
    assert eng.prefill_chunk == 32 and eng.chunk_token_budget == 2 * 32 + 3
    assert eng._width == 32 and eng._kv_extent == 64 + 31
    for make in (_port, _jax):
        with pytest.raises(ValueError, match="prefill_chunk must be >= 1"):
            make(pair, fused_prefill=True, prefill_chunk=0)
        with pytest.raises(ValueError,
                           match="chunk_token_budget must be >= 1"):
            make(pair, fused_prefill=True, chunk_token_budget=0)
        with pytest.raises(ValueError, match="greedy sampling only"):
            make(pair, fused_prefill=True, speculative=True,
                 temperature=0.7)
    assert _port(pair, prefill_chunk=0).prefill_chunk == 0


@pytest.mark.parametrize("s", [17, 24, 40])
def test_decode_pieces_equal_one_full_width_call(s):
    """Widths past 16 run as consecutive launches of at most 16 queries:
    the piece [a, a + n) is a width-n call with fill f - (s - 1) + a + n - 1
    (clamped at 0 by the kernel). The wrapper's piece loop, each piece
    through the plain version into its columns of the output (the kernel
    writes them in place), against one full-width plain call, at d 80,
    fills from 1 (the early pieces see nothing) to past S."""
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    rng = np.random.default_rng(s)
    b, S, h, d = 5, 64, 2, 80
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, s, h, d), (b, S, h * d), (b, S, h * d)))
    fills = torch.tensor([1, s, 33, S, S + 5], dtype=torch.int32)
    pieces = []

    def launch(a, n, fill, out):              # the kernel: in place
        pieces.append(n)
        out[:, a:a + n] = da.decode_attention_reference(q[:, a:a + n], k, v,
                                                        fill, 0.1)
    got = da._launch_pieces(q, da._as_cache_len(fills, b, S, "cpu"), launch)
    assert pieces == [n for _, n in da.query_pieces(s)]
    assert sum(pieces) == s and max(pieces) == da.MAX_LAUNCH_S
    ref = da.decode_attention_reference(q, k, v, fills, 0.1)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    assert not got[0, :s - 1].any()              # fill 1: one query sees
