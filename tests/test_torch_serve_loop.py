"""The port's double-buffered serve loop (ServingEngine.run / pump /
cancel, deepspeed_tpu_torch/serving/engine.py) against the TPU package's,
on the CPU in f32, greedy.

``run()`` takes the pipelined loop exactly when the TPU engine's does
(``decode_chunk > 1`` or speculative) and gives the same tokens as a loop
of synchronous ``step()`` calls and as the TPU ``run()``; an external
``pump()`` loop drains to the same results; one sequence of calls with a
``cancel`` of a queued and of a running request gives the same statuses and
tokens on both engines; and a cancelled lane's slot, leased again in the
paged arena while the cancelled lane's chunk is still in flight, serves its
next request as a fresh engine serves it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import ServingEngine

from torch_port_helpers import model_pair, prompts
from torch_test_threads import one_torch_thread  # noqa: F401

BASE = dict(max_batch=3, max_prompt_len=32, max_queue=16)
CONFIGS = {
    "chunk4_dense": dict(decode_chunk=4),
    "chunk2_paged": dict(decode_chunk=2, paged=True, kv_block_size=8),
    "spec_dense": dict(decode_chunk=4, speculative=True, spec_k=3),
    "spec_paged_int8": dict(decode_chunk=2, speculative=True, spec_k=2,
                            paged=True, kv_block_size=8, kv_dtype="int8"),
}


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=0)


def _port(pair, **kw):
    return ServingEngine(pair[2], device="cpu", dtype=torch.float32,
                         megakernel=True, **{**BASE, **kw})


def _jax(pair, **kw):
    from deepspeed_tpu.serving import ServingEngine as JaxServing
    jmodel, params, _ = pair
    return JaxServing(jmodel, model_parameters=params, dtype=jnp.float32,
                      megakernel=True, **{**BASE, **kw})


def _count_device_launches(eng):
    """Wrap ``_device_state``: the count of launches made from the
    device-carried state of the previous chunk."""
    calls = []
    inner = eng._device_state

    def counted(chunk):
        calls.append(1)
        return inner(chunk)

    eng._device_state = counted
    return calls


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_run_is_pipelined_and_equals_a_step_loop_and_the_tpu_run(pair,
                                                                 config):
    kw = CONFIGS[config]
    ps = prompts(n=7, seed=4)
    ref = _jax(pair, **kw).run([p.copy() for p in ps], max_new_tokens=9)
    eng = _port(pair, **kw)
    calls = _count_device_launches(eng)
    out = eng.run([p.copy() for p in ps], max_new_tokens=9)
    assert calls, "run() never launched from device-carried state"
    assert not eng.chunk_in_flight
    stepper = _port(pair, **kw)
    step_calls = _count_device_launches(stepper)
    for p in ps:
        stepper.submit(p.copy(), max_new_tokens=9)
    finished = []
    while stepper.scheduler.has_work():
        finished += stepper.step()
        assert not stepper.chunk_in_flight
    assert not step_calls
    assert len(finished) == len(ps)
    for r, o, s in zip(ref, out, sorted(finished, key=lambda r: r.uid)):
        assert o.status == r.status == s.status == "done"
        np.testing.assert_array_equal(o.output_ids, r.output_ids)
        np.testing.assert_array_equal(s.output_ids, r.output_ids)


_REFERENCE = {}


def _step_loop_reference(pair, ps):
    """The routing test's reference tokens: a K=4 engine, run once."""
    if "routes" not in _REFERENCE:
        _REFERENCE["routes"] = _port(pair, decode_chunk=4).run(
            [p.copy() for p in ps], max_new_tokens=12)
    return _REFERENCE["routes"]


@pytest.mark.parametrize("decode_chunk,speculative",
                         [(1, False), (1, True), (2, False), (8, True)])
def test_run_routes_as_the_tpu_run(pair, decode_chunk, speculative):
    """The pipelined loop exactly when the TPU engine chunks
    (``decode_chunk > 1 or speculative``); with decode_chunk 1 and no
    speculation ``run()`` is a loop of synchronous steps."""
    kw = dict(decode_chunk=decode_chunk, speculative=speculative)
    eng = _port(pair, **kw)
    assert eng._chunked == _jax(pair, **kw)._chunked
    calls = _count_device_launches(eng)
    ps = prompts(n=4, seed=5)
    ref = _step_loop_reference(pair, ps)
    out = eng.run([p.copy() for p in ps], max_new_tokens=12)
    assert bool(calls) == eng._chunked
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.output_ids, r.output_ids)


@pytest.mark.parametrize("config", ["chunk4_dense", "spec_dense"])
def test_a_pump_loop_drains_to_the_run_results(pair, config):
    kw = CONFIGS[config]
    ps = prompts(n=6, seed=6)
    ref = _port(pair, **kw).run([p.copy() for p in ps], max_new_tokens=10)
    eng = _port(pair, **kw)
    reqs = [eng.submit(p.copy(), max_new_tokens=10) for p in ps]
    seen_in_flight = False
    returned = []
    while eng.scheduler.has_work() or eng.chunk_in_flight:
        returned += eng.pump()
        seen_in_flight |= eng.chunk_in_flight
    assert seen_in_flight
    assert sorted(r.uid for r in returned) == sorted(r.uid for r in reqs)
    assert eng.pump() == [] and not eng.chunk_in_flight
    for r, o in zip(ref, reqs):
        assert o.status == "done"
        np.testing.assert_array_equal(o.output_ids, r.output_ids)


def _cancel_script(eng, ps):
    """Submit, pump once (two lanes admitted, a chunk in flight), cancel
    the last queued request and the first running one, then drain; returns
    the requests and what ``cancel`` answered (a second cancel of a
    terminal request answers False)."""
    reqs = [eng.submit(p.copy(), max_new_tokens=12) for p in ps]
    eng.pump()
    answers = [eng.cancel(reqs[-1]), eng.cancel(reqs[0]),
               eng.cancel(reqs[0])]
    tokens_at_cancel = list(reqs[0].tokens)
    while eng.scheduler.has_work() or eng.chunk_in_flight:
        eng.pump()
    assert reqs[0].tokens == tokens_at_cancel    # nothing delivered after
    return reqs, answers


@pytest.mark.parametrize("config", ["chunk4_dense", "chunk2_paged",
                                    "spec_dense", "spec_paged_int8"])
def test_cancel_gives_the_tpu_engines_statuses_and_tokens(pair, config):
    kw = dict(CONFIGS[config], max_batch=2)
    ps = prompts(n=5, seed=9)
    ref, ref_answers = _cancel_script(_jax(pair, **kw), ps)
    out, answers = _cancel_script(_port(pair, **kw), ps)
    assert answers == ref_answers == [True, True, False]
    assert [r.status for r in out] == [r.status for r in ref]
    assert out[0].status == out[-1].status == "cancelled"
    assert out[-1].tokens == []                  # never prefilled
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.output_ids, r.output_ids)


@pytest.mark.parametrize("speculative", [False, True])
def test_a_cancelled_lanes_re_leased_paged_slot_serves_its_next_request(
        pair, speculative):
    """One slot: request A runs with a chunk in flight, is cancelled, and B
    takes the same slot and some of A's freed blocks while A's chunk still
    writes through A's old table. B's tokens equal those a fresh engine
    serves it."""
    kw = dict(max_batch=1, max_prompt_len=32, decode_chunk=4, paged=True,
              kv_block_size=8, kv_pool_blocks=6, prefix_cache=False,
              speculative=speculative, spec_k=3)
    rng = np.random.default_rng(2)
    a, b = (rng.integers(1, 256, n).astype(np.int32) for n in (20, 11))
    eng = _port(pair, **kw)
    ra = eng.submit(a.copy(), max_new_tokens=20)
    eng.pump()
    eng.pump()                                   # A's next chunk in flight
    assert eng.chunk_in_flight and ra.status == "running"
    a_blocks = list(eng.kv.allocator.tables[ra.slot])
    assert eng.cancel(ra)
    rb = eng.submit(b.copy(), max_new_tokens=9)
    while eng.scheduler.has_work() or eng.chunk_in_flight:
        eng.pump()
        if rb.status == "running":
            assert rb.slot == ra.slot
            assert set(eng.kv.allocator.tables[rb.slot]) & set(a_blocks)
    alone = _port(pair, **kw).run([b.copy()], max_new_tokens=9)[0]
    assert rb.status == "done"
    np.testing.assert_array_equal(rb.output_ids, alone.output_ids)
    assert ra.status == "cancelled"
