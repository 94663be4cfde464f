"""Paged KV serving in the port (deepspeed_tpu_torch/serving/paged_kv.py,
the paged decode op and the engine's paged path) against the TPU package.

Layered like the subsystem: the host classes on the cases of
tests/test_paged_kv.py (and, op for op, against the TPU package's
allocator), then the paged attention's plain version against the TPU
package's paged attention (the Pallas kernel in interpret mode and its XLA
gather path; f32, atol 2e-5 as tests/test_paged_kv.py holds the Pallas
kernel), then the engine: greedy tokens equal to the TPU engine's, paged
equal to dense. CPU tensors, so no kernel launches; the CUDA kernel is held
to the same plain version in tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu_torch.ops.cuda import _build
from deepspeed_tpu_torch.ops.cuda import decode_attention as pda
from deepspeed_tpu_torch.serving.paged_kv import (BlockAllocator,
                                                  PagedSlotAllocator,
                                                  PrefixCache)
from deepspeed_tpu_torch.serving.scheduler import (REJECT_KV_OOM,
                                                   ContinuousBatchScheduler,
                                                   Request)

from torch_port_helpers import model_pair, prompts
from torch_test_threads import one_torch_thread  # noqa: F401

ATOL = 2e-5


# ------------------------------------------------------ block allocator
def test_block_alloc_free_refcount():
    ba = BlockAllocator(4, 16)
    b0, b1 = ba.alloc(), ba.alloc()
    assert b0 != b1
    assert ba.n_used == 2 and ba.n_free == 2
    ba.incref(b0)
    ba.decref(b0)
    assert ba.n_used == 2
    ba.decref(b0)
    ba.decref(b1)
    assert ba.n_free == 4 and ba.peak_used == 2


def test_block_oom_returns_none_and_double_decref_raises():
    ba = BlockAllocator(2, 16)
    assert ba.alloc() is not None and ba.alloc() is not None
    assert ba.alloc() is None
    ba.decref(0)
    with pytest.raises(ValueError):
        ba.decref(0)


def test_freed_blocks_recycle_lru():
    ba = BlockAllocator(3, 16)
    b0 = ba.alloc()
    ba.decref(b0)
    assert ba.alloc() != b0


# -------------------------------------------------------- prefix cache
def test_prefix_put_lookup_and_refcounts():
    ba = BlockAllocator(8, 16)
    pc = PrefixCache(capacity=4)
    blocks = (ba.alloc(), ba.alloc())
    key = pc.key_for(np.arange(20, dtype=np.int32))
    assert pc.put(key, blocks, prompt_len=20, first_token=7,
                  block_allocator=ba)
    assert int(ba.refcount[blocks[0]]) == 2
    entry = pc.lookup(key)
    assert entry is not None and entry.first_token == 7
    assert pc.lookup(b"missing") is None
    for b in blocks:
        ba.decref(b)
    assert ba.n_used == 2 and pc.blocks_held == 2
    assert not pc.put(key, blocks, 20, 7, ba)       # no double publish
    assert int(ba.refcount[blocks[0]]) == 1


def test_prefix_eviction_releases_blocks():
    ba = BlockAllocator(8, 16)
    pc = PrefixCache(capacity=2)
    keys = []
    for i in range(3):
        b = ba.alloc()
        key = pc.key_for(np.array([i], np.int32))
        pc.put(key, (b,), 1, i, ba)
        ba.decref(b)
        keys.append(key)
    assert len(pc) == 2 and pc.lookup(keys[0]) is None
    assert pc.evictions == 1 and ba.n_used == 2
    assert pc.evict_lru(ba) and pc.evict_lru(ba)
    assert not pc.evict_lru(ba)
    assert ba.n_free == 8


# ------------------------------------------------- paged slot allocator
def test_upfront_reservation_and_remaining():
    pa = PagedSlotAllocator(4, 64, block_size=16)
    slot = pa.alloc_request(Request(prompt=np.arange(20), max_new_tokens=8))
    assert len(pa.tables[slot]) == 2
    assert pa.remaining(slot) == 2 * 16 - 20
    pa.advance([slot])
    assert pa.fill[slot] == 21
    pa.free(slot)
    assert pa.blocks.n_free == pa.blocks.num_blocks


def test_pending_key_defers_identical_inflight_prompt():
    pa = PagedSlotAllocator(4, 64, block_size=16)
    s1 = pa.alloc_request(Request(prompt=np.arange(20), max_new_tokens=8))
    r2 = Request(prompt=np.arange(20), max_new_tokens=8)
    assert pa.alloc_request(r2) is None
    assert pa.prefix.misses == 1 and pa.prefix.hits == 0
    pa.commit_prefix(s1, pa.plans[s1].key, first_token=3)
    s2 = pa.alloc_request(r2)
    assert s2 is not None and pa.plans[s2].hit and pa.prefix.hits == 1


def test_hit_shares_full_blocks_and_cows_tail():
    pa = PagedSlotAllocator(4, 64, block_size=16)
    s1 = pa.alloc_request(Request(prompt=np.arange(20), max_new_tokens=8))
    pa.commit_prefix(s1, pa.plans[s1].key, first_token=3)
    s2 = pa.alloc_request(Request(prompt=np.arange(20), max_new_tokens=8))
    p2 = pa.plans[s2]
    assert pa.tables[s2][0] == pa.tables[s1][0]
    assert pa.tables[s2][1] != pa.tables[s1][1]
    assert p2.cow is not None and p2.n_shared == 1
    shared = pa.tables[s1][0]
    assert int(pa.blocks.refcount[shared]) == 3
    pa.release_cow_hold(p2.cow[0])
    pa.free(s1)
    assert int(pa.blocks.refcount[shared]) == 2


def test_block_aligned_prompt_needs_no_cow():
    pa = PagedSlotAllocator(4, 64, block_size=16)
    s1 = pa.alloc_request(Request(prompt=np.arange(16), max_new_tokens=8))
    assert pa.commit_prefix(s1, pa.plans[s1].key, 3) is None
    s2 = pa.alloc_request(Request(prompt=np.arange(16), max_new_tokens=8))
    assert pa.plans[s2].cow is None and pa.plans[s2].n_shared == 1


def test_ensure_free_evicts_cold_prefixes():
    pa = PagedSlotAllocator(2, 64, block_size=16, num_blocks=4)
    s1 = pa.alloc_request(Request(prompt=np.arange(17), max_new_tokens=8))
    pa.commit_prefix(s1, pa.plans[s1].key, 3)
    pa.free(s1)
    assert pa.blocks.n_free == 2
    s2 = pa.alloc_request(Request(prompt=np.arange(40), max_new_tokens=8))
    assert s2 is not None and len(pa.tables[s2]) == 3
    assert len(pa.prefix) == 0


def test_allocator_block_oom_and_dense_compat_lease():
    pa = PagedSlotAllocator(4, 64, block_size=16, num_blocks=4,
                            prefix_caching=False)
    assert pa.alloc_request(Request(prompt=np.arange(40),
                                    max_new_tokens=8)) is not None
    assert pa.alloc_request(Request(prompt=np.arange(20),
                                    max_new_tokens=16)) is None
    assert pa.alloc_request(Request(prompt=np.arange(10),
                                    max_new_tokens=4)) is not None
    pb = PagedSlotAllocator(2, 64, block_size=16)
    slot = pb.alloc(5)
    assert len(pb.tables[slot]) == 4 and pb.remaining(slot) == 64 - 5
    assert list(pb.padded_table(slot)) == pb.tables[slot]
    pb.free(slot)
    assert list(pb.padded_table(slot)) == [pb.blocks.num_blocks] * 4
    with pytest.raises(ValueError, match="must divide"):
        PagedSlotAllocator(2, 60, block_size=16)


def test_scheduler_rejects_unservable_request():
    pa = PagedSlotAllocator(2, 64, block_size=16, num_blocks=2)
    sched = ContinuousBatchScheduler(pa, max_queue=4)
    req = Request(prompt=np.arange(30), max_new_tokens=30)
    assert not sched.submit(req)
    assert req.reject_reason == REJECT_KV_OOM
    assert sched.submit(Request(prompt=np.arange(10), max_new_tokens=10))


def test_allocator_decisions_equal_the_tpu_package_op_for_op():
    """A random stream of leases, commits, cow releases and frees through
    the port's allocator and the TPU package's: the same slots, tables,
    plans, refcounts and prefix-cache contents after every op."""
    from deepspeed_tpu.serving import paged_kv as jpk
    from deepspeed_tpu.serving.scheduler import Request as JRequest
    rng = np.random.default_rng(0)
    kw = dict(block_size=8, num_blocks=24)
    mine = PagedSlotAllocator(4, 64, prefix_cache=PrefixCache(3), **kw)
    ref = jpk.PagedSlotAllocator(4, 64, prefix_cache=jpk.PrefixCache(3),
                                 **kw)
    pool = [rng.integers(1, 50, int(n)).astype(np.int32)
            for n in (5, 8, 13, 16, 21)]
    for _ in range(300):
        op = rng.integers(0, 3)
        live = [s for s in range(4) if mine.active[s]]
        if op == 0:
            p = pool[rng.integers(0, len(pool))]
            n = int(rng.integers(1, 20))
            got = mine.alloc_request(Request(prompt=p, max_new_tokens=n))
            want = ref.alloc_request(JRequest(prompt=p, max_new_tokens=n))
            assert got == want
            if got is not None:
                a, b = mine.plans[got], ref.plans[got]
                assert (a.hit, a.cow, a.n_shared, a.first_token) == \
                    (b.hit, b.cow, b.n_shared, b.first_token)
                if a.cow is not None:
                    mine.release_cow_hold(a.cow[0])
                    ref.release_cow_hold(b.cow[0])
        elif op == 1 and live:
            s = live[rng.integers(0, len(live))]
            key = mine.plans[s].key if s in mine.plans else None
            tok = int(rng.integers(0, 50))
            assert mine.commit_prefix(s, key, tok) == \
                ref.commit_prefix(s, key, tok)
            mine.plans.pop(s, None)
            ref.plans.pop(s, None)
        elif op == 2 and live:
            s = live[rng.integers(0, len(live))]
            mine.free(s)
            ref.free(s)
        assert mine.tables == ref.tables
        np.testing.assert_array_equal(mine.blocks.refcount,
                                      ref.blocks.refcount)
        assert list(mine.prefix._entries) == list(ref.prefix._entries)


# -------------------------------------------- paged attention plain version
def _paged_inputs(s_q, seed, b=4, h=2, d=64, bs=8, T=6, extra=5):
    rng = np.random.default_rng(seed)
    nb = b * T + extra
    kp = rng.standard_normal((nb, bs, h * d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, h * d)).astype(np.float32)
    tables = rng.permutation(nb)[:b * T].reshape(b, T).astype(np.int32)
    # per-row fills: the shortest legal fill, mid-block, whole table, and
    # the retired-lane sentinel (clamped to T*bs); table entries past a
    # row's fill are the padded_table sentinel nb
    fills = np.array([s_q, 13, T * bs, T * bs + s_q], np.int32)
    live = (np.minimum(fills, T * bs) + bs - 1) // bs
    tables = np.where(np.arange(T)[None, :] >= live[:, None], nb, tables)
    q = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    return q, kp, vp, tables.astype(np.int32), fills


def _port_paged(q, kp, vp, tables, fills, scale, **kw):
    t = torch.from_numpy
    return pda.paged_decode_attention(t(q), t(kp), t(vp), t(tables),
                                      t(fills), scale=scale, **kw).numpy()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("s_q", list(range(1, 9)))
def test_paged_plain_matches_tpu_paged_attention(impl, s_q):
    q, kp, vp, tables, fills = _paged_inputs(s_q, seed=s_q)
    b, _, h, d = q.shape
    scale = 1.0 / np.sqrt(d)
    assert jda.paged_decode_supported(b, kp.shape[1], h, d, jnp.float32,
                                      s_q)
    ref = np.asarray(jda.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(fills), scale=scale, impl=impl))
    out = _port_paged(q, kp, vp, tables, fills, scale)
    assert out.shape == (b, s_q, h, d)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_paged_plain_equals_dense_plain_over_the_gathered_cache():
    """Bit for bit: gathering the pool through the tables and running the
    dense plain version is the paged plain version; a table that lays a
    dense cache out in blocks reads it back exactly."""
    q, kp, vp, tables, fills = _paged_inputs(3, seed=21)
    t = torch.from_numpy
    gathered = pda.paged_gather_kv(t(kp), t(tables))
    dense = pda.decode_attention(t(q), gathered, pda.paged_gather_kv(
        t(vp), t(tables)), t(fills), scale=0.125).numpy()
    np.testing.assert_array_equal(
        _port_paged(q, kp, vp, tables, fills, 0.125), dense)
    ref = np.asarray(jda.paged_gather_kv(jnp.asarray(kp),
                                         jnp.asarray(tables)))
    np.testing.assert_array_equal(gathered.numpy(), ref)   # mode="clip"


def test_query_that_sees_no_key_returns_zeros_and_cpu_never_launches():
    q, kp, vp, tables, fills = _paged_inputs(4, seed=5)
    fills = np.array([0, 2, 48, 52], np.int32)
    before = dict(_build.LAUNCHES)
    out = _port_paged(q, kp, vp, tables, fills, 0.125)
    assert not out[0].any()
    assert not out[1, :2].any() and np.all(np.any(out[1, 2:] != 0, (1, 2)))
    assert dict(_build.LAUNCHES) == before


def test_paged_kernel_shape_gate():
    assert pda.paged_decode_supported(1, 64, torch.bfloat16, 16)
    assert pda.paged_decode_supported(8, 128, torch.float32, 8)
    assert pda.paged_decode_supported(4, 32, torch.float32, 32)
    assert not pda.paged_decode_supported(1, 64, torch.bfloat16, 12)
    assert not pda.paged_decode_supported(1, 64, torch.bfloat16, 4)
    assert pda.paged_decode_supported(9, 64, torch.bfloat16, 16)
    assert pda.paged_decode_supported(24, 80, torch.bfloat16, 16)
    assert not pda.paged_decode_supported(1, 48, torch.float32, 16)
    assert pda.paged_decode_supported(1, 64, torch.float16, 16)
    assert not pda.paged_decode_supported(1, 64, torch.float64, 16)


def test_paged_write_sends_dropped_lanes_to_the_sink():
    """The model's paged write: live positions land in their table's
    blocks; the retired-lane sentinel (>= T*bs) and positions whose table
    entry is the padded_table sentinel land in the sink block nb and
    nowhere else."""
    from deepspeed_tpu_torch.models.gpt import (_kv_write_paged,
                                                paged_write_index)
    nb, bs, T, hd = 6, 4, 3, 2
    pool = torch.zeros(nb + 1, bs, hd)
    tables = torch.tensor([[2, 0, nb], [5, 1, 3], [4, nb, nb]],
                          dtype=torch.int32)
    kv = torch.arange(1, 3 * 2 * hd + 1, dtype=torch.float32).view(3, 2, hd)
    index = paged_write_index(tables, torch.tensor([3, T * bs, 3]), 2, bs,
                              nb)
    _kv_write_paged(pool, kv, index)
    scales = torch.zeros(nb + 1, bs)                 # an int8 scale pool
    _kv_write_paged(scales, kv[..., 0], index)
    assert scales[2, 3] == kv[0, 0, 0] and scales[nb, 0] == kv[2, 1, 0]
    # row 0: positions 3, 4 -> block 2 slot 3, block 0 slot 0
    assert torch.equal(pool[2, 3], kv[0, 0]) and torch.equal(pool[0, 0],
                                                             kv[0, 1])
    # row 2: position 3 -> block 4 slot 3; position 4 -> sentinel -> sink
    assert torch.equal(pool[4, 3], kv[2, 0])
    assert torch.equal(pool[nb, 0], kv[2, 1])
    written = {(2, 3), (0, 0), (4, 3)}
    for blk in range(nb):
        for slot in range(bs):
            if (blk, slot) not in written:
                assert not pool[blk, slot].any(), (blk, slot)


# ----------------------------------------------------- engine (the slice)
@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=0)


def _engines(pair, **kw):
    from deepspeed_tpu.serving import ServingEngine as JaxServing
    from deepspeed_tpu_torch import ServingEngine
    jmodel, params, pmodel = pair
    jax_eng = JaxServing(jmodel, model_parameters=params, dtype=jnp.float32,
                         **kw)
    return jax_eng, ServingEngine(pmodel, device="cpu", dtype=torch.float32,
                                  **kw)


@pytest.mark.parametrize("decode_chunk", [1, 8])
def test_paged_serving_greedy_identical_to_jax_and_to_dense(pair,
                                                            decode_chunk):
    from deepspeed_tpu_torch import ServingEngine
    ps = prompts()
    kw = dict(max_batch=3, max_prompt_len=32, max_queue=8,
              decode_chunk=decode_chunk, megakernel=True)
    ref_eng, eng = _engines(pair, paged=True, kv_block_size=8, **kw)
    ref = ref_eng.run([p.copy() for p in ps], max_new_tokens=9)
    before = dict(_build.LAUNCHES)
    out = eng.run([p.copy() for p in ps], max_new_tokens=9)
    assert dict(_build.LAUNCHES) == before       # plain versions on the CPU
    dense = ServingEngine(pair[2], device="cpu", dtype=torch.float32,
                          **kw).run([p.copy() for p in ps], max_new_tokens=9)
    for r, o, d in zip(ref, out, dense):
        assert o.status == "done" and len(o.tokens) == 9
        np.testing.assert_array_equal(o.output_ids, r.output_ids)
        np.testing.assert_array_equal(o.output_ids, d.output_ids)
    assert eng.metrics.n_prefix_misses == len(ps)
    assert eng.kv.allocator.blocks.n_free + eng.kv.prefix_cache.blocks_held \
        == eng.kv.num_blocks


def test_paged_mid_chunk_eos_parity(pair):
    ps = prompts(n=4, seed=1)
    kw = dict(max_batch=3, max_prompt_len=32, max_queue=8, decode_chunk=8,
              megakernel=True, paged=True, kv_block_size=8)
    ref_eng, eng = _engines(pair, **kw)
    base = eng.run([p.copy() for p in ps], max_new_tokens=11)
    eos = int(base[0].tokens[2])                 # retires mid-chunk
    ref = ref_eng.run([p.copy() for p in ps], max_new_tokens=11,
                      eos_token_id=eos)
    out = eng.run([p.copy() for p in ps], max_new_tokens=11,
                  eos_token_id=eos)
    cut = base[0].tokens.index(eos) + 1
    assert out[0].tokens == base[0].tokens[:cut]
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.output_ids, r.output_ids)


def test_shared_prefix_forks_share_blocks_until_divergence(pair):
    """Two requests with one 52-token prompt: the second admits as a
    prefix-cache hit (prefill runs once), shares the three full prompt
    blocks by refcount (both requests and the cache entry hold them) and
    privatizes the tail; tokens equal the TPU engine's."""
    from deepspeed_tpu_torch import ServingEngine
    common = np.random.default_rng(3).integers(1, 256, 52).astype(np.int32)
    kw = dict(max_batch=2, max_prompt_len=52, prefill_buckets=(52,),
              max_queue=4, paged=True, kv_block_size=16, decode_chunk=1)
    ref_eng, _ = _engines(pair, **kw)
    ref = ref_eng.run([common.copy(), common.copy()], max_new_tokens=8)
    eng = ServingEngine(pair[2], device="cpu", dtype=torch.float32,
                        megakernel=True, **kw)
    reqs = [eng.submit(common.copy(), max_new_tokens=8) for _ in range(2)]
    alloc = eng.kv.allocator
    seen_shared = False
    while eng.scheduler.has_work():
        eng.step()
        live = [r for r in reqs if r.status == "running"]
        if len(live) == 2 and not seen_shared:
            t0, t1 = (alloc.tables[r.slot] for r in live)
            assert t0[:3] == t1[:3] and t0[3] != t1[3]
            for blk in t0[:3]:
                assert int(alloc.blocks.refcount[blk]) == 3
            # the device tables name the same blocks
            dev_tables = eng.kv.block_tables[[r.slot for r in live]]
            assert dev_tables[0, :3].tolist() == t0[:3]
            assert dev_tables[1, :4].tolist() == t1[:4]
            seen_shared = True
    assert seen_shared
    assert eng.metrics.n_prefix_hits == 1 and eng.metrics.n_prefix_misses == 1
    assert eng.metrics.n_cow_forks == 2          # the miss's and the hit's
    assert eng.metrics.prefill_prompt_tokens == 52
    snap = eng.metrics.snapshot(0, 0.0)
    assert snap["serving/prefix_hit_rate"] == 0.5
    assert snap["serving/cow_forks"] == 2.0
    for r, o in zip(ref, reqs):
        np.testing.assert_array_equal(o.output_ids, r.output_ids)


def test_block_oom_queues_instead_of_crashing(pair):
    from deepspeed_tpu_torch import ServingEngine
    ps = [np.random.default_rng(5).integers(1, 256, 12).astype(np.int32)
          + i for i in range(4)]
    common = dict(max_batch=4, max_prompt_len=16, max_queue=8,
                  megakernel=True)
    dense = ServingEngine(pair[2], device="cpu", dtype=torch.float32,
                          **common).run([p.copy() for p in ps],
                                        max_new_tokens=8)
    # 3 blocks of 16 = 48 tokens: one 12+8 request per wave fits, never all
    eng = ServingEngine(pair[2], device="cpu", dtype=torch.float32,
                        paged=True, kv_block_size=16, kv_pool_blocks=3,
                        prefix_cache=False, **common)
    out = eng.run([p.copy() for p in ps], max_new_tokens=8)
    for d, o in zip(dense, out):
        assert o.status == "done"
        np.testing.assert_array_equal(o.output_ids, d.output_ids)
    assert eng.kv.allocator.peak_active < 4
    assert eng.kv.allocator.blocks.n_free == 3


def test_paged_arena_report_and_sampled_serving_keeps_prefix_off(pair):
    from deepspeed_tpu_torch import ServingEngine
    eng = ServingEngine(pair[2], device="cpu", dtype=torch.float32,
                        max_batch=2, max_prompt_len=20, paged=True,
                        kv_block_size=16)
    common = np.arange(1, 21, dtype=np.int32)
    eng.run([common.copy(), common.copy()], max_new_tokens=4)
    rep = eng.kv.arena_report()
    assert rep["layout"] == "paged"
    for key in ("arena_bytes", "kv_bytes", "bytes_per_token",
                "headroom_bytes", "n_active", "n_free"):
        assert key in rep
    assert rep["blocks_total"] == rep["blocks_used"] + rep["blocks_free"]
    assert rep["blocks_total"] == 2 * 64 // 16
    assert rep["bytes_per_block"] == 2 * 2 * 16 * 128 * 4   # L, k+v, f32
    assert rep["kv_bytes"] == (rep["blocks_total"] + 1) \
        * rep["bytes_per_block"]                           # with the sink
    assert rep["prefix_cache_entries"] == 1 and rep["kv_bytes_saved"] == 0
    sampled = ServingEngine(pair[2], device="cpu", dtype=torch.float32,
                            max_batch=2, max_prompt_len=20, paged=True,
                            temperature=1.0)
    assert not sampled.kv.prefix_enabled
