"""Paged KV cache: block tables, copy-on-write forking, prefix sharing.

Counterpart of ``deepspeed_tpu/serving/paged_kv.py``. The slotted arena
(serving/kv_cache.py) pins ``max_seq_len`` positions per slot; here the KV
arena is a pool of fixed-size blocks ``[L, nb, bs, h*d]`` and each slot holds
a block table (``T = max_seq_len // bs`` entries) that the model's paged
write scatters through and the paged decode kernel reads through. Blocks are
refcounted: a prefix-cache entry and any number of live requests may share a
block read-only; a writer copies it first (COW). A prefix cache keyed on the
prompt's token bytes lets a repeated prompt skip prefill: its full blocks
are shared by refcount, its partial tail block is forked, and the stored
greedy first token seeds decode.

Allocation is upfront reservation: a request leases
``ceil((prompt_len + max_new_tokens) / bs)`` blocks at admission or waits
(FIFO); ``REJECT_KV_OOM`` at submit for requests no empty pool could hold.
Bit parity with the dense arena needs ``bs | max_seq_len``, enforced at
construction.

The host classes (:class:`BlockAllocator`, :class:`PrefixCache`,
:class:`PagedAdmitPlan`, :class:`PagedSlotAllocator`) are copies of the TPU
package's, without the tiered-KV hook. :class:`PagedKVCacheManager` owns the
device pools. Unlike JAX's scatter, an out-of-range index on a CUDA tensor
is a device-side assert, so writes are never dropped by index range: every
pool has one sink block past the ``nb`` real ones (index ``nb``, the
``padded_table`` sentinel), which no table names as a real block and no read
unmasks, and every dropped write (a retired lane pinned at ``max_seq_len``, a
position past a reservation, a prefill position past the prompt) lands
there. Device work is enqueued on one stream, so enqueue order is the write
order: hit forks go before miss inserts, and a COW source's temporary hold
is released only after its copy is enqueued.

Not ported here (see ROADMAP.md): the tier hook (``attach_tier`` and the
tier-deferral of ``alloc_request``) and ``alloc_span``/``export_*``/
``import_blocks`` (migration).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch


class BlockAllocator:
    """Refcounted fixed-size block pool with an LRU free list.

    ``alloc`` returns the least-recently-freed block (FIFO recycle order)
    or None when the pool is exhausted; OOM is a value, never an
    exception."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: Deque[int] = deque(range(num_blocks))
        self.refcount = np.zeros(num_blocks, np.int32)
        self.peak_used = 0

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        block = self._free.popleft()
        self.refcount[block] = 1
        self.peak_used = max(self.peak_used, self.n_used)
        return block

    def incref(self, block: int) -> None:
        if self.refcount[block] < 1:
            raise ValueError(f"block {block} is not allocated")
        self.refcount[block] += 1

    def decref(self, block: int) -> None:
        if self.refcount[block] < 1:
            raise ValueError(f"block {block} is not allocated")
        self.refcount[block] -= 1
        if self.refcount[block] == 0:
            self._free.append(block)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.num_blocks - len(self._free)


@dataclasses.dataclass
class _PrefixEntry:
    blocks: Tuple[int, ...]      # every prompt block, in position order
    prompt_len: int
    first_token: int             # greedy-deterministic token #1


class PrefixCache:
    """LRU map from prompt token bytes -> cached prompt blocks.

    Keyed on the exact token sequence (``prompt.tobytes()``), so a hit
    shares the whole prompt: full blocks by refcount, the partial tail by
    COW. Entries hold their own refcount on every block, so cached prefixes
    outlive the request that created them; eviction (capacity or allocator
    pressure) drops those refs and frees what no live request shares."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._entries: "OrderedDict[bytes, _PrefixEntry]" = OrderedDict()
        self.hits = 0            # successful hit-plan admissions
        self.misses = 0          # successful miss-plan admissions
        self.evictions = 0

    @staticmethod
    def key_for(prompt) -> bytes:
        return np.asarray(prompt, np.int32).tobytes()

    def lookup(self, key: bytes) -> Optional[_PrefixEntry]:
        """Peek without touching the hit/miss counters (the allocator counts
        only a successful lease)."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def put(self, key: bytes, blocks: Tuple[int, ...], prompt_len: int,
            first_token: int, block_allocator: BlockAllocator) -> bool:
        if self.capacity <= 0 or key in self._entries:
            return False
        for b in blocks:
            block_allocator.incref(b)
        self._entries[key] = _PrefixEntry(tuple(blocks), prompt_len,
                                          first_token)
        while len(self._entries) > self.capacity:
            self.evict_lru(block_allocator)
        return True

    def pop(self, key: bytes, block_allocator: BlockAllocator) -> None:
        entry = self._entries.pop(key, None)
        if entry is not None:
            for b in entry.blocks:
                block_allocator.decref(b)

    def evict_lru(self, block_allocator: BlockAllocator) -> bool:
        if not self._entries:
            return False
        _, entry = self._entries.popitem(last=False)
        for b in entry.blocks:
            block_allocator.decref(b)
        self.evictions += 1
        return True

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def blocks_held(self) -> int:
        return sum(len(e.blocks) for e in self._entries.values())


@dataclasses.dataclass
class PagedAdmitPlan:
    """What ``alloc_request`` decided for one admitted request; the engine
    pops it (``take_plan``) and turns it into device work: a fork for a hit,
    prefill + scatter-insert (+ ``commit_prefix``) for a miss."""
    slot: int
    hit: bool
    key: Optional[bytes]         # None: prefix caching off for this request
    fill: int                    # prompt_len (the slot's starting fill)
    first_token: Optional[int]   # hits only: cached greedy token #1
    cow: Optional[Tuple[int, int]]   # (src, dst) tail fork; hits only
    n_shared: int                # full blocks shared by refcount


class PagedSlotAllocator:
    """Slot accounting over a block pool: the dense
    :class:`~deepspeed_tpu_torch.serving.kv_cache.SlotAllocator` interface
    (``fill``/``active``/``advance``/``remaining``/``free``/occupancy) plus
    block tables, request-shaped allocation (``alloc_request``) and
    prefix-cache commit. Host-side only."""

    def __init__(self, max_batch: int, max_seq_len: int, *,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: Optional[PrefixCache] = None,
                 prefix_caching: bool = True):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_seq_len % block_size != 0:
            raise ValueError(
                f"block_size {block_size} must divide max_seq_len "
                f"{max_seq_len} (bit-parity needs T*block_size == max_seq)")
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.blocks_per_seq = max_seq_len // block_size
        if num_blocks is None:
            # pool bytes == dense arena bytes: the equal-memory comparison
            num_blocks = max_batch * self.blocks_per_seq
        self.blocks = BlockAllocator(num_blocks, block_size)
        self.prefix = prefix_cache if prefix_cache is not None \
            else PrefixCache()
        self.prefix_enabled = prefix_caching
        self._free_slots: List[int] = list(range(max_batch))
        heapq.heapify(self._free_slots)
        self.fill = np.zeros(max_batch, np.int32)
        self.active = np.zeros(max_batch, bool)
        self.tables: List[List[int]] = [[] for _ in range(max_batch)]
        self.plans: Dict[int, PagedAdmitPlan] = {}
        self._pending: set = set()   # prompt keys mid-prefill (defer dups)
        self.peak_active = 0
        self.cow_forks = 0

    # ------------------------------------------------------------- leases
    def alloc_request(self, req) -> Optional[int]:
        """Plan one request's admission: lease a slot plus its full block
        reservation (prompt + max_new budget), sharing/forking through the
        prefix cache when the prompt is cached. None = not admissible yet
        (no slot, not enough blocks even after cache eviction, or an
        identical prompt is mid-prefill: admitting it next pass turns a
        duplicate prefill into a hit). The decision is recorded in
        ``self.plans[slot]`` for the engine."""
        if not self._free_slots:
            return None
        bs = self.block_size
        pl_ = int(req.prompt_len)
        n_total = -(-(pl_ + int(req.max_new_tokens)) // bs)
        if n_total > self.blocks_per_seq:
            n_total = self.blocks_per_seq    # submit() caps at max_seq_len
        key = PrefixCache.key_for(req.prompt) if self.prefix_enabled \
            else None
        entry = None
        if key is not None:
            if key in self._pending:
                return None
            entry = self.prefix.lookup(key)
        if entry is not None:
            return self._lease_hit(req, key, entry, n_total)
        return self._lease_miss(req, key, pl_, n_total)

    def _lease_hit(self, req, key, entry, n_total) -> Optional[int]:
        bs = self.block_size
        pl_ = int(req.prompt_len)
        n_full = pl_ // bs                   # shareable read-only
        has_tail = pl_ % bs != 0
        n_new = n_total - n_full             # COW dst (if tail) + fresh
        if not self._ensure_free(n_new):
            return None
        shared = list(entry.blocks[:n_full])
        for b in shared:
            self.blocks.incref(b)
        new_blocks = [self.blocks.alloc() for _ in range(n_new)]
        cow = None
        if has_tail:
            src = entry.blocks[n_full]
            # temporary hold: a later same-round eviction must not free the
            # COW source before the device copy is enqueued (released by
            # PagedKVCacheManager.apply_fork)
            self.blocks.incref(src)
            cow = (src, new_blocks[0])
            self.cow_forks += 1
        slot = self._take_slot(pl_, shared + new_blocks)
        self.plans[slot] = PagedAdmitPlan(
            slot=slot, hit=True, key=key, fill=pl_,
            first_token=entry.first_token, cow=cow, n_shared=n_full)
        self.prefix.hits += 1
        return slot

    def _lease_miss(self, req, key, pl_, n_total) -> Optional[int]:
        if not self._ensure_free(n_total):
            return None
        table = [self.blocks.alloc() for _ in range(n_total)]
        slot = self._take_slot(pl_, table)
        if key is not None:
            self._pending.add(key)
            self.prefix.misses += 1
        self.plans[slot] = PagedAdmitPlan(
            slot=slot, hit=False, key=key, fill=pl_,
            first_token=None, cow=None, n_shared=0)
        return slot

    def _take_slot(self, fill_len: int, table: List[int]) -> int:
        slot = heapq.heappop(self._free_slots)
        self.active[slot] = True
        self.fill[slot] = fill_len
        self.tables[slot] = table
        self.peak_active = max(self.peak_active, self.n_active)
        return slot

    def _ensure_free(self, n: int) -> bool:
        """Evict cold prefix-cache entries until ``n`` blocks are free.
        Entries shared with live requests may free nothing; each eviction
        still retires one entry, so the loop ends."""
        while self.blocks.n_free < n:
            if not self.prefix.evict_lru(self.blocks):
                return False
        return True

    def alloc(self, fill_len: int = 0) -> Optional[int]:
        """Dense-compatible lease (no Request in hand): reserves the full
        per-sequence block budget, skipping the prefix cache. The scheduler
        prefers ``alloc_request``."""
        if fill_len > self.max_seq_len:
            raise ValueError(
                f"fill_len {fill_len} exceeds max_seq_len {self.max_seq_len}")
        if not self._free_slots:
            return None
        if not self._ensure_free(self.blocks_per_seq):
            return None
        table = [self.blocks.alloc() for _ in range(self.blocks_per_seq)]
        return self._take_slot(fill_len, table)

    def free(self, slot: int) -> None:
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        for b in self.tables[slot]:
            self.blocks.decref(b)
        self.tables[slot] = []
        self.active[slot] = False
        self.fill[slot] = 0
        self.plans.pop(slot, None)
        heapq.heappush(self._free_slots, slot)

    def advance(self, slots) -> None:
        self.fill[np.asarray(slots, np.int64)] += 1

    # ------------------------------------------------------ prefix commit
    def commit_prefix(self, slot: int, key: Optional[bytes],
                      first_token: int) -> Optional[Tuple[int, int]]:
        """After a miss's prefill lands: cache the prompt blocks under
        ``key``. If the prompt ends mid-block the request's tail block is
        now shared with the cache, so the request forks it: a fresh block
        replaces it in the table (the cache keeps the original). Returns the
        (src, dst) pair the caller must copy on the device, or None."""
        if key is None:
            return None
        self._pending.discard(key)
        if not self.active[slot]:
            return None                      # request already retired
        bs = self.block_size
        pl_ = int(self.fill[slot])
        n_prompt = -(-pl_ // bs)
        prompt_blocks = tuple(self.tables[slot][:n_prompt])
        if not self.prefix.put(key, prompt_blocks, pl_, int(first_token),
                               self.blocks):
            return None
        if pl_ % bs == 0:
            return None                      # tail is block-aligned
        src = self.tables[slot][n_prompt - 1]
        dst = self.blocks.alloc()
        if dst is None:
            # cannot privatize the tail: un-cache instead of sharing a block
            # the request is about to write into
            self.prefix.pop(key, self.blocks)
            return None
        self.tables[slot][n_prompt - 1] = dst
        self.blocks.decref(src)              # slot's ref; cache keeps one
        self.cow_forks += 1
        return (src, dst)

    def release_cow_hold(self, block: int) -> None:
        """Drop the temporary refcount a hit plan held on its COW source
        (call strictly after the device copy is enqueued)."""
        self.blocks.decref(block)

    def padded_table(self, slot: int) -> np.ndarray:
        """The slot's table padded to ``blocks_per_seq`` entries with the
        ``num_blocks`` sentinel, not 0: an entry past the reservation must
        never name a real block (a 0 pad would let a write past the
        reservation corrupt block 0, likely leased elsewhere)."""
        out = np.full(self.blocks_per_seq, self.blocks.num_blocks,
                      np.int32)
        table = self.tables[slot]
        out[:len(table)] = table
        return out

    # ------------------------------------------------------------ queries
    def remaining(self, slot: int) -> int:
        """Cache positions still writable: bounded by the slot's own block
        reservation, not the arena row extent."""
        return len(self.tables[slot]) * self.block_size \
            - int(self.fill[slot])

    @property
    def pool_capacity_tokens(self) -> int:
        return self.blocks.num_blocks * self.block_size

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def occupancy(self) -> float:
        return self.n_active / self.max_batch


class PagedKVCacheManager:
    """The device block pool. ``cache_k``/``cache_v`` are
    ``[L, nb + 1, bs, h*d]`` (block ``nb`` is the sink), in the model's
    compute dtype or int8; under int8, ``k_scale``/``v_scale`` are f32
    ``[L, nb + 1, bs]`` dequant multipliers (else None). One device
    ``block_tables [max_batch, T]`` int32 serves every layer (the TPU
    package's per-layer copies are identical); rows of slots no request
    holds name the sink. Drop-in for
    :class:`~deepspeed_tpu_torch.serving.kv_cache.SlotKVCacheManager` on the
    engine side (``insert_batch``, ``arena_report``, the allocator
    passthrough), plus ``apply_fork``/``commit_prefix``/``take_plan`` for
    the paged admission flow and ``install_table``/``abandon_plan`` for the
    fused-prefill one.

    ``lookahead`` positions past ``max_seq_len`` widen the device tables
    by ``ceil(lookahead / block_size)`` sink entries (the speculative
    engine passes its draft length k): a verify step near the end of a row
    then reads and writes through sink entries instead of having its cache
    length clamped to T * block_size by the decode kernel.

    Under tensor parallelism (``tp`` > 1) each pool position holds this
    rank's ``num_heads / tp`` heads (``kv_spec``); every rank keeps the
    same tables and allocator state, since every rank admits alike."""

    def __init__(self, cfg, max_batch: int, device, *,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache_capacity: int = 64,
                 prefix_caching: bool = True, lookahead: int = 0,
                 tp: int = 1):
        self.max_seq_len = int(cfg.max_seq_len)
        self.block_size = int(block_size)
        self.allocator = PagedSlotAllocator(
            max_batch, self.max_seq_len, block_size=self.block_size,
            num_blocks=num_blocks,
            prefix_cache=PrefixCache(prefix_cache_capacity),
            prefix_caching=prefix_caching)
        self.num_blocks = nb = self.allocator.blocks.num_blocks
        self.blocks_per_seq = T = self.allocator.blocks_per_seq
        int8 = getattr(cfg, "kv_cache_dtype", "auto") == "int8"
        # the fp itemsize the pool would use without int8 (arena_report's
        # kv_bytes_saved baseline)
        self._fp_itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        L, hd = cfg.num_layers, cfg.num_heads // int(tp) * cfg.head_dim
        shape = (L, nb + 1, self.block_size, hd)
        kv_dtype = torch.int8 if int8 else cfg.dtype
        self.cache_k = torch.zeros(shape, dtype=kv_dtype, device=device)
        self.cache_v = torch.zeros(shape, dtype=kv_dtype, device=device)
        self.k_scale = self.v_scale = None
        if int8:
            self.k_scale = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)
            self.v_scale = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)
        T_dev = T + -(-int(lookahead) // self.block_size)
        self.block_tables = torch.full((max_batch, T_dev), nb,
                                       dtype=torch.int32, device=device)

    def _pools(self):
        pools = [self.cache_k, self.cache_v]
        if self.k_scale is not None:
            pools += [self.k_scale, self.v_scale]
        return pools

    def _install_table(self, slot: int) -> None:
        self.block_tables[slot, :self.blocks_per_seq] = torch.from_numpy(
            self.allocator.padded_table(slot)).to(self.block_tables.device)

    def _copy_block(self, src: int, dst: int) -> None:
        for pool in self._pools():
            pool[:, dst] = pool[:, src]

    # ----------------------------------------------------------- mutation
    def insert_batch(self, keys: torch.Tensor, values: torch.Tensor, slots,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> None:
        """Scatter a bucketed prefill's K/V ``[L, n, P, h*d]`` (under int8:
        int8 payload plus f32 ``[L, n, P]`` or ``[L, n, P, 1]`` scales)
        into the n slots' reserved blocks and install their tables.
        Position p of row i lands at flat pool index
        ``table[i, p // bs] * bs + p % bs``; positions at or past the slot's
        fill (the prompt length) go to the sink."""
        dev = self.cache_k.device
        bs, nb = self.block_size, self.num_blocks
        n, P = keys.shape[1], keys.shape[2]
        tables = np.stack([self.allocator.padded_table(int(s))
                           for s in slots])                      # [n, T]
        fills = self.allocator.fill[np.asarray(slots, np.int64)]
        p = np.arange(P)
        flat = tables[:, p // bs].astype(np.int64) * bs + p % bs  # [n, P]
        flat = np.where(p[None, :] < fills[:, None], flat, nb * bs)
        idx = torch.from_numpy(flat.reshape(-1)).to(dev)
        parts = [(self.cache_k, keys), (self.cache_v, values)]
        if self.k_scale is not None:
            parts += [(self.k_scale, k_scale), (self.v_scale, v_scale)]
        for pool, src in parts:
            L = pool.shape[0]
            flat_pool = pool.view(L, (nb + 1) * bs, -1)
            flat_pool.index_copy_(
                1, idx, src.reshape(L, n * P, -1).to(pool.dtype))
        self.block_tables[torch.from_numpy(np.asarray(slots, np.int64)).to(
            dev), :self.blocks_per_seq] = torch.from_numpy(tables).to(dev)

    def apply_fork(self, plan: PagedAdmitPlan) -> None:
        """Realize a prefix-cache hit on the device: install the slot's
        table and copy the partial tail block (nothing to copy when the
        prompt is block-aligned). Releases the plan's temporary hold on the
        COW source once the copy is enqueued."""
        self._install_table(plan.slot)
        if plan.cow is not None:
            self._copy_block(*plan.cow)
            self.allocator.release_cow_hold(plan.cow[0])

    def commit_prefix(self, plan: PagedAdmitPlan,
                      first_token: int) -> Optional[Tuple[int, int]]:
        """After a miss's prefill and insert: publish the prompt blocks to
        the prefix cache and, when the prompt ends mid-block, copy the
        request's tail into its fresh block and install the changed table,
        so the cached tail stays immutable."""
        cow = self.allocator.commit_prefix(plan.slot, plan.key, first_token)
        if cow is not None:
            self._copy_block(*cow)
            self._install_table(plan.slot)
        return cow

    def take_plan(self, slot: int) -> PagedAdmitPlan:
        return self.allocator.plans.pop(slot)

    def install_table(self, slot: int) -> None:
        """Install a miss lane's block table without a prefill insert
        (deepspeed_tpu/serving/paged_kv.py:686): the fused-prefill
        admission, whose decode chunk writes the prompt's K/V through the
        table from position 0."""
        self._install_table(slot)

    def abandon_plan(self, plan: PagedAdmitPlan) -> None:
        """Walk back a miss plan whose lane retired before its first token
        (a fused lane cancelled or expired mid-prompt,
        deepspeed_tpu/serving/paged_kv.py:701): drop its pending-prompt key
        so an identical prompt stops waiting on a commit that will not
        come. The lane's blocks free with its slot."""
        if plan.key is not None:
            self.allocator._pending.discard(plan.key)

    # ---------------------------------------------------------- accounting
    def arena_report(self) -> dict:
        """Block-pool memory accounting: the dense report's keys
        (``arena_bytes``/``kv_bytes``/``index_bytes``/``bytes_per_slot``/
        ``headroom_bytes``/``n_active``/``n_free``, the int8 payload, scale
        and fp-equivalent bytes) plus the block-pool view. The sink block is
        counted in ``kv_bytes`` (it is device memory) and nowhere else."""
        kv_bytes = sum(t.numel() * t.element_size() for t in self._pools())
        index_bytes = self.block_tables.numel() * 4
        int8_payload = scale_bytes = 0
        if self.k_scale is not None:
            int8_payload = 2 * self.cache_k.numel()
            scale_bytes = kv_bytes - int8_payload
        kv_bytes_fp = (kv_bytes - int8_payload - scale_bytes
                       + int8_payload * self._fp_itemsize)
        al = self.allocator
        pool_blocks = self.num_blocks + 1
        bytes_per_block = kv_bytes // pool_blocks
        bytes_per_token = bytes_per_block // self.block_size
        used, free_ = al.blocks.n_used, al.blocks.n_free
        held = al.prefix.blocks_held
        return {
            "layout": "paged",
            "arena_bytes": kv_bytes + index_bytes,
            "kv_bytes": kv_bytes,
            "index_bytes": index_bytes,
            "int8_payload_bytes": int8_payload,
            "scale_bytes": scale_bytes,
            "kv_bytes_fp_equiv": kv_bytes_fp,
            "kv_bytes_saved": kv_bytes_fp - kv_bytes,
            "max_batch": al.max_batch,
            "max_seq_len": self.max_seq_len,
            "block_size": self.block_size,
            "blocks_total": self.num_blocks,
            "blocks_used": used,
            "blocks_free": free_,
            "blocks_peak_used": al.blocks.peak_used,
            "blocks_per_seq": al.blocks_per_seq,
            "sink_blocks": 1,
            "bytes_per_block": bytes_per_block,
            "bytes_per_token": bytes_per_token,
            "bytes_per_slot": bytes_per_token * self.max_seq_len,
            "n_active": al.n_active,
            "n_free": al.n_free,
            "active_bytes": used * bytes_per_block,
            "headroom_bytes": free_ * bytes_per_block,
            "prefix_cache_entries": len(al.prefix),
            "prefix_cache_blocks": held,
            "prefix_cache_share": held / self.num_blocks,
        }

    # ---------------------------------------------- allocator passthrough
    @property
    def prefix_enabled(self) -> bool:
        return self.allocator.prefix_enabled

    @property
    def prefix_cache(self) -> PrefixCache:
        return self.allocator.prefix

    @property
    def fill(self) -> np.ndarray:
        return self.allocator.fill

    @property
    def occupancy(self) -> float:
        return self.allocator.occupancy
