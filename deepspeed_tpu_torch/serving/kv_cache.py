"""Slotted KV-cache management for continuous-batching serving.

Counterpart of ``deepspeed_tpu/serving/kv_cache.py``. Every request leases
one fixed ``[max_seq, ...]`` slot row of a dense arena; the arena is two
tensors ``[L, max_batch, max_seq, h*d]`` (keys, values) in the model's
compute dtype, stored flat as the decode kernel reads them, or, under
``kv_cache_dtype="int8"``, int8 with f32 per-position dequant multipliers
``[L, max_batch, max_seq]`` beside them.

  * :class:`SlotAllocator` -- host-side accounting (free list, per-slot
    fill lengths, occupancy); a copy of the TPU package's.
  * :class:`SlotKVCacheManager` -- owns the arena tensors, the insert
    that moves prefilled prompts into their leased slot rows, and the
    arena's memory accounting (``arena_report``).
"""

from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np
import torch


class SlotAllocator:
    """A fixed pool of ``max_batch`` cache rows, each leased to at most one
    in-flight request, with per-slot fill lengths (valid KV positions).
    Lowest-index-first allocation keeps runs deterministic."""

    def __init__(self, max_batch: int, max_seq_len: int):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self._free: List[int] = list(range(max_batch))
        heapq.heapify(self._free)
        self.fill = np.zeros(max_batch, np.int32)
        self.active = np.zeros(max_batch, bool)

    def alloc(self, fill_len: int = 0) -> Optional[int]:
        """Lease the lowest free slot at ``fill_len`` valid positions; None
        when every slot is busy (the caller applies backpressure)."""
        if not self._free:
            return None
        if fill_len > self.max_seq_len:
            raise ValueError(
                f"fill_len {fill_len} exceeds max_seq_len {self.max_seq_len}")
        slot = heapq.heappop(self._free)
        self.active[slot] = True
        self.fill[slot] = fill_len
        return slot

    def free(self, slot: int) -> None:
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.active[slot] = False
        self.fill[slot] = 0
        heapq.heappush(self._free, slot)

    def advance(self, slots) -> None:
        """One decode step wrote one token into each of ``slots``."""
        self.fill[np.asarray(slots, np.int64)] += 1

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        return self.n_active / self.max_batch

    def remaining(self, slot: int) -> int:
        """Cache positions still writable in this slot's row."""
        return self.max_seq_len - int(self.fill[slot])


class SlotKVCacheManager:
    """The device arena plus its slot accounting. ``cache_k`` / ``cache_v``
    are ``[L, max_batch, max_seq_len, h*d]`` in the model's compute dtype,
    or int8 under ``cfg.kv_cache_dtype == "int8"`` with ``k_scale`` /
    ``v_scale`` f32 ``[L, max_batch, max_seq_len]`` (else None); the
    model's decode writes them in place. ``block_tables`` is None: the
    dense layout has none (the paged manager's does).

    ``lookahead`` positions past ``max_seq_len`` widen every row (the
    speculative engine passes its draft length k): a verify step writes and
    reads k + 1 positions from a lane's fill, and near the end of a row the
    decode kernel would otherwise clamp that lane's cache length to S and
    shift its queries' causal window. Nothing reads a lookahead position
    unmasked: every real query sits below ``max_seq_len``.

    Under tensor parallelism (``tp`` > 1) the arena holds this rank's
    ``num_heads / tp`` heads a position (the TPU package's ``kv_spec``:
    the flat ``h*d`` dim split over tp); the scales are whole-position
    ones, the same on every rank."""

    block_tables = None

    def __init__(self, cfg, max_batch: int, device, lookahead: int = 0,
                 tp: int = 1):
        self.max_seq_len = int(cfg.max_seq_len)
        self.allocator = SlotAllocator(max_batch, self.max_seq_len)
        # the fp itemsize the arena would use without int8 (arena_report's
        # kv_bytes_saved baseline)
        self._fp_itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        int8 = getattr(cfg, "kv_cache_dtype", "auto") == "int8"
        shape = (cfg.num_layers, max_batch,
                 self.max_seq_len + int(lookahead),
                 cfg.num_heads // int(tp) * cfg.head_dim)
        kv_dtype = torch.int8 if int8 else cfg.dtype
        self.cache_k = torch.zeros(shape, dtype=kv_dtype, device=device)
        self.cache_v = torch.zeros(shape, dtype=kv_dtype, device=device)
        self.k_scale = self.v_scale = None
        if int8:
            self.k_scale = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)
            self.v_scale = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)

    def insert_batch(self, keys: torch.Tensor, values: torch.Tensor,
                     slots, k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> None:
        """Move a bucketed prefill's K/V ``[L, n, P, h*d]`` (under int8:
        int8 payload plus f32 ``[L, n, P]`` or ``[L, n, P, 1]`` scales) into
        the n slot rows ``slots``. Only the bucket's prefix of each row is
        overwritten; stale tail positions from a previous occupant stay
        masked (fill < their position) until the new request's own decode
        writes them."""
        idx = torch.as_tensor(np.asarray(slots, np.int64),
                              device=self.cache_k.device)
        n, P = keys.shape[1], keys.shape[2]
        self.cache_k[:, idx, :P] = keys.to(self.cache_k.dtype)
        self.cache_v[:, idx, :P] = values.to(self.cache_v.dtype)
        if self.k_scale is not None:
            L = self.k_scale.shape[0]
            self.k_scale[:, idx, :P] = k_scale.reshape(L, n, P)
            self.v_scale[:, idx, :P] = v_scale.reshape(L, n, P)

    def arena_report(self) -> dict:
        """Memory accounting of the arena: total/kv/index bytes, the int8
        payload and scale bytes and what the same payload would cost in the
        compute dtype, the per-slot and per-token costs and the headroom
        (bytes the free slots could still hold), as the TPU package reports
        them. ``index_bytes`` is 0: the per-slot fills live on the host."""
        pools = [self.cache_k, self.cache_v]
        int8_payload = scale_bytes = 0
        if self.k_scale is not None:
            int8_payload = 2 * self.cache_k.numel()
            pools += [self.k_scale, self.v_scale]
            scale_bytes = 2 * self.k_scale.numel() * 4
        kv_bytes = sum(t.numel() * t.element_size() for t in pools)
        kv_bytes_fp = (kv_bytes - int8_payload - scale_bytes
                       + int8_payload * self._fp_itemsize)
        alloc = self.allocator
        per_slot = kv_bytes // alloc.max_batch
        return {
            "arena_bytes": kv_bytes,
            "kv_bytes": kv_bytes,
            "index_bytes": 0,
            "int8_payload_bytes": int8_payload,
            "scale_bytes": scale_bytes,
            "kv_bytes_fp_equiv": kv_bytes_fp,
            "kv_bytes_saved": kv_bytes_fp - kv_bytes,
            "max_batch": alloc.max_batch,
            "max_seq_len": self.max_seq_len,
            "bytes_per_slot": per_slot,
            "bytes_per_token": per_slot // self.max_seq_len,
            "n_active": alloc.n_active,
            "n_free": alloc.n_free,
            "active_bytes": alloc.n_active * per_slot,
            "headroom_bytes": alloc.n_free * per_slot,
        }

    @property
    def fill(self) -> np.ndarray:
        return self.allocator.fill

    @property
    def occupancy(self) -> float:
        return self.allocator.occupancy
