"""Slotted KV-cache management for continuous-batching serving.

Counterpart of ``deepspeed_tpu/serving/kv_cache.py``. Every request leases
one fixed ``[max_seq, ...]`` slot row of a dense arena; the arena is two
tensors ``[L, max_batch, max_seq, h*d]`` (keys, values) in the model's
compute dtype, stored flat as the decode kernel reads them.

  * :class:`SlotAllocator` -- host-side accounting (free list, per-slot
    fill lengths, occupancy); a copy of the TPU package's.
  * :class:`SlotKVCacheManager` -- owns the arena tensors and the insert
    that moves prefilled prompts into their leased slot rows.
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
    are ``[L, max_batch, max_seq_len, h*d]``; the model's decode writes them
    in place."""

    def __init__(self, cfg, max_batch: int, device):
        self.max_seq_len = int(cfg.max_seq_len)
        self.allocator = SlotAllocator(max_batch, self.max_seq_len)
        shape = (cfg.num_layers, max_batch, self.max_seq_len,
                 cfg.num_heads * cfg.head_dim)
        self.cache_k = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.cache_v = torch.zeros(shape, dtype=cfg.dtype, device=device)

    def insert_batch(self, keys: torch.Tensor, values: torch.Tensor,
                     slots) -> None:
        """Move a bucketed prefill's K/V ``[L, n, P, h*d]`` into the n slot
        rows ``slots``. Only the bucket's prefix of each row is overwritten;
        stale tail positions from a previous occupant stay masked (fill <
        their position) until the new request's own decode writes them."""
        idx = torch.as_tensor(np.asarray(slots, np.int64),
                              device=self.cache_k.device)
        P = keys.shape[2]
        self.cache_k[:, idx, :P] = keys.to(self.cache_k.dtype)
        self.cache_v[:, idx, :P] = values.to(self.cache_v.dtype)

    @property
    def fill(self) -> np.ndarray:
        return self.allocator.fill
