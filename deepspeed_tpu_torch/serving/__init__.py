"""Continuous-batching serving of the PyTorch port."""

from .engine import ServingEngine, default_prefill_buckets
from .kv_cache import SlotAllocator, SlotKVCacheManager
from .paged_kv import (BlockAllocator, PagedAdmitPlan, PagedKVCacheManager,
                       PagedSlotAllocator, PrefixCache)
from .scheduler import ContinuousBatchScheduler, Request

__all__ = ["ServingEngine", "ContinuousBatchScheduler", "Request",
           "default_prefill_buckets", "SlotAllocator", "SlotKVCacheManager",
           "BlockAllocator", "PrefixCache", "PagedAdmitPlan",
           "PagedSlotAllocator", "PagedKVCacheManager"]
