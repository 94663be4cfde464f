"""Continuous-batching serving of the PyTorch port."""

from .engine import ServingEngine, default_prefill_buckets
from .scheduler import ContinuousBatchScheduler, Request

__all__ = ["ServingEngine", "ContinuousBatchScheduler", "Request",
           "default_prefill_buckets"]
