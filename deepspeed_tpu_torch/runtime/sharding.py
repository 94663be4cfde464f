"""ZeRO partitioning of the optimizer state over data parallelism.

Counterpart of ``ShardingRules.master_spec`` / ``grad_spec``
(``deepspeed_tpu/runtime/sharding.py:228-245``) at stages 0 and 1 over dp
only. From stage 1 on each leaf is flattened and zero-padded to a multiple
of dp, and rank r owns one contiguous ``ceil(numel / dp)`` slice of it: of
the fp32 master and of every optimizer moment. That is the reference's
stage-1 layout and the TPU package's host-shard tier
(``runtime/zero/offload.py:502-532``), whose shard files
``checkpoint/zero_to_fp32.py`` merges by offset. The TPU rule shards a
divisible dimension instead; every update is elementwise (Lamb's norms are
all-reduced), so both layouts compute the same step. Gradients stay whole
below stage 2 (an all-reduce). The tp, ep and kv specs wait for ROADMAP A9.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """Rank ``rank``'s slice of one flattened leaf: elements
    ``[offset, offset + numel)`` of the leaf zero-padded to ``padded``;
    indices past ``global_numel`` are padding. The fields (``path``,
    ``offset``, ``numel``, ``padded``, ``global_numel``, ``shape``) are the
    host-shard files' per-leaf metadata."""
    path: str
    shape: Tuple[int, ...]
    offset: int
    numel: int
    padded: int
    global_numel: int

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``full`` (the whole leaf, any shape), as a
        new flat tensor; the padding is zeros."""
        flat = full.reshape(-1)
        hi = min(self.offset + self.numel, self.global_numel)
        part = flat[self.offset:max(hi, self.offset)]
        return F.pad(part, (0, self.numel - part.numel()))

    def unpad(self, gathered: torch.Tensor) -> torch.Tensor:
        """The whole leaf from its ``[padded]`` gathered form."""
        return gathered[:self.global_numel].view(self.shape)


class ShardingRules:
    """Which part of each leaf's master, moments and gradient a rank
    holds, at ZeRO ``zero_stage`` over ``dp`` ranks."""

    def __init__(self, dp: int = 1, zero_stage: int = 0, rank: int = 0):
        if zero_stage >= 2:
            raise NotImplementedError(
                f"ZeRO stage {zero_stage}: not ported to PyTorch yet "
                f"(ROADMAP A8)")
        self.dp, self.stage, self.rank = dp, zero_stage, rank

    @property
    def partitioned(self) -> bool:
        return self.stage >= 1 and self.dp > 1

    def _shard(self, path: str, shape, parts: int) -> LeafShard:
        shape = tuple(shape)
        total = math.prod(shape)
        per = -(-total // parts)
        rank = self.rank if parts > 1 else 0
        return LeafShard(path, shape, rank * per, per, per * parts, total)

    def master_spec(self, path: str, shape) -> LeafShard:
        """fp32 master and optimizer moments: partitioned from stage 1 on."""
        return self._shard(path, shape, self.dp if self.partitioned else 1)

    def grad_spec(self, path: str, shape) -> LeafShard:
        """Gradients: whole below stage 2 (all-reduced, not scattered)."""
        return self._shard(path, shape, 1)
