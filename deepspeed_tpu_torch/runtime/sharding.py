"""ZeRO partitioning over data parallelism.

Counterpart of ``ShardingRules`` (``deepspeed_tpu/runtime/sharding.py``):
``master_spec`` / ``grad_spec`` / ``param_spec`` at stages 0-3 over dp
only. A partitioned leaf is flattened and zero-padded to a multiple of dp,
and rank r owns one contiguous ``ceil(numel / dp)`` slice of it. That is
the reference's flat-partition layout and the TPU package's host-shard tier
(``runtime/zero/offload.py:502-532``), whose shard files
``checkpoint/zero_to_fp32.py`` merges by offset. The TPU rule shards a
divisible dimension instead; every update is elementwise (Lamb's norms are
all-reduced), so both layouts compute the same step.

  * stage 1: the fp32 master and every optimizer moment are partitioned;
    gradients stay whole (all-reduced);
  * stage 2: gradients too (reduce-scattered into this rank's slice of the
    fp32 accumulator);
  * stage 3: the compute parameters too, except leaves of at most
    ``param_persistence_threshold`` elements, which stay whole on every rank
    (the reference's persistence set, zero/config.py
    stage3_param_persistence_threshold). An embedding table
    (``_is_embed_table``) is partitioned only when dp divides its vocab dim:
    its flat slice is then a block of whole rows, the TPU package's
    vocab-dim rule (``_stage3_embed_spec``); otherwise it stays whole, as
    there.

The leaves are a rank's own: over ep > 1 an expert bank holds this
rank's experts only (``moe.set_expert_parallel``), and the dp slices are
of that. The tp and kv specs wait for ROADMAP A9.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils.logging import logger

_EMBED_PAT = re.compile(r"(wte|embed|embedding)")


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

    @property
    def partitioned(self) -> bool:
        """True when the leaf is split over more than one rank."""
        return self.numel != self.padded

    @property
    def valid(self) -> int:
        """Elements of this slice that lie inside the leaf (the rest is
        padding)."""
        return max(min(self.numel, self.global_numel - self.offset), 0)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``full`` (the whole leaf, any shape), as a
        new flat tensor; the padding is zeros."""
        flat = full.reshape(-1)
        part = flat[self.offset:self.offset + self.valid]
        return F.pad(part, (0, self.numel - part.numel()))

    def unpad(self, gathered: torch.Tensor) -> torch.Tensor:
        """The whole leaf from its ``[padded]`` gathered form."""
        return gathered[:self.global_numel].view(self.shape)


class ShardingRules:
    """Which part of each leaf's master, moments, gradient and compute
    parameter a rank holds, at ZeRO ``zero_stage`` over ``dp`` ranks."""

    def __init__(self, dp: int = 1, zero_stage: int = 0, rank: int = 0,
                 param_persistence_threshold: int = 0):
        if not 0 <= zero_stage <= 3:
            raise ValueError(f"ZeRO stage {zero_stage}: use 0-3")
        self.dp, self.stage, self.rank = dp, zero_stage, rank
        self.param_persistence_threshold = int(param_persistence_threshold)

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
        """Gradients: reduce-scattered from stage 2 on (the accumulator
        holds this rank's slice), whole and all-reduced below."""
        split = self.stage >= 2 and self.dp > 1
        return self._shard(path, shape, self.dp if split else 1)

    @staticmethod
    def _is_embed_table(path: str, shape) -> bool:
        return bool(_EMBED_PAT.search(path)
                    and path.endswith(("weight", "embedding"))
                    and len(shape) >= 2)

    def param_spec(self, path: str, shape) -> LeafShard:
        """Compute parameters: from stage 3 on, leaves above the
        persistence threshold are partitioned; an embedding table only
        when dp divides its vocab dim."""
        shape = tuple(shape)
        split = (self.stage >= 3 and self.dp > 1
                 and math.prod(shape) > self.param_persistence_threshold)
        if split and self._is_embed_table(path, shape):
            vdim = len(shape) - 2
            if shape[vdim] % self.dp:
                logger.warning(
                    f"stage-3: embedding table {path} {shape} stays whole on "
                    f"every rank (its vocab dim {shape[vdim]} does not "
                    f"divide by dp={self.dp}); pad the vocab to shard it")
                split = False
        return self._shard(path, shape, self.dp if split else 1)
