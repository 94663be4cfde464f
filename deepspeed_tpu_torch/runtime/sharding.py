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
rank's experts only (``moe.set_expert_parallel``), and over tp > 1 a split
leaf holds this rank's tp shard only (:class:`TpSplit`); the dp slices are
of that.

Tensor parallelism (Megatron's column / row split keyed on the parameter
name, the TPU package's ``tp_spec`` / ``kv_spec``):

  * :func:`tp_spec` and :func:`kv_spec` are the TPU package's rules, on its
    flax paths ("/"-joined), returning the PartitionSpec as a tuple of
    ``None`` / ``"tp"``;
  * :func:`tp_split` is the same rule on a port ``state_dict`` name and
    its torch shape (a Linear ``weight`` is ``[out, in]``, the flax kernel
    transposed): which dim a leaf splits over tp. A fused ``qkv`` leaf
    splits each of its q, k and v thirds by heads (``blocks=3``), so rank r
    holds its heads of q, of k and of v; the TPU rule cuts the
    concatenated columns contiguously and GSPMD reshards the result, which
    explicit collectives cannot do. A dim that tp does not divide stays
    whole, as in the TPU ``ShardingRules``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.logging import logger

_EMBED_PAT = re.compile(r"(wte|embed|embedding)")
# the TPU package's column-parallel (output dim) and row-parallel (input
# dim) name patterns (deepspeed_tpu/runtime/sharding.py:33-34)
_COLUMN_PAT = re.compile(
    r"(qkv|up_proj|q_proj|k_proj|v_proj|lm_head|fc_in|wi|gate_proj)")
_ROW_PAT = re.compile(r"(out_proj|down_proj|o_proj|fc_out|wo)")
# KV-cache payload leaves; cursors, scales and tables stay replicated
_KV_PAYLOAD_PAT = re.compile(r"(cached_key|cached_value)")
# a fused q|k|v projection: split per head, a third at a time
_FUSED_QKV_PAT = re.compile(r"(^|[./])qkv([./]|$)")


def tp_spec(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The TPU package's tp PartitionSpec of the flax leaf ``path`` (its
    trailing dims; leading scan dims get None): embedding tables split their
    vocab dim, column kernels and biases their output dim, row kernels
    their input dim (a row bias is added after the reduce, whole)."""
    spec: list = [None] * ndim
    is_kernel = path.endswith("kernel") or path.endswith("embedding")
    is_bias = path.endswith("bias")
    if _EMBED_PAT.search(path) and is_kernel:
        spec[-2 if ndim >= 2 else -1] = "tp"
    elif _COLUMN_PAT.search(path):
        if (is_kernel and ndim >= 2) or is_bias:
            spec[-1] = "tp"
    elif _ROW_PAT.search(path):
        if is_kernel and ndim >= 2:
            spec[-2] = "tp"
    return tuple(spec)


def kv_spec(path: str, shape, tp: int, head_dim: Optional[int] = None
            ) -> Tuple[Optional[str], ...]:
    """The TPU package's tp PartitionSpec of one serving KV-cache leaf: the
    payload's flat ``[.., S, h*d]`` dim (or the heads of ``[.., S, h, d]``)
    when it divides, everything else replicated."""
    shape = tuple(shape)
    ndim = len(shape)
    spec: list = [None] * ndim
    if tp <= 1 or not _KV_PAYLOAD_PAT.search(path) or ndim < 2:
        return tuple(spec)
    last = shape[-1]
    if head_dim and last != head_dim and last % (tp * head_dim) == 0:
        spec[-1] = "tp"
    elif head_dim and last == head_dim and shape[-2] % tp == 0:
        spec[-2] = "tp"
    elif not head_dim and last % tp == 0:
        spec[-1] = "tp"
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class TpSplit:
    """How one leaf splits over ``parts`` tp ranks: along ``dim``, each of
    its ``blocks`` equal segments along that dim (3 for a fused q|k|v leaf,
    else 1) cut into ``parts`` contiguous pieces; rank r holds piece r of
    every segment, in segment order."""
    dim: int
    parts: int
    blocks: int = 1

    def take(self, full: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s shard of the whole leaf ``full`` (a view when
        ``blocks`` is 1, else a new tensor)."""
        n = full.shape[self.dim] // (self.blocks * self.parts)
        segs = full.split(full.shape[self.dim] // self.blocks, self.dim)
        pieces = [seg.narrow(self.dim, rank * n, n) for seg in segs]
        return pieces[0] if self.blocks == 1 else torch.cat(pieces, self.dim)

    def merge(self, shards) -> torch.Tensor:
        """The whole leaf from every rank's shard, in rank order."""
        split = [s.split(s.shape[self.dim] // self.blocks, self.dim)
                 for s in shards]
        return torch.cat([split[r][b] for b in range(self.blocks)
                          for r in range(self.parts)], self.dim)


# the Linear buffers of an int8 weight (ops/quantizer.Int8Linear): the codes
# split as the weight does, the per-output-column scales as the bias does
_LEAF_KIND = {"weight": "weight", "q8": "weight", "bias": "bias",
              "scale": "bias", "zmin": "bias"}


def tp_split(name: str, shape, tp: int) -> Optional[TpSplit]:
    """:func:`tp_spec`'s split of the port leaf ``name`` (a ``state_dict``
    name, torch layout) over ``tp`` ranks, or None when the leaf stays
    whole. Raises on a fused q|k|v leaf whose heads the caller has not
    checked: its output dim must divide into 3 * tp pieces."""
    shape = tuple(shape)
    if tp <= 1 or not shape:
        return None
    kind = _LEAF_KIND.get(name.rsplit(".", 1)[-1])
    if _EMBED_PAT.search(name) and kind == "weight" and len(shape) >= 2:
        dim = 0                                   # vocab
    elif _COLUMN_PAT.search(name) and kind is not None and (
            kind == "bias" or len(shape) >= 2):
        dim = 0                                   # output features
    elif _ROW_PAT.search(name) and kind == "weight" and len(shape) >= 2:
        dim = 1                                   # input features
    else:
        return None
    blocks = 3 if _FUSED_QKV_PAT.search(name) and dim == 0 else 1
    if shape[dim] % (blocks * tp):
        if blocks == 3:
            raise ValueError(f"{name} {shape}: a fused q|k|v leaf needs its "
                             f"output dim to divide into 3 x tp={tp} pieces")
        return None
    return TpSplit(dim, tp, blocks)


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
