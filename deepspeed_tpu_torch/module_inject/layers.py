"""Tensor-parallel layers and their collectives.

The reference's ``LinearLayer`` / ``LinearAllreduce`` (which the TPU
package's ``module_inject/auto_tp.py`` cites) and a vocab- or
feature-parallel embedding. The TPU package needs none of this: a
PartitionSpec on each kernel is the replacement, and GSPMD inserts the
collectives. Here each rank is one process, so the collectives are written
out, as ``torch.autograd.Function``s over ``comm`` on the mesh's tp group
(a :class:`~deepspeed_tpu_torch.comm.comm.CommGroup`):

  * :func:`copy_to_tp`: identity forward, all-reduce backward, at a
    column-split layer's input (each rank's input grad is a partial sum);
  * :func:`reduce_from_tp`: all-reduce forward, identity backward, at a
    row-split layer's output;
  * :func:`gather_from_tp` / :func:`scatter_to_tp`: all-gather along a dim
    forward and this rank's slice backward, and the reverse (vocab-parallel
    logits; a feature-split embedding; partitioned activations along the
    sequence).

A tensor-parallel Linear is any Linear (``nn.Linear`` or an int8
``ops.quantizer.Int8Linear``) whose ``tp`` attribute is a :class:`TPInfo`:
:func:`tp_linear` runs it. A column-split one holds its rank's output
features (its bias too) and returns them; a row-split one holds its input
features, returns the reduced output and adds its bias once, after the
reduce (a sharded bias would be added tp times). :class:`LinearLayer` and
:class:`LinearAllreduce` are ``nn.Linear``s so tagged, with the same
``state_dict`` names. :class:`ParallelEmbedding` holds a vocab range (the
lookup masked to it and reduced) or a feature range (the lookup gathered).
With a one-rank group every collective is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..comm import comm


@dataclasses.dataclass(frozen=True)
class TPInfo:
    """A layer's tensor-parallel role: ``kind`` "column" or "row" (a
    Linear), "vocab" or "feature" (an embedding), over ``group``."""
    kind: str
    group: comm.CommGroup

    def __deepcopy__(self, memo):
        return self


def tp_size(group: Optional[comm.CommGroup]) -> int:
    return 1 if group is None else group.size


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g.contiguous().clone(), group=ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    parts = comm.all_gather(x.contiguous(), group=group)       # [G, ...]
    return torch.cat(list(parts.unbind(0)), dim)


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's piece of ``x`` along ``dim``."""
    return x.chunk(group.size, dim)[group.rank].contiguous()


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


class _ScatterToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if tp_size(group) == 1 else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if tp_size(group) == 1 else _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' pieces of ``x`` concatenated along ``dim``; the backward
    keeps this rank's piece of the grad (the grad is the same on every
    rank: the gathered tensor is)."""
    if tp_size(group) == 1:
        return x
    return _GatherFromTP.apply(x, group, dim % x.dim())


def scatter_to_tp(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's piece of ``x`` (the same on every rank) along ``dim``;
    the backward gathers the pieces' grads."""
    if tp_size(group) == 1:
        return x
    return _ScatterToTP.apply(x, group, dim % x.dim())


def tp_linear(x: torch.Tensor, layer: nn.Module, dtype) -> torch.Tensor:
    """``layer`` (a Linear with a :class:`TPInfo` ``tp``) on ``x`` in the
    compute ``dtype``, as ``models.gpt.linear`` computes a whole Linear:
    a column layer's input is copied into the tp region (its output is this
    rank's features); a row layer's partial product is reduced, then its
    bias added once."""
    info: TPInfo = layer.tp
    w = layer.weight.to(dtype)
    b = None if layer.bias is None else layer.bias.to(dtype)
    if info.kind == "column":
        return F.linear(copy_to_tp(x.to(dtype), info.group), w, b)
    if info.kind != "row":
        raise ValueError(f"tp_linear of a {info.kind!r} layer")
    out = reduce_from_tp(F.linear(x.to(dtype), w), info.group)
    return out if b is None else out + b


def tp_partial(x: torch.Tensor, layer: nn.Module, dtype) -> torch.Tensor:
    """A row-split ``layer``'s partial product on ``x``, before the reduce
    and without the bias (the tp overlap reduces it itself)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


def embedding(ids: torch.Tensor, table, dtype) -> torch.Tensor:
    """Rows ``ids`` of ``table`` (a tensor, or an ``nn.Embedding`` that may
    be a :class:`ParallelEmbedding`) in ``dtype``."""
    if isinstance(table, torch.Tensor):
        return F.embedding(ids, table.to(dtype))
    info: Optional[TPInfo] = getattr(table, "tp", None)
    if info is None:
        return F.embedding(ids, table.weight.to(dtype))
    w = table.weight.to(dtype)
    if info.kind == "feature":
        return gather_from_tp(F.embedding(ids, w), info.group, -1)
    lo = table.vocab_start
    local = ids - lo
    inside = (local >= 0) & (local < w.shape[0])
    rows = F.embedding(torch.where(inside, local, 0), w)
    rows = rows * inside[..., None].to(dtype)
    return reduce_from_tp(rows, info.group)


def _new_linear(cls, shard_w, shard_b):
    layer = cls.__new__(cls)
    nn.Module.__init__(layer)
    layer.in_features, layer.out_features = shard_w.shape[1], shard_w.shape[0]
    layer.weight = nn.Parameter(shard_w, requires_grad=shard_w.is_floating_point())
    layer.bias = None if shard_b is None else nn.Parameter(shard_b)
    return layer


class LinearLayer(nn.Linear):
    """A column-split ``nn.Linear``: this rank's output features (and
    their bias). ``forward`` is :func:`tp_linear` in the input's dtype."""

    @classmethod
    def from_shards(cls, weight, bias, group) -> "LinearLayer":
        layer = _new_linear(cls, weight, bias)
        layer.tp = TPInfo("column", group)
        return layer

    def forward(self, x):
        return tp_linear(x, self, x.dtype)


class LinearAllreduce(nn.Linear):
    """A row-split ``nn.Linear``: this rank's input features; the whole
    bias, added after the reduce."""

    @classmethod
    def from_shards(cls, weight, bias, group) -> "LinearAllreduce":
        layer = _new_linear(cls, weight, bias)
        layer.tp = TPInfo("row", group)
        return layer

    def forward(self, x):
        return tp_linear(x, self, x.dtype)


class ParallelEmbedding(nn.Embedding):
    """An ``nn.Embedding`` split over tp: ``kind`` "vocab" holds rows
    ``[vocab_start, vocab_start + n)`` (the lookup is masked to them and
    reduced; a tied head reads the same rows as vocab-parallel logits);
    "feature" holds a range of the columns (the lookup is gathered)."""

    @classmethod
    def from_shard(cls, weight, kind: str, group,
                   vocab_start: int = 0) -> "ParallelEmbedding":
        emb = cls.__new__(cls)
        nn.Module.__init__(emb)
        emb.num_embeddings, emb.embedding_dim = weight.shape
        emb.padding_idx = None
        emb.max_norm = None
        emb.norm_type = 2.0
        emb.scale_grad_by_freq = False
        emb.sparse = False
        emb.weight = nn.Parameter(weight)
        emb.tp = TPInfo(kind, group)
        emb.vocab_start = int(vocab_start)
        return emb

    def forward(self, ids):
        return embedding(ids, self, self.weight.dtype)


# ---------------------------------------------------------------------------
# Splitting whole layers into this rank's shards
# ---------------------------------------------------------------------------

def _set_submodule(root: nn.Module, name: str, child: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, leaf, child)


def _shard(t: Optional[torch.Tensor], split, rank: int):
    """This rank's piece of ``t`` as its own storage (so the whole tensor
    can be freed), or ``t`` when ``split`` is None."""
    if t is None or split is None:
        return t
    return split.take(t.detach(), rank).clone()


def shard_linear(layer: nn.Module, kind: str, group, blocks: int = 1
                 ) -> nn.Module:
    """This rank's shard of a whole Linear: ``kind`` "column" (output
    features, in ``blocks`` segments each split alike: 3 for a fused
    q|k|v) or "row" (input features). An ``nn.Linear`` becomes a
    :class:`LinearLayer` / :class:`LinearAllreduce`; an int8 ``Int8Linear``
    keeps its class, its codes split as the weight, its per-column scales
    (the whole column's: quantized before the split) as the bias, and is
    tagged with :class:`TPInfo`."""
    from ..runtime.sharding import TpSplit
    n, r = group.size, group.rank
    w_split = TpSplit(0 if kind == "column" else 1, n, blocks)
    v_split = TpSplit(0, n, blocks) if kind == "column" else None
    if isinstance(layer, nn.Linear):
        cls = LinearLayer if kind == "column" else LinearAllreduce
        return cls.from_shards(_shard(layer.weight, w_split, r),
                               _shard(layer.bias, v_split, r), group)
    if not hasattr(layer, "q8"):
        raise TypeError(f"cannot split a {type(layer).__name__} over tp")
    layer.q8 = _shard(layer.q8, w_split, r)
    for name in ("scale", "zmin"):
        if getattr(layer, name) is not None:
            setattr(layer, name, _shard(getattr(layer, name), v_split, r))
    if layer.bias is not None and v_split is not None:
        layer.bias = nn.Parameter(_shard(layer.bias, v_split, r),
                                  requires_grad=False)
    layer.out_features, layer.in_features = layer.q8.shape
    layer.tp = TPInfo(kind, group)
    return layer


def shard_embedding(emb: nn.Embedding, kind: str, group
                    ) -> ParallelEmbedding:
    """This rank's rows ("vocab") or columns ("feature") of a whole
    ``nn.Embedding``."""
    from ..runtime.sharding import TpSplit
    dim = 0 if kind == "vocab" else 1
    w = _shard(emb.weight, TpSplit(dim, group.size), group.rank)
    start = group.rank * w.shape[0] if kind == "vocab" else 0
    return ParallelEmbedding.from_shard(w, kind, group, start)


def tp_kind(name: str, module: nn.Module, tp: int):
    """(kind, blocks) of the whole module ``name`` under the TPU package's
    ``tp_spec`` (``runtime.sharding.tp_split`` of its weight), or None
    when it stays whole."""
    from ..runtime.sharding import tp_split
    weight = getattr(module, "q8", None)
    if weight is None:
        weight = getattr(module, "weight", None)
    if weight is None or not isinstance(weight, torch.Tensor):
        return None
    split = tp_split(f"{name}.weight", weight.shape, tp)
    if split is None:
        return None
    if isinstance(module, nn.Embedding):
        return ("vocab" if split.dim == 0 else "feature"), 1
    return ("column" if split.dim == 0 else "row"), split.blocks


def shard_module_(root: nn.Module, name: str, module: nn.Module, group
                  ) -> Optional[nn.Module]:
    """Replace the whole submodule ``name`` of ``root`` by its shard under
    ``tp_spec``; returns the shard (None when it stays whole)."""
    kind = tp_kind(name, module, group.size)
    if kind is None:
        return None
    if isinstance(module, nn.Embedding):
        new = shard_embedding(module, kind[0], group)
    else:
        new = shard_linear(module, kind[0], group, kind[1])
    if new is not module:
        _set_submodule(root, name, new)
    return new


def shard_by_tp_spec(model: nn.Module, group) -> nn.Module:
    """Split every Linear and embedding of the whole ``model`` into this
    rank's shard by the ``tp_spec`` name rules, in place; returns it."""
    for name in [n for n, _ in model.named_modules()]:
        module = model.get_submodule(name)
        if isinstance(module, (nn.Linear, nn.Embedding)) or \
                hasattr(module, "q8"):
            if getattr(module, "tp", None) is None:
                shard_module_(model, name, module, group)
    return model
