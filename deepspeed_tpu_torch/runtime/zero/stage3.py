"""ZeRO stage 3 over data parallelism, in eager PyTorch.

The TPU package gets stage 3 from shardings: each partitioned parameter
carries a dp sharding and XLA inserts the all-gathers and the gradient
reduce-scatters where the compiled program uses them. Eagerly, the engine
does it itself, one *unit* at a time:

  * each block of the module's ``blocks`` list is one unit, the other
    partitioned parameters (embeddings, final norm) one more: the root;
  * a unit holds this rank's flat slices of its partitioned parameters,
    concatenated, as one ``shard`` parameter in the compute dtype; the
    parameters themselves are taken out of the module (left as None);
  * :class:`GatheredModule` runs the unit's module through
    ``torch.func.functional_call`` with the gathered parameters swapped in.
    The gather is :class:`_GatherParams`, an autograd function whose forward
    all-gathers the shard (one collective) and whose backward
    reduce-scatters the parameters' gradients (one collective, in the
    communication dtype) straight into this rank's slice of the fp32
    accumulator.

The port's blocks run under ``torch.utils.checkpoint`` (``cfg.remat``), and
the gather sits inside the checkpointed function: the forward frees the
gathered weights with the block (autograd keeps only the block's input),
the backward's recompute gathers them again, and the gradient arrives
already scattered. Without remat the matmuls' saved tensors keep the
gathered weights until the backward reaches them. The root unit's
parameters are gathered once a micro-step, for the whole forward (the tied
embedding is read at both ends of the model).
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...comm import comm
from ...comm.coalesced_collectives import (all_gather_coalesced,
                                           reduce_scatter_coalesced)
from ..sharding import LeafShard


def scatter_into(acc: List[torch.Tensor], leaves: Sequence[int],
                 grads: Sequence[torch.Tensor],
                 comm_dtype: Optional[torch.dtype],
                 counts: collections.Counter, group=None) -> None:
    """Sum ``grads`` (whole leaves) over the ranks of ``group`` (default:
    the world) in one reduce-scatter in ``comm_dtype`` (None: f32) and add
    this rank's slice of leaf ``leaves[k]`` into ``acc[leaves[k]]``,
    widened to f32; the wire's bytes go to ``counts["reduce_scatter"]``."""
    dt = comm_dtype or torch.float32
    world = comm.get_world_size(group)
    counts["reduce_scatter"] += sum(
        -(-g.numel() // world) * world for g in grads) * \
        torch.empty(0, dtype=dt).element_size()
    mine = reduce_scatter_coalesced(grads, group=group, dtype=dt)
    torch._foreach_add_([acc[i] for i in leaves], [r.float() for r in mine])


class _GatherParams(torch.autograd.Function):
    """shard -> the unit's whole parameters; their grads -> reduce-scattered
    into the accumulator (the shard itself gets no ``.grad``)."""

    @staticmethod
    def forward(ctx, shard, unit):
        ctx.unit = unit
        ctx.set_materialize_grads(False)
        return tuple(unit.gather())

    @staticmethod
    def backward(ctx, *grads):
        ctx.unit.reduce(grads)
        return None, None


class GatherUnit:
    """This rank's slices of one unit's partitioned parameters.

    ``entries``: ``(leaf index, name inside the unit's module, LeafShard)``.
    ``acc``: the engine's accumulator list (leaf i's flat fp32 slice at
    ``acc[i]``); ``comm_dtype``: the wire dtype of the gradient
    reduce-scatter (None: f32); ``counts``: a Counter the collectives' bytes
    are added to (``all_gather`` = gathered output, ``reduce_scatter`` =
    scattered input)."""

    def __init__(self, entries: Sequence[Tuple[int, str, LeafShard]], *,
                 dtype: torch.dtype, device, acc: List[torch.Tensor],
                 comm_dtype: Optional[torch.dtype],
                 counts: collections.Counter):
        self.entries = list(entries)
        self.names = [name for _, name, _ in self.entries]
        self.pers = [spec.numel for _, _, spec in self.entries]
        self.shard = nn.Parameter(torch.empty(sum(self.pers), dtype=dtype,
                                              device=device))
        self.acc, self.comm_dtype, self.counts = acc, comm_dtype, counts

    def views(self) -> List[torch.Tensor]:
        """The shard's per-leaf slices (write the compute slices here)."""
        return list(self.shard.data.split(self.pers))

    @torch.no_grad()
    def gather(self) -> List[torch.Tensor]:
        fulls = all_gather_coalesced(self.views())
        self.counts["all_gather"] += sum(f.numel() * f.element_size()
                                         for f in fulls)
        return [spec.unpad(f) for f, (_, _, spec) in zip(fulls, self.entries)]

    @torch.no_grad()
    def reduce(self, grads) -> None:
        scatter_into(self.acc, [i for i, _, _ in self.entries], [
            g if g is not None else torch.zeros(spec.shape,
                                                device=self.shard.device)
            for g, (_, _, spec) in zip(grads, self.entries)],
            self.comm_dtype, self.counts)

    def gathered(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, _GatherParams.apply(self.shard, self)))


class GatheredModule(nn.Module):
    """``inner`` run with its unit's gathered parameters swapped in."""

    def __init__(self, inner: nn.Module, unit: GatherUnit):
        super().__init__()
        self.inner = inner
        self.shard = unit.shard
        self.unit = unit

    def forward(self, *args, **kwargs):
        return torch.func.functional_call(self.inner, self.unit.gathered(),
                                          args, kwargs)


def _pop_param(module: nn.Module, name: str) -> None:
    owner, _, attr = name.rpartition(".")
    target = module.get_submodule(owner) if owner else module
    target._parameters[attr] = None


def partition_module(module: nn.Module, leaf_of: Dict[str, int],
                     specs: Sequence[LeafShard],
                     make_unit: Callable[[list], GatherUnit]
                     ) -> Tuple[nn.Module, List[GatherUnit]]:
    """Take ``module``'s partitioned parameters (``specs[leaf_of[name]]``
    split over ranks) out into gather units: one per block of
    ``module.blocks``, one for the rest. Each unit's shard is loaded with
    this rank's slices of the current values. Returns the module to call
    (wrapped when a root unit exists) and the units."""
    units = []

    def build(inner: nn.Module, prefix: str, names: List[str]):
        params = dict(inner.named_parameters())
        entries = [(leaf_of[prefix + n], n, specs[leaf_of[prefix + n]])
                   for n in names]
        unit = make_unit(entries)
        with torch.no_grad():
            for view, (i, n, spec) in zip(unit.views(), entries):
                view.copy_(spec.take(params[n].detach()))
        for n in names:
            _pop_param(inner, n)
        units.append(unit)
        return GatheredModule(inner, unit)

    split = {n for n, i in leaf_of.items() if specs[i].partitioned}
    blocks = getattr(module, "blocks", None)
    if isinstance(blocks, nn.ModuleList):
        for b, blk in enumerate(blocks):
            pre = f"blocks.{b}."
            names = [n for n, _ in blk.named_parameters()
                     if pre + n in split]
            if names:
                blocks[b] = build(blk, pre, names)
                split -= {pre + n for n in names}
    root = [n for n, _ in module.named_parameters() if n in split]
    return (build(module, "", root) if root else module), units
