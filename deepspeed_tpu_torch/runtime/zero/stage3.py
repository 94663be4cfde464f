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

A ``TiledLinear`` (``zero/tiling.py``) kernel is gathered a tile at a time
(:class:`TileGather`): its leaf stays an entry of its unit (the same flat
slices, masters, moments and checkpoint), but the unit's gather skips it.
The layer's forward gathers tile ``t`` (a broadcast from each rank whose
slice holds part of it: one tile's bytes), multiplies, and lets it go before
tile ``t + 1``; each tile is its own autograd node (:class:`_TileMatmul`),
whose backward gathers the tile again and reduce-scatters that tile's
gradient into the accumulator slices of the ranks that hold it.
"""

from __future__ import annotations

import collections
import weakref
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
                 counts: collections.Counter, tiled: Sequence[str] = ()):
        self.entries = list(entries)
        self.names = [name for _, name, _ in self.entries]
        self.pers = [spec.numel for _, _, spec in self.entries]
        self.shard = nn.Parameter(torch.empty(sum(self.pers), dtype=dtype,
                                              device=device))
        self.acc, self.comm_dtype, self.counts = acc, comm_dtype, counts
        # entries gathered a tile at a time (TileGather), not with the rest
        self.whole = [k for k, n in enumerate(self.names) if n not in tiled]

    def views(self) -> List[torch.Tensor]:
        """The shard's per-leaf slices (write the compute slices here)."""
        return list(self.shard.data.split(self.pers))

    @torch.no_grad()
    def gather(self) -> List[torch.Tensor]:
        views = self.views()
        fulls = all_gather_coalesced([views[k] for k in self.whole])
        self.counts["all_gather"] += sum(f.numel() * f.element_size()
                                         for f in fulls)
        return [self.entries[k][2].unpad(f)
                for k, f in zip(self.whole, fulls)]

    @torch.no_grad()
    def reduce(self, grads) -> None:
        entries = [self.entries[k] for k in self.whole]
        scatter_into(self.acc, [i for i, _, _ in entries], [
            g if g is not None else torch.zeros(spec.shape,
                                                device=self.shard.device)
            for g, (_, _, spec) in zip(grads, entries)],
            self.comm_dtype, self.counts)

    def gathered(self) -> Dict[str, torch.Tensor]:
        if not self.whole:
            return {}
        return dict(zip([self.names[k] for k in self.whole],
                        _GatherParams.apply(self.shard, self)))


class TileGather:
    """One ``TiledLinear`` kernel leaf of a unit (entry ``k``), gathered a
    tile at a time. Its flat slices are the leaf's usual ones (rank r holds
    elements ``[r * per, (r + 1) * per)``), so tile ``t`` (elements
    ``[t * T, (t + 1) * T)``) lies on one rank or spans a few: a gather
    broadcasts each piece from the rank that holds it, and a gradient goes
    back by one reduce-scatter whose row r is rank r's piece. ``gathers``
    and ``gather_bytes`` count the gathers and the bytes they assembled,
    ``live`` / ``max_live`` the gathered tiles alive at once."""

    def __init__(self, unit: GatherUnit, k: int, tiles: int):
        self.unit, self.k = unit, k
        self.leaf, _, self.spec = unit.entries[k]
        self.tiles = tiles
        self.tile_numel = self.spec.global_numel // tiles
        self.tile_shape = tuple(self.spec.shape[1:])
        self.gathers = self.gather_bytes = 0
        self.live = self.max_live = 0

    def pieces(self, t: int) -> List[Tuple[int, int, int]]:
        """``(rank, start, stop)``: the part of tile ``t`` in each rank's
        slice, as flat offsets into the tile."""
        per, T = self.spec.numel, self.tile_numel
        lo, hi = t * T, (t + 1) * T
        return [(r, max(lo, r * per) - lo, min(hi, (r + 1) * per) - lo)
                for r in range(lo // per, (hi - 1) // per + 1)]

    def _freed(self) -> None:
        self.live -= 1

    @torch.no_grad()
    def gather(self, t: int) -> torch.Tensor:
        """Tile ``t`` whole, ``[in/p, out/q]`` in the compute dtype."""
        mine = self.unit.views()[self.k]
        me, per = comm.get_rank(), self.spec.numel
        buf = torch.empty(self.tile_numel, dtype=mine.dtype,
                          device=mine.device)
        base = t * self.tile_numel
        for r, a, b in self.pieces(t):
            piece = buf[a:b]
            if r == me:
                piece.copy_(mine[base + a - r * per:base + b - r * per])
            comm.broadcast(piece, r)
        self.gathers += 1
        self.gather_bytes += buf.numel() * buf.element_size()
        self.live += 1
        self.max_live = max(self.max_live, self.live)
        self.unit.counts["all_gather"] += buf.numel() * buf.element_size()
        tile = buf.view(self.tile_shape)
        # the caller's tile, not ``buf``: gloo's worker thread may still
        # hold a finished broadcast's pieces of ``buf`` for a moment
        weakref.finalize(tile, self._freed)
        return tile

    @torch.no_grad()
    def reduce(self, t: int, grad: torch.Tensor) -> None:
        """Tile ``t``'s gradient (this rank's) summed over the ranks into
        the accumulator slices of the ranks that hold its pieces."""
        unit = self.unit
        dt = unit.comm_dtype or torch.float32
        flat = grad.reshape(-1).to(dt)
        pieces = self.pieces(t)
        width = max(b - a for _, a, b in pieces)
        world, me = comm.get_world_size(), comm.get_rank()
        rows = flat.new_zeros(world, width)
        for r, a, b in pieces:
            rows[r, :b - a] = flat[a:b]
        unit.counts["reduce_scatter"] += rows.numel() * rows.element_size()
        got = comm.reduce_scatter_base(rows)[0]
        per, base = self.spec.numel, t * self.tile_numel
        for r, a, b in pieces:
            if r == me:
                at = base + a - r * per
                unit.acc[self.leaf][at:at + b - a] += got[:b - a].float()


class _TileMatmul(torch.autograd.Function):
    """``x @ tile t`` with the tile gathered in the forward and again in the
    backward; only ``x`` is saved. ``shard`` (the unit's) makes the node
    run its backward even when ``x`` needs no grad."""

    @staticmethod
    def forward(ctx, x, shard, tiles: TileGather, t: int, dtype):
        ctx.tiles, ctx.t, ctx.dtype = tiles, t, dtype
        ctx.save_for_backward(x)
        return x @ tiles.gather(t).to(dtype)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        w = ctx.tiles.gather(ctx.t).to(ctx.dtype)
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        del w
        dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        ctx.tiles.reduce(ctx.t, dw)
        return dx, None, None, None, None


def tile_matmul(x: torch.Tensor, tiles: TileGather, t: int,
                dtype) -> torch.Tensor:
    """``x @ W_t`` for tile ``t`` of a ZeRO-3 ``TiledLinear`` kernel."""
    return _TileMatmul.apply(x, tiles.unit.shard, tiles, t, dtype)


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
        # TiledLinear kernels (gather_tiles) are gathered a tile at a time
        tiled = {f"{m}.kernel" if m else "kernel": mod
                 for m, mod in inner.named_modules()
                 if getattr(mod, "gather_tiles", False)}
        tiled = {n: mod for n, mod in tiled.items() if n in names}
        unit = make_unit(entries, tiled=list(tiled))
        with torch.no_grad():
            for view, (i, n, spec) in zip(unit.views(), entries):
                view.copy_(spec.take(params[n].detach()))
        for n in names:
            _pop_param(inner, n)
        for n, mod in tiled.items():
            mod.zero3_tiles = TileGather(unit, unit.names.index(n),
                                         mod.in_splits * mod.out_splits)
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
