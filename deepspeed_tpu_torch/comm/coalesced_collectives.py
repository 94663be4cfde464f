"""Coalesced collectives: one exchange for many unevenly sized tensors.

Counterpart of ``deepspeed_tpu/comm/coalesced_collectives.py`` (reference
``runtime/comm/coalesced_collectives.py:26-99``): every tensor is
flattened and zero-padded to a multiple of the group size, the pieces go
into one flat buffer, and one collective moves it. Each call takes this
rank's tensors (the TPU package's take them stacked over the group).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from . import comm as dist


def reduce_scatter_coalesced(tensors: Sequence[torch.Tensor], group=None,
                             op: str = "sum", dtype=torch.float32
                             ) -> List[torch.Tensor]:
    """This rank's tensors (mixed shapes) -> its reduced slices: out[i] is
    slice ``rank`` (``ceil(numel_i / G)`` elements) of the sum over ranks
    of tensor i, flattened and zero-padded. One reduce-scatter, on the
    wire (and in the result) in ``dtype``.

    The wire buffer is rank-major, [rank 0's slices of every tensor | rank
    1's | ...], so the reduce-scatter hands each rank its partition."""
    world = dist.get_world_size(group)
    numels = [t.numel() for t in tensors]
    pers = [-(-n // world) for n in numels]
    parts = [torch.nn.functional.pad(t.reshape(-1).to(dtype),
                                     (0, per * world - n)).view(world, per)
             for t, n, per in zip(tensors, numels, pers)]
    wire = torch.cat(parts, dim=1).reshape(-1)
    out = dist.reduce_scatter_base(wire, op=op, group=group)
    return list(out.split(pers))


def all_gather_coalesced(tensors: Sequence[torch.Tensor], group=None
                         ) -> List[torch.Tensor]:
    """This rank's flat slices ``[n_i]`` -> the full ``[G * n_i]``
    tensors, rank-major. One all-gather."""
    world = dist.get_world_size(group)
    widths = [t.numel() for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    gathered = dist.all_gather_base(flat, group=group).view(world, -1)
    return [g.reshape(-1) for g in gathered.split(widths, dim=1)]
