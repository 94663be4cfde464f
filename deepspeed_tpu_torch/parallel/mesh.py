"""The device mesh over ``torch.distributed`` ranks.

Counterpart of ``deepspeed_tpu/parallel/mesh.py``. The TPU package lays
its devices out as one ``jax.sharding.Mesh`` with named axes; here each
process is one rank (one device), and the mesh lays the world's ranks out
the same way: rank ``r`` has the coordinate device ``r`` has in the TPU
mesh, row-major over :data:`MESH_AXES` with ``dp`` outermost and ``tp``
innermost (tensor-parallel partners are consecutive ranks):

  - ``dp``  : data parallelism; ZeRO partitions over it and the batch is
    sharded over it;
  - ``pp``  : pipeline stages;
  - ``ep``  : expert parallelism; each rank holds its ``ep`` coordinate's
    share of every expert bank;
  - ``sp``  : sequence parallelism;
  - ``tp``  : tensor parallelism.

:func:`build_mesh` makes one ``torch.distributed`` group for every slice
of every set of axes whose members are more than one rank and fewer than
the world (every rank takes part in making each group, in one order); a
group spanning the world is the default group and a one-rank group needs
none, so the mesh of a pure-dp world makes no group at all. Axes of size 1
stay in the mesh, so a group is always named the same way.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

# Canonical axis order: outermost (slowest) to innermost (fastest).
MESH_AXES = ("dp", "pp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    dp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def total(self) -> int:
        return self.dp * self.pp * self.ep * self.sp * self.tp

    def as_dict(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in MESH_AXES}

    @staticmethod
    def infer(n_devices: int, tp: int = 1, pp: int = 1, ep: int = 1,
              sp: int = 1, dp: Optional[int] = None) -> "MeshShape":
        """Fill in dp so the mesh covers all devices."""
        denom = tp * pp * ep * sp
        if dp is None:
            if n_devices % denom != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by tp*pp*ep*sp="
                    f"{denom}")
            dp = n_devices // denom
        shape = MeshShape(dp=dp, pp=pp, ep=ep, sp=sp, tp=tp)
        if shape.total() != n_devices:
            raise ValueError(
                f"mesh {shape.as_dict()} covers {shape.total()} devices, "
                f"have {n_devices}")
        return shape


def _world() -> Tuple[int, int]:
    """(rank, world) of this process: (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DeviceMesh:
    """The world's ranks over :data:`MESH_AXES`. ``devices`` is the rank
    array of shape ``[dp, pp, ep, sp, tp]`` (the TPU mesh's ``devices``
    with device ids read as ranks) and ``shape`` maps each axis to its
    size, as ``jax.sharding.Mesh.shape`` does."""

    axis_names = MESH_AXES

    def __init__(self, mesh_shape: MeshShape, rank: int,
                 groups: Dict[Tuple[int, ...], object]):
        self.mesh_shape = mesh_shape
        self.shape = mesh_shape.as_dict()
        self.devices = np.arange(mesh_shape.total()).reshape(
            [self.shape[a] for a in MESH_AXES])
        self.rank = rank
        self._groups = groups

    @property
    def size(self) -> int:
        return self.mesh_shape.total()

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``rank``'s (default: this process's) coordinate on every axis."""
        idx = np.unravel_index(self.rank if rank is None else rank,
                               self.devices.shape)
        return {a: int(i) for a, i in zip(MESH_AXES, idx)}

    def coord(self, axis: str, rank: Optional[int] = None) -> int:
        return self.coords(rank)[axis]

    def _check(self, axes: Sequence[str]) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"unknown mesh axis {a!r}; mesh axes are "
                                 f"{list(MESH_AXES)}")
        return axes

    def group_ranks(self, axes: Sequence[str],
                    rank: Optional[int] = None) -> List[int]:
        """The ranks that share ``rank``'s coordinates off ``axes``, in
        rank order (their position is their coordinate over ``axes``,
        row-major)."""
        axes = self._check(axes)
        c = self.coords(rank)
        index = tuple(slice(None) if a in axes else c[a] for a in MESH_AXES)
        return sorted(int(r) for r in np.ravel(self.devices[index]))

    def process_group(self, axes: Sequence[str]):
        """This rank's ``torch.distributed`` group over ``axes``: None for
        the world (the default group) and for a one-rank group."""
        return self._groups.get(tuple(self.group_ranks(axes)))

    def __repr__(self):
        return f"DeviceMesh({self.shape}, rank={self.rank})"


def _slices(shape: Dict[str, int], axes: Sequence[str]) -> List[List[int]]:
    """Every slice of the rank array over ``axes``: the rank lists of the
    groups that vary along ``axes`` only, in a fixed order."""
    devices = np.arange(math.prod(shape.values())).reshape(
        [shape[a] for a in MESH_AXES])
    other = [a for a in MESH_AXES if a not in axes]
    out = []
    for combo in itertools.product(*[range(shape[a]) for a in other]):
        fixed = dict(zip(other, combo))
        index = tuple(slice(None) if a in axes else fixed[a]
                      for a in MESH_AXES)
        out.append(sorted(int(r) for r in np.ravel(devices[index])))
    return out


def build_mesh(shape: MeshShape, devices: Optional[Sequence] = None
               ) -> DeviceMesh:
    """The mesh of ``shape`` over the world's ranks (``devices``, if given,
    must be ``range(world)``: a rank is its device). Every rank of the
    world must call it, with the same shape: it makes the groups."""
    rank, world = _world()
    if devices is not None and list(devices) != list(range(world)):
        raise ValueError("the port's mesh spans the world's ranks in rank "
                         "order; pass devices=None")
    if shape.total() != world:
        raise ValueError(f"mesh needs {shape.total()} devices, got {world}")
    sizes = shape.as_dict()
    live = [a for a in MESH_AXES if sizes[a] > 1]
    groups: Dict[Tuple[int, ...], object] = {}
    # each proper non-empty subset of the axes longer than 1 (a subset with
    # size-1 axes has the same members as one without them)
    for n in range(1, len(live)):
        for axes in itertools.combinations(live, n):
            for ranks in _slices(sizes, axes):
                pg = dist.new_group(ranks)
                if rank in ranks:
                    groups[tuple(ranks)] = pg
    return DeviceMesh(shape, rank, groups)


_GLOBAL_MESH: Optional[DeviceMesh] = None
_GLOBAL_SHAPE: Optional[MeshShape] = None


def set_global_mesh(mesh: DeviceMesh, shape: MeshShape) -> None:
    global _GLOBAL_MESH, _GLOBAL_SHAPE
    _GLOBAL_MESH = mesh
    _GLOBAL_SHAPE = shape


def get_global_mesh() -> DeviceMesh:
    """The process-global mesh; without one (or when the world it was built
    over has changed), the pure-dp mesh over the world, which makes no
    group."""
    rank, world = _world()
    if _GLOBAL_MESH is None or (_GLOBAL_MESH.rank, _GLOBAL_MESH.size) \
            != (rank, world):
        shape = MeshShape.infer(world)
        set_global_mesh(build_mesh(shape), shape)
    return _GLOBAL_MESH


def get_global_mesh_shape() -> MeshShape:
    get_global_mesh()
    return _GLOBAL_SHAPE


def reset_global_mesh() -> None:
    global _GLOBAL_MESH, _GLOBAL_SHAPE
    _GLOBAL_MESH = None
    _GLOBAL_SHAPE = None


def ensure_global_mesh(shape: MeshShape) -> DeviceMesh:
    """The global mesh of ``shape``, built (by every rank) unless it is the
    one already set."""
    rank, world = _world()
    cur = _GLOBAL_MESH
    if cur is not None and cur.mesh_shape == shape and \
            (cur.rank, cur.size) == (rank, world):
        return cur
    mesh = build_mesh(shape)
    set_global_mesh(mesh, shape)
    return mesh


def axis_size(axis: str, mesh: Optional[DeviceMesh] = None) -> int:
    mesh = mesh or get_global_mesh()
    return mesh.shape[axis]
