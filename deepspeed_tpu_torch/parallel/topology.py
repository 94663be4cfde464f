"""Named-axis cartesian process topology.

The port's own copy of ``deepspeed_tpu/parallel/topology.py`` (reference
``deepspeed/runtime/pipe/topology.py``: ``ProcessTopology`` at
topology.py:12, ``PipeDataParallelTopology``:235,
``PipeModelDataParallelTopology``:246, ``PipelineParallelGrid``:252): a
cartesian grid of ranks addressed by named axis coordinates. Pure Python:
it answers "which global rank has coord (pipe=1, data=3)" and "which ranks
differ only along one axis"; the ``torch.distributed`` groups over the
device mesh's axes are built by ``parallel/mesh.py``.

Rank order is row-major over the axis order given at construction (the last
axis varies fastest), matching the reference's convention that adjacent data-
parallel ranks are adjacent global ranks when ``data`` is last.
"""

from __future__ import annotations

import itertools
from collections import namedtuple
from typing import Dict, List, Optional, Sequence


class ProcessTopology:
    """Maps n-dimensional named coordinates <-> flat global ranks."""

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        if len(axes) != len(dims):
            raise ValueError("axes and dims must have equal length")
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate axis names in {axes}")
        for d in dims:
            if d < 1:
                raise ValueError(f"all dims must be >= 1, got {dims}")
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)

        self._coord_to_rank: Dict[tuple, int] = {}
        self._rank_to_coord: List[tuple] = []
        for rank, coord in enumerate(itertools.product(*[range(d) for d in dims])):
            c = self.ProcessCoord(*coord)
            self._coord_to_rank[c] = rank
            self._rank_to_coord.append(c)

    def world_size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def get_rank(self, **coord_kwargs) -> int:
        if sorted(coord_kwargs.keys()) != sorted(self.axes):
            raise ValueError(
                f"get_rank() needs all axes {self.axes}, got {list(coord_kwargs)}")
        return self._coord_to_rank[self.ProcessCoord(**coord_kwargs)]

    def get_coord(self, rank: int):
        return self._rank_to_coord[rank]

    def get_axis_names(self) -> List[str]:
        return list(self.axes)

    def get_dim(self, axis: str) -> int:
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_rank_repr(self, rank: int, omit_axes=("data",), inner_sep="_", outer_sep="-") -> str:
        omit = set(omit_axes)
        coord = self.get_coord(rank)
        parts = [
            f"{axis}{inner_sep}{getattr(coord, axis):02d}"
            for axis in self.axes
            if axis not in omit
        ]
        return outer_sep.join(parts)

    def filter_match(self, **filter_kwargs) -> List[int]:
        """All ranks whose coordinates match every given axis=value filter."""
        for axis in filter_kwargs:
            if axis not in self.axes:
                raise ValueError(f"unknown axis {axis!r}; have {self.axes}")

        def matches(coord):
            return all(getattr(coord, a) == v for a, v in filter_kwargs.items())

        return [r for r, c in enumerate(self._rank_to_coord) if matches(c)]

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        """Ranks whose coordinate along `axis` equals `idx`."""
        return self.filter_match(**{axis: idx})

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Groups of ranks that differ only along `axis` (the comm groups for
        a collective over that axis)."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        for combo in itertools.product(*[range(self.get_dim(a)) for a in other_axes]):
            fixed = dict(zip(other_axes, combo))
            group = [
                self.get_rank(**{**fixed, axis: i})
                for i in range(self.get_dim(axis))
            ]
            lists.append(group)
        return lists

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class PipeDataParallelTopology(ProcessTopology):
    """2-d (pipe, data) grid; data-parallel ranks are adjacent (innermost)."""

    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """3-d (pipe, data, model) grid for 3D parallelism; model innermost so
    tensor-parallel partners share a host/ICI neighborhood."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """Rank bookkeeping for 3D (pipe x data x model) parallelism.

    Re-provides the reference ``PipelineParallelGrid`` query surface
    (stage/data/model ids, p2p neighbors, per-axis rank groups) as rank
    lists; the collectives' groups come from the device mesh
    (parallel/mesh.py).
    """

    def __init__(self, topology: Optional[ProcessTopology] = None,
                 process_group=None, world_size: Optional[int] = None,
                 global_rank: int = 0):
        if topology is None:
            if world_size is None:
                raise ValueError("need a topology or a world_size")
            # Default: pure data parallel.
            topology = PipeDataParallelTopology(num_pp=1, num_dp=world_size)
        self._topo = topology
        self.global_rank = global_rank

        self.data_parallel_size = max(topology.get_dim("data"), 1)
        self.pipe_parallel_size = max(topology.get_dim("pipe"), 1)
        self.model_parallel_size = max(topology.get_dim("model"), 1)
        self.slice_parallel_size = self.model_parallel_size
        self.world_size = topology.world_size()

        coord = topology.get_coord(global_rank)
        self.stage_id = getattr(coord, "pipe", 0)
        self.data_parallel_id = getattr(coord, "data", 0)
        self.model_parallel_id = getattr(coord, "model", 0) if "model" in topology.get_axis_names() else 0

        # Rank groups per axis (lists of global ranks).
        self.dp_groups = topology.get_axis_comm_lists("data")
        self.pp_groups = topology.get_axis_comm_lists("pipe")
        self.mp_groups = topology.get_axis_comm_lists("model") if "model" in topology.get_axis_names() else []

        # p2p: pairs of adjacent pipeline stages sharing all other coords.
        self.p2p_groups = self._build_p2p_groups()

    def _build_p2p_groups(self) -> List[List[int]]:
        if "pipe" not in self._topo.get_axis_names() or self.pipe_parallel_size < 2:
            return []
        pairs = []
        for group in self._topo.get_axis_comm_lists("pipe"):
            for i in range(len(group)):
                pairs.append(sorted([group[i], group[(i + 1) % len(group)]]))
        return pairs

    # ---- queries mirroring the reference surface -------------------------
    def get_stage_id(self) -> int:
        return self.stage_id

    def get_data_parallel_id(self) -> int:
        return self.data_parallel_id

    def get_model_parallel_id(self) -> int:
        return self.model_parallel_id

    def get_global_rank(self) -> int:
        return self.global_rank

    def get_data_parallel_world_size(self) -> int:
        return self.data_parallel_size

    def get_model_parallel_world_size(self) -> int:
        return self.model_parallel_size

    def get_pipe_parallel_world_size(self) -> int:
        return self.pipe_parallel_size

    def get_data_parallel_group_ranks(self) -> List[int]:
        return self._topo.filter_match(
            **{a: getattr(self._topo.get_coord(self.global_rank), a)
               for a in self._topo.get_axis_names() if a != "data"})

    def get_pipe_parallel_group_ranks(self) -> List[int]:
        return self._topo.filter_match(
            **{a: getattr(self._topo.get_coord(self.global_rank), a)
               for a in self._topo.get_axis_names() if a != "pipe"})

    def get_model_parallel_group_ranks(self) -> List[int]:
        if "model" not in self._topo.get_axis_names():
            return [self.global_rank]
        return self._topo.filter_match(
            **{a: getattr(self._topo.get_coord(self.global_rank), a)
               for a in self._topo.get_axis_names() if a != "model"})

    def stage_to_global(self, stage_id: int) -> int:
        """Global rank of `stage_id` holding my other coordinates."""
        coord = self._topo.get_coord(self.global_rank)
        kwargs = {a: getattr(coord, a) for a in self._topo.get_axis_names()}
        kwargs["pipe"] = stage_id
        return self._topo.get_rank(**kwargs)

    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    def is_last_stage(self) -> bool:
        return self.stage_id == self.pipe_parallel_size - 1

    @property
    def topology(self) -> ProcessTopology:
        return self._topo
