"""Communication façade over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/comm.py`` (reference
``deepspeed/comm/comm.py``: ``init_distributed``, ``all_reduce``,
``all_gather_base``, ``reduce_scatter_base``, ``all_to_all_single``,
``broadcast``, ``barrier``, ``new_group``), with the same names.

The TPU package runs every rank in one process, so its collectives take
arrays stacked over the group (``[G, ...]``). Here each process is one rank
and every collective takes that rank's own tensor, as the reference and
``torch.distributed`` do; stacking the ranks' results gives the TPU
package's result. Before ``init_distributed`` (or with a one-rank world)
every collective is the identity on the caller's tensor.

Groups follow the device mesh (``parallel/mesh.py``): ``new_group(axes)``
is the group of the ranks that share this rank's coordinates off
``axes``, and a collective takes a group's ranks (``src``, ``perm``) in
the group's own numbering. Without a mesh set, the mesh is the pure-dp
one: ``dp`` spans the world and every other axis is this rank alone.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..parallel import mesh as mesh_lib
from ..utils.device import resolve_device
from ..utils.logging import logger

_INITIALIZED = False

ReduceOp = type("ReduceOp", (), {"SUM": "sum", "AVG": "avg", "MAX": "max",
                                 "MIN": "min", "PROD": "prod"})

_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


@dataclasses.dataclass(frozen=True)
class CommGroup:
    """A collective group: the mesh axes its members span, the
    ``torch.distributed`` group (None: the default world group, or no
    group when the members are this rank alone) and the members' global
    ranks in group order (None: the world)."""
    axes: tuple
    group: Optional[object] = None
    ranks: Optional[tuple] = None

    @property
    def size(self) -> int:
        return len(self.ranks) if self.ranks is not None else _world()

    def global_rank(self, group_rank: int) -> int:
        return (self.ranks[group_rank] if self.ranks is not None
                else group_rank)

    @property
    def rank(self) -> int:
        """This process's rank in the group."""
        me = get_rank()
        return self.ranks.index(me) if self.ranks is not None else me

    def __deepcopy__(self, memo):
        # a handle on a process group: copies of a module share it
        return self


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world(group=None) -> int:
    return dist.get_world_size(group) if _active() else 1


def _discover(auto_mpi_discovery: bool):
    """(coordinator "host:port" or None, world, rank) from the launcher's
    environment: COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, else
    mpirun's OMPI_* or mpirun_rsh's MV2_* identity with MASTER_ADDR /
    MASTER_PORT (the TPU package's contract, comm.py:65-115)."""
    coord = os.environ.get("COORDINATOR_ADDRESS")
    nproc = int(os.environ.get("NUM_PROCESSES", "1"))
    pid = int(os.environ.get("PROCESS_ID", "0"))
    for prefix in ("OMPI", "MV2"):
        if auto_mpi_discovery and not coord \
                and f"{prefix}_COMM_WORLD_SIZE" in os.environ:
            nproc = int(os.environ[f"{prefix}_COMM_WORLD_SIZE"])
            pid = int(os.environ[f"{prefix}_COMM_WORLD_RANK"])
            coord = os.environ.get("MASTER_ADDR", "127.0.0.1") + ":" + \
                os.environ.get("MASTER_PORT", "29500")
            os.environ.setdefault(
                "LOCAL_RANK",
                os.environ.get(f"{prefix}_COMM_WORLD_LOCAL_RANK", "0"))
            break
    return coord, nproc, pid


def init_distributed(dist_backend: str = "xla",
                     auto_mpi_discovery: bool = True,
                     init_method: Optional[str] = None,
                     rank: int = -1,
                     world_size: int = -1,
                     mesh_shape=None,
                     device="cuda") -> None:
    """Join the process group (or take the one already set up).

    Identity comes from ``rank`` / ``world_size`` when given, else from the
    launcher's environment (:func:`_discover`); ``init_method`` defaults to
    ``tcp://<COORDINATOR_ADDRESS>``. ``dist_backend`` names a
    ``torch.distributed`` backend; the TPU default ``"xla"`` means
    ``"nccl"`` when ``device`` is the card and ``"gloo"`` on the CPU. A
    one-rank world without an ``init_method`` starts no group.
    ``mesh_shape`` (a ``parallel.mesh.MeshShape`` over the world) makes the
    global mesh and its groups; every rank must pass the same one."""
    global _INITIALIZED
    if _active() or _INITIALIZED:
        _INITIALIZED = True
        if mesh_shape is not None:
            mesh_lib.ensure_global_mesh(mesh_shape)
        return
    coord, nproc, pid = _discover(auto_mpi_discovery)
    nproc = world_size if world_size > 0 else nproc
    pid = rank if rank >= 0 else pid
    dev = resolve_device(device)
    backend = dist_backend
    if backend == "xla":
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if init_method is None and coord and nproc > 1:
        init_method = f"tcp://{coord}"
    if init_method is not None:
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method,
                                world_size=nproc, rank=pid)
        logger.info(f"torch.distributed initialized ({backend}): rank "
                    f"{pid}/{nproc}")
    _INITIALIZED = True
    if mesh_shape is not None:
        mesh_lib.ensure_global_mesh(mesh_shape)


def is_initialized() -> bool:
    return _INITIALIZED or _active()


def get_rank() -> int:
    return dist.get_rank() if _active() else 0


def get_world_size(group: Optional[CommGroup] = None) -> int:
    """Ranks in ``group`` (default: the world; one rank per device)."""
    return _world() if group is None else group.size


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def device_count() -> int:
    """Devices in the job: one per rank, as the TPU package counts them."""
    return _world()


def barrier() -> None:
    if _world() > 1:
        dist.barrier()


def new_group(axes: Sequence[str] | str, mesh=None) -> CommGroup:
    """The group named by the mesh axes its members span: the ranks that
    share this rank's coordinates on every other axis of ``mesh`` (default:
    the global mesh)."""
    if isinstance(axes, str):
        axes = (axes,)
    for a in axes:
        if a not in mesh_lib.MESH_AXES:
            raise ValueError(f"unknown mesh axis {a!r}; mesh axes are "
                             f"{list(mesh_lib.MESH_AXES)}")
    mesh = mesh or mesh_lib.get_global_mesh()
    ranks = mesh.group_ranks(axes)
    if len(ranks) == _world():
        return CommGroup(axes=tuple(axes))
    return CommGroup(axes=tuple(axes), group=mesh.process_group(axes),
                     ranks=tuple(ranks))


def get_data_parallel_group() -> CommGroup:
    return new_group("dp")


def get_model_parallel_group() -> CommGroup:
    return new_group("tp")


def get_expert_parallel_group() -> CommGroup:
    return new_group("ep")


# ---------------------------------------------------------------------------
# Collectives on this rank's tensor.
# ---------------------------------------------------------------------------

def _pg(group: Optional[CommGroup]):
    return None if group is None else group.group


def _size(group: Optional[CommGroup]) -> int:
    return _world() if group is None else group.size


def _global(group: Optional[CommGroup], r: int) -> int:
    return r if group is None else group.global_rank(r)


def all_reduce(x: torch.Tensor, op: str = "sum",
               group: Optional[CommGroup] = None) -> torch.Tensor:
    """Reduce ``x`` over the group in place; returns ``x``."""
    if op not in ("sum", "avg", "max", "min", "prod"):
        raise ValueError(f"unsupported reduce op {op}")
    n = _size(group)
    if n == 1:
        return x
    dist.all_reduce(x, op=_TORCH_OPS[op if op != "avg" else "sum"],
                    group=_pg(group))
    if op == "avg":
        x.div_(n)
    return x


def all_gather(x: torch.Tensor, group: Optional[CommGroup] = None
               ) -> torch.Tensor:
    """Every rank's ``x`` stacked: ``[G, ...]`` on every rank."""
    n = _size(group)
    if n == 1:
        return x[None].clone()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=_pg(group))
    return torch.stack(parts)


def all_gather_base(x: torch.Tensor, group: Optional[CommGroup] = None
                    ) -> torch.Tensor:
    """Flat all-gather: this rank's ``[n, ...]`` chunk -> ``[G*n, ...]``,
    rank-major."""
    n = _size(group)
    if n == 1:
        return x.clone()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=_pg(group))
    return out


def reduce_scatter_base(x: torch.Tensor, op: str = "sum",
                        group: Optional[CommGroup] = None) -> torch.Tensor:
    """This rank's ``[N, ...]`` (N divisible by G) -> its reduced
    ``[N/G, ...]`` chunk: chunk r of the sum over ranks."""
    if op not in ("sum", "avg"):
        raise ValueError(f"reduce_scatter supports sum/avg, got {op!r}")
    n = _size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter needs N % G == 0, got {x.shape}")
    if n == 1:
        return x.clone()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    scatter(out, x.contiguous(), group=_pg(group))
    return out.div_(n) if op == "avg" else out


def all_to_all_single(x: torch.Tensor, group: Optional[CommGroup] = None
                      ) -> torch.Tensor:
    """``x``: ``[G, ...]``, row j bound for rank j. Returns ``[G, ...]``
    whose row j is rank j's row for this rank."""
    n = _size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all_single input must have leading dim "
                         f"== group size ({n}), got shape {tuple(x.shape)}")
    if n == 1:
        return x.clone()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=_pg(group))
    return out


def broadcast(x: torch.Tensor, src: int = 0,
              group: Optional[CommGroup] = None) -> torch.Tensor:
    """Rank ``src``'s ``x`` into every rank's ``x`` (in place)."""
    n = _size(group)
    if not 0 <= src < n:
        raise ValueError(f"src {src} out of range for group of size {n}")
    if n > 1:
        dist.broadcast(x, _global(group, src), group=_pg(group))
    return x


def ppermute(x: torch.Tensor, perm, group: Optional[CommGroup] = None
             ) -> torch.Tensor:
    """For each ``(src, dst)`` in ``perm`` rank src's ``x`` goes to rank
    dst. Returns what this rank received (zeros if it is no destination):
    row r of the TPU package's stacked result. Gloo cannot send a CUDA
    tensor, so over gloo the pair exchanges a host copy. Ranks are the
    group's own."""
    n = _size(group)
    me = get_rank() if group is None else group.rank
    if x.is_cuda and n > 1 and dist.get_backend(_pg(group)) == "gloo":
        return ppermute(x.cpu(), perm, group).to(x.device)
    out = torch.zeros_like(x)
    ops = []
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"pair {(s, d)} out of range for group of "
                             f"size {n}")
        if s == d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  _global(group, d), group=_pg(group)))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, _global(group, s),
                                  group=_pg(group)))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def send(x: torch.Tensor, dst: int, src: Optional[int] = None,
         group: Optional[CommGroup] = None) -> torch.Tensor:
    """Rank ``src`` (default: ``dst``'s left neighbour) sends ``x`` to
    ``dst``; every rank calls it and gets its row of the TPU package's
    stacked result (``dst``: src's tensor, others zeros)."""
    if src is None:
        src = (dst - 1) % _size(group)
    return ppermute(x, [(src, dst)], group=group)


def recv(x: torch.Tensor, src: int, dst: Optional[int] = None,
         group: Optional[CommGroup] = None) -> torch.Tensor:
    """The receiving form of :func:`send`: ``dst`` defaults to ``src + 1``
    (pipeline neighbour order)."""
    if dst is None:
        dst = (src + 1) % _size(group)
    return ppermute(x, [(src, dst)], group=group)


class PendingSend:
    """A send in flight (:func:`isend`): ``wait()`` returns once the tensor
    may be reused."""

    def __init__(self, work, tensor: torch.Tensor):
        self.work, self.tensor = work, tensor

    def wait(self) -> None:
        if self.work is not None:
            self.work.wait()
        self.work = self.tensor = None


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """What goes on the wire for ``x``: a host copy over gloo (which cannot
    send a CUDA tensor), else ``x`` itself."""
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(_pg(group)) == "gloo":
        return x.cpu()
    return x


def isend(x: torch.Tensor, dst: int, group: Optional[CommGroup] = None,
          tag: int = 0) -> PendingSend:
    """Start sending ``x`` to rank ``dst`` (the group's numbering) alone,
    the reference pipeline's point-to-point send (p2p.py:21-48): the
    caller goes on at once and waits on the handle before it reuses ``x``.
    The receiving rank calls :func:`recv_into` with the same ``tag``."""
    wire = _wire(x, group)
    return PendingSend(dist.isend(wire, _global(group, dst),
                                  group=_pg(group), tag=tag), wire)


def recv_into(x: torch.Tensor, src: int, group: Optional[CommGroup] = None,
              tag: int = 0) -> torch.Tensor:
    """Receive rank ``src``'s :func:`isend` of ``tag`` into ``x`` (its
    shape and dtype), blocking; returns ``x``."""
    wire = _wire(x, group)
    dist.recv(wire, _global(group, src), group=_pg(group), tag=tag)
    if wire is not x:
        x.copy_(wire)
    return x


# Capability aliases kept for API parity with the reference (comm.py:165-216).
allgather_fn = all_gather_base
reduce_scatter_fn = reduce_scatter_base
