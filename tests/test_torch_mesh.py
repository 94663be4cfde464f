"""The port's device mesh and topology (``deepspeed_tpu_torch.parallel``)
against the TPU package's ``deepspeed_tpu.parallel``, on the CPU.

  * ``ProcessTopology`` and its two named subclasses: every rank's
    coordinate, every coordinate's rank, ``filter_match`` and the per-axis
    comm lists equal the TPU package's; ``PipelineParallelGrid``'s ids,
    group lists, p2p pairs and ``stage_to_global`` at every rank too;
  * ``MeshShape.infer``: the same shapes and the same refusals;
  * the mesh's rank layout: at world 8 (dp 2 × ep 2 × tp 2, and dp 2 × pp 2
    × sp 2) each rank's group over every set of axes holds the ranks whose
    devices share its coordinates in the TPU mesh's ``devices`` array
    (device ids of the 8 virtual CPU devices);
  * four gloo ranks at dp 2 × ep 2 (``torch_dist_helpers.run_ranks``): the
    dp, ep and (dp, ep) groups' members, ``all_reduce`` / ``broadcast`` /
    ``all_gather_base`` / ``ppermute`` over each equal to the stacked
    numpy result over those members, and the data loader's shard per dp
    coordinate.
"""

import itertools

import jax
import numpy as np
import pytest

import torch_dist_helpers as helpers
from torch_test_threads import one_torch_thread  # noqa: F401

TOPOLOGIES = [("ProcessTopology", (["a", "b", "c"], [2, 3, 2])),
              ("ProcessTopology", (["x"], [5])),
              ("PipeDataParallelTopology", (2, 4)),
              ("PipeModelDataParallelTopology", (2, 2, 3))]


def _pair(name, args):
    from deepspeed_tpu.parallel import topology as jt
    from deepspeed_tpu_torch.parallel import topology as pt
    return getattr(jt, name)(*args), getattr(pt, name)(*args)


@pytest.mark.parametrize("case", range(len(TOPOLOGIES)))
def test_topology_matches_jax(case):
    jtop, ptop = _pair(*TOPOLOGIES[case])
    assert ptop.axes == jtop.axes and ptop.dims == jtop.dims
    assert ptop.world_size() == jtop.world_size()
    for r in range(jtop.world_size()):
        assert tuple(ptop.get_coord(r)) == tuple(jtop.get_coord(r))
        assert ptop.get_rank(**jtop.get_coord(r)._asdict()) == r
        assert ptop.get_rank_repr(r) == jtop.get_rank_repr(r)
    for axis in jtop.axes:
        assert ptop.get_axis_comm_lists(axis) == \
            jtop.get_axis_comm_lists(axis)
        for i in range(jtop.get_dim(axis)):
            assert ptop.get_axis_list(axis, i) == jtop.get_axis_list(axis, i)
    assert ptop.get_axis_comm_lists("nope") == []
    with pytest.raises(ValueError):
        ptop.filter_match(nope=0)


@pytest.mark.parametrize("case", range(2, len(TOPOLOGIES)))
def test_pipeline_grid_matches_jax(case):
    from deepspeed_tpu.parallel.topology import PipelineParallelGrid as JG
    from deepspeed_tpu_torch.parallel.topology import \
        PipelineParallelGrid as PG
    jtop, ptop = _pair(*TOPOLOGIES[case])
    for r in range(jtop.world_size()):
        jg, pg = JG(jtop, global_rank=r), PG(ptop, global_rank=r)
        for attr in ("stage_id", "data_parallel_id", "model_parallel_id",
                     "data_parallel_size", "pipe_parallel_size",
                     "model_parallel_size", "world_size", "dp_groups",
                     "pp_groups", "mp_groups", "p2p_groups"):
            assert getattr(pg, attr) == getattr(jg, attr), (attr, r)
        for fn in ("get_data_parallel_group_ranks",
                   "get_pipe_parallel_group_ranks",
                   "get_model_parallel_group_ranks", "is_first_stage",
                   "is_last_stage"):
            assert getattr(pg, fn)() == getattr(jg, fn)(), (fn, r)
        for stage in range(jg.pipe_parallel_size):
            assert pg.stage_to_global(stage) == jg.stage_to_global(stage)
    default = (JG(world_size=6, global_rank=4), PG(world_size=6,
                                                   global_rank=4))
    assert default[1].dp_groups == default[0].dp_groups


def test_mesh_shape_infer_matches_jax():
    from deepspeed_tpu.parallel.mesh import MeshShape as JS
    from deepspeed_tpu_torch.parallel.mesh import MESH_AXES, MeshShape as PS
    from deepspeed_tpu.parallel.mesh import MESH_AXES as JAXES
    assert MESH_AXES == JAXES
    for n, kw in [(8, {}), (8, {"tp": 2}), (8, {"ep": 2, "tp": 2}),
                  (12, {"pp": 3, "sp": 2}), (4, {"ep": 2, "dp": 2})]:
        assert PS.infer(n, **kw).as_dict() == JS.infer(n, **kw).as_dict()
    for n, kw in [(8, {"ep": 3}), (8, {"ep": 2, "dp": 2})]:
        with pytest.raises(ValueError):
            JS.infer(n, **kw)
        with pytest.raises(ValueError):
            PS.infer(n, **kw)


LAYOUTS = [dict(dp=2, ep=2, tp=2), dict(dp=2, pp=2, sp=2)]


@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
def test_mesh_groups_match_jax_device_layout(layout):
    """Each rank's group over each set of axes: the ranks whose TPU-mesh
    devices share its coordinates off those axes."""
    from deepspeed_tpu.parallel import mesh as jmesh
    from deepspeed_tpu_torch.parallel.mesh import (MESH_AXES, DeviceMesh,
                                                   MeshShape)
    shape = LAYOUTS[layout]
    jm = jmesh.build_mesh(jmesh.MeshShape(**shape), jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert sorted(ids.ravel()) == list(range(8))
    for r in range(8):
        pm = DeviceMesh(MeshShape(**shape), r, {})
        np.testing.assert_array_equal(pm.devices, np.arange(8).reshape(
            ids.shape))
        where = tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert tuple(pm.coords().values()) == where
        for n in range(1, len(MESH_AXES) + 1):
            for axes in itertools.combinations(MESH_AXES, n):
                index = tuple(slice(None) if a in axes else c
                              for a, c in zip(MESH_AXES, where))
                want = sorted(int(i) for i in np.ravel(ids[index]))
                assert pm.group_ranks(axes) == want, (r, axes)


X = np.random.default_rng(0).standard_normal((4, 3, 5)).astype(np.float32)


@pytest.fixture(scope="module")
def ep_ranks():
    return helpers.run_ranks("torch_dist_helpers:mesh_groups", 4,
                             shape=dict(dp=2, ep=2), x=X)


def test_ep_mesh_groups_and_collectives(ep_ranks):
    """dp 2 × ep 2 over four gloo ranks: rank r is (dp r // 2, ep r % 2),
    as device r is in the TPU mesh; each group's collectives compute the
    stacked result over its members."""
    x = X
    for r, got in enumerate(ep_ranks):
        assert got["coords"]["dp"] == r // 2 and got["coords"]["ep"] == r % 2
        assert got["dp_members"] == [r % 2, r % 2 + 2]
        assert got["ep_members"] == [r - r % 2, r - r % 2 + 1]
        assert got["dpep_members"] == [0, 1, 2, 3]
        assert got["tp_members"] == [r]
        for g in ("dp", "ep"):
            members = got[f"{g}_members"]
            np.testing.assert_allclose(got[f"{g}_sum"],
                                       x[members].sum(0), rtol=1e-6)
            np.testing.assert_array_equal(
                got[f"{g}_gather"], np.concatenate(x[members]))
            # broadcast from the group's rank 1; ppermute over its ring
            np.testing.assert_array_equal(got[f"{g}_bcast"], x[members[1]])
            me = members.index(r)
            np.testing.assert_array_equal(got[f"{g}_ring"],
                                          x[members[me - 1]])
        np.testing.assert_allclose(got["tp_sum"], x[r])
        # the loader's shard follows the dp coordinate: ep partners share
        assert got["loader"] == [r // 2 * 2, r // 2 * 2 + 1]
