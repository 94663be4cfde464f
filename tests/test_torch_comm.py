"""The port's comm façade (``deepspeed_tpu_torch.comm``) against the TPU
package's ``deepspeed_tpu.comm`` on the CPU.

The port runs 2 and 4 gloo ranks, one process each
(``torch_dist_helpers.run_ranks``); every rank calls each collective on its
own row of one stacked input made from a numpy seed. Stacking the ranks'
results gives the TPU package's stacked view, which the JAX collective
computes on the same stacked input over the first G devices of the 8-device
virtual CPU mesh. f32 throughout: sums of 2-4 terms in another order, so
within 1e-6. The coalesced collectives are also held to their per-tensor
form, and the launcher's OMPI_* / MV2_* discovery to the TPU package's.
"""

import functools
import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_dist_helpers as helpers
from torch_test_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)
WORLDS = (2, 4)


def _inputs(world, seed=0):
    rng = np.random.default_rng(seed + world)

    def draw(*shape):
        return rng.standard_normal((world,) + shape).astype(np.float32)
    return {"x": draw(3, 5), "chunk": draw(4), "flat": draw(4 * world),
            "a2a": draw(world, 3), "p0": draw(5, 3), "p1": draw(7),
            "p2": draw(2, 2), "s0": draw(3), "s1": draw(5)}


@functools.lru_cache(None)
def _port(world):
    return helpers.run_ranks("torch_dist_helpers:collectives", world,
                             inputs=_inputs(world))


@functools.lru_cache(None)
def _jax(world):
    from deepspeed_tpu.comm import coalesced_collectives as jcc
    from deepspeed_tpu.comm import comm as jcomm
    group = jcomm.new_group("dp", mesh=Mesh(np.array(jax.devices()[:world]),
                                            ("dp",)))
    inp = _inputs(world)
    x = inp["x"]
    want = {f"all_reduce_{op}": jcomm.all_reduce(x, op, group)
            for op in ("sum", "avg", "max", "min")}
    want["all_gather"] = jcomm.all_gather(x, group)
    want["all_gather_base"] = jcomm.all_gather_base(inp["chunk"], group)
    want["allgather_fn"] = jcomm.allgather_fn(inp["chunk"], group)
    for op in ("sum", "avg"):
        want[f"reduce_scatter_base_{op}"] = jcomm.reduce_scatter_base(
            inp["flat"], op, group)
    want["reduce_scatter_fn"] = jcomm.reduce_scatter_fn(inp["flat"],
                                                        group=group)
    want["all_to_all_single"] = jcomm.all_to_all_single(inp["a2a"], group)
    want["broadcast"] = jcomm.broadcast(x, src=1, group=group)
    want["send"] = jcomm.send(x, dst=1, src=0, group=group)
    want["recv"] = jcomm.recv(x, src=world - 1, group=group)
    want["ppermute"] = jcomm.ppermute(
        x, [(r, (r + 1) % world) for r in range(world)], group)
    want["reduce_scatter_coalesced"] = jcc.reduce_scatter_coalesced(
        [inp[k] for k in ("p0", "p1", "p2")], group)
    want["all_gather_coalesced"] = jcc.all_gather_coalesced(
        [inp[k] for k in ("s0", "s1")], group)
    return jax.tree.map(np.asarray, want)


# collectives whose result is the same on every rank (the TPU result is
# replicated) and those whose rank r holds row r of the TPU stacked result
REPLICATED = ("all_reduce_sum", "all_reduce_avg", "all_reduce_max",
              "all_reduce_min", "all_gather", "all_gather_base",
              "allgather_fn", "broadcast")
PER_RANK = ("reduce_scatter_base_sum", "reduce_scatter_base_avg",
            "reduce_scatter_fn", "all_to_all_single", "send", "recv",
            "ppermute")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", REPLICATED)
def test_replicated_collective_matches_jax(world, name):
    want = _jax(world)[name]
    for rank, got in enumerate(_port(world)):
        np.testing.assert_allclose(got[name], want, **TOL,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", PER_RANK)
def test_per_rank_collective_stacks_to_jax(world, name):
    stacked = np.stack([got[name] for got in _port(world)])
    np.testing.assert_allclose(stacked, _jax(world)[name], **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_reduce_scatter_coalesced_matches_jax_and_per_tensor(world):
    want = _jax(world)["reduce_scatter_coalesced"]
    ranks = _port(world)
    for i, w in enumerate(want):
        stacked = np.stack([got["reduce_scatter_coalesced"][i]
                            for got in ranks])
        np.testing.assert_allclose(stacked, w, **TOL)
        for got in ranks:       # gloo may sum the two layouts in
            np.testing.assert_allclose(                # another order
                got["reduce_scatter_coalesced"][i],
                got["reduce_scatter_single"][i], **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_coalesced_matches_jax_and_per_tensor(world):
    want = _jax(world)["all_gather_coalesced"]
    for got in _port(world):
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got["all_gather_coalesced"][i], w)
            np.testing.assert_array_equal(got["all_gather_coalesced"][i],
                                          got["all_gather_single"][i])


@pytest.mark.parametrize("world", WORLDS)
def test_rank_world_and_groups(world):
    for rank, got in enumerate(_port(world)):
        assert (got["rank"], got["world"], got["group"], got["devices"]) \
            == (rank, world, world, world)


def test_groups_beyond_dp_raise():
    """Every axis group follows the mesh (they raised, naming ROADMAP A9,
    until the mesh was ported): without a mesh set the mesh is the pure-dp
    one over the one-process world, so every axis group is this rank
    alone, as the TPU package's groups of the one-device mesh are; an
    unknown axis still raises. tests/test_torch_mesh.py holds the groups
    of a dp 2 × ep 2 mesh over four ranks to the TPU mesh's layout."""
    from deepspeed_tpu.comm import comm as jcomm
    from deepspeed_tpu.parallel import mesh as jmesh
    from deepspeed_tpu_torch import comm
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
               jmesh.MESH_AXES)
    for get in (comm.get_model_parallel_group,
                comm.get_expert_parallel_group,
                comm.get_data_parallel_group):
        assert get().size == 1
    for axes in ("sp", ("dp", "tp"), ("dp", "pp", "ep", "sp", "tp")):
        g = comm.new_group(axes)
        assert (g.axes, g.size) == (
            (axes,) if isinstance(axes, str) else axes,
            jcomm.new_group(axes, mesh=one).size)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        comm.new_group("xx")
    # one process, no group: the identity, as at one rank
    x = np.arange(6, dtype=np.float32)
    import torch
    t = torch.from_numpy(x.copy())
    assert comm.get_world_size() == 1 and comm.get_rank() == 0
    np.testing.assert_array_equal(comm.all_reduce(t).numpy(), x)
    np.testing.assert_array_equal(comm.all_gather(t).numpy(), x[None])
    np.testing.assert_array_equal(comm.reduce_scatter_base(t).numpy(), x)


@pytest.mark.parametrize("prefix", ["OMPI", "MV2"])
def test_mpi_discovery_matches_jax(prefix, monkeypatch):
    """mpirun's / mpirun_rsh's identity: the same coordinator, world and
    rank reach jax.distributed.initialize and init_process_group."""
    import torch.distributed as dist
    from deepspeed_tpu.comm import comm as jcomm
    from deepspeed_tpu.parallel import mesh as mesh_lib
    from deepspeed_tpu_torch.comm import comm as pcomm
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "LOCAL_RANK", "OMPI_COMM_WORLD_SIZE",
                "MV2_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(f"{prefix}_COMM_WORLD_SIZE", "4")
    monkeypatch.setenv(f"{prefix}_COMM_WORLD_RANK", "2")
    monkeypatch.setenv(f"{prefix}_COMM_WORLD_LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "10.1.2.3")
    monkeypatch.setenv("MASTER_PORT", "29611")
    seen = {}
    monkeypatch.setattr(jcomm, "_INITIALIZED", False)
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.setdefault("jax", kw))
    monkeypatch.setattr(mesh_lib, "set_global_mesh", lambda *a, **k: None)
    jcomm.init_distributed()
    jax_local = os.environ["LOCAL_RANK"]
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setattr(pcomm, "_INITIALIZED", False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.setdefault(
                            "torch", dict(kw, backend=backend)))
    pcomm.init_distributed(device="cpu")
    j, t = seen["jax"], seen["torch"]
    assert t["init_method"] == f"tcp://{j['coordinator_address']}"
    assert (t["world_size"], t["rank"]) == (j["num_processes"],
                                            j["process_id"]) == (4, 2)
    assert t["backend"] == "gloo"
    assert os.environ["LOCAL_RANK"] == jax_local == "1"
