"""The port's compressed communication (``deepspeed_tpu_torch.comm.
compressed``) against the TPU package's ``deepspeed_tpu.comm.compressed``
on the CPU.

The primitives (sign packing, ``padded_size``, the wire accounting) are
compared bit for bit. The 1-bit all-reduce runs at 2 and 4 gloo ranks
(``torch_dist_helpers.run_ranks``, one start of the ranks a world size):
each rank passes its row of one stacked input made from a numpy seed, and
the JAX function runs under ``shard_map`` on a sub-mesh of the first G
virtual CPU devices on the same stacked input. Three calls in a row carry
the error buffers. The sign bytes must be equal; results and both error
buffers agree within ``TOL`` x the input's rms: the port accumulates each
norm in f64 and the TPU package in f32, so the scales part by f32
rounding, a few ulps, carried through three calls (the largest gap
on these inputs is 7.2e-7 of the rms, 2^-20.4). The error-feedback property of
``tests/test_onebit.py::test_error_feedback_converges`` holds on the port's
backend at both world sizes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_helpers as helpers
from torch_test_threads import one_torch_thread  # noqa: F401

from deepspeed_tpu.comm import compressed as jcp
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.comm import compressed as pcp

WORLDS = (2, 4)
CALLS = 3
TOL = 2.0 ** -16           # x the input's rms: results and error buffers


def _n(world):
    return jcp.padded_size(3000, world)


def _bufs(world, seed=0):
    rng = np.random.default_rng(seed + world)
    return rng.standard_normal((CALLS, world, _n(world))).astype(np.float32)


def _ef_buf(world):
    return np.random.default_rng(2).normal(
        size=(world, 512)).astype(np.float32)


@functools.lru_cache(None)
def _port(world):
    calls = {"chain": ("compressed_chain", dict(bufs=_bufs(world))),
             "ef": ("error_feedback", dict(buf=_ef_buf(world), calls=24))}
    return helpers.run_ranks("torch_onebit_helpers:cases", world,
                             calls=calls)


@functools.lru_cache(None)
def _jax(world):
    """The JAX chain on the stacked input: per call the stacked results
    and error buffers."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    spec = P("dp", None)

    def per(b, we, se):
        out, we2, se2 = jcp.compressed_allreduce(b[0], we[0], se[0], "dp",
                                                 world)
        return out[None], we2[None], se2[None]
    fn = jax.jit(shard_map(per, mesh=mesh, in_specs=(spec,) * 3,
                           out_specs=(spec,) * 3, check_vma=False))
    n = _n(world)
    we = jnp.zeros((world, n))
    se = jnp.zeros((world, n // world))
    out = []
    for buf in _bufs(world):
        signs = np.asarray(jcp.pack_signs(jnp.asarray(buf) + we >= 0))
        res, we, se = fn(jnp.asarray(buf), we, se)
        out.append({"signs": signs, "result": np.asarray(res),
                    "worker_error": np.asarray(we),
                    "server_error": np.asarray(se),
                    "server_signs": np.asarray(
                        jcp.pack_signs(res >= 0))})
    return out


# ------------------------------------------------------------- primitives

def test_pack_unpack_bitwise_equal_to_jax():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(3, 64)).astype(bool)
    got = pcp.pack_signs(torch.from_numpy(bits))
    want = np.asarray(jcp.pack_signs(jnp.asarray(bits)))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pcp.unpack_signs(got).numpy(), bits)
    np.testing.assert_array_equal(
        pcp.unpack_signs(got).numpy(),
        np.asarray(jcp.unpack_signs(jnp.asarray(want))))


def test_bit_order_and_sign_of_zero():
    """Bit i of byte j is element 8j+i; sign(0) packs as +1."""
    for i in range(16):
        bits = torch.zeros(16, dtype=torch.bool)
        bits[i] = True
        packed = pcp.pack_signs(bits).tolist()
        assert packed[i // 8] == 1 << (i % 8) and packed[1 - i // 8] == 0
    x = torch.tensor([0.0, -0.0, 1.0, -1.0, 0.0, -2.0, 3.0, 0.0])
    assert pcp.pack_signs(x >= 0).tolist() == [0b11010111]
    assert pcp._pm1(x >= 0).tolist() == [1, 1, 1, -1, 1, -1, 1, 1]


@pytest.mark.parametrize("world", [1, 2, 3, 4, 6, 8, 16])
def test_padded_size_and_wire_bytes_equal_jax(world):
    for n in (1, 7, 8, 63, 64, 65, 100, 1000, 4096, 124_439_808):
        npad = pcp.padded_size(n, world)
        assert npad == jcp.padded_size(n, world), (n, world)
        assert npad % (world * 8) == 0 and (npad // world) % 8 == 0
        assert pcp.wire_bytes_compressed(npad, world) == \
            jcp.wire_bytes_compressed(npad, world)
        assert pcp.wire_bytes_dense(n, world) == \
            jcp.wire_bytes_dense(n, world)


def test_unaligned_buffer_raises():
    with pytest.raises(ValueError, match="not aligned"):
        pcp.compressed_allreduce(torch.zeros(12), torch.zeros(12),
                                 torch.zeros(12))


# ------------------------------------------------------- the 1-bit exchange

@pytest.mark.parametrize("world", WORLDS)
def test_compressed_allreduce_matches_jax(world):
    port, want = _port(world), _jax(world)
    for c in range(CALLS):
        rms = float(np.sqrt(np.mean(_bufs(world)[c].astype(np.float64)
                                    ** 2)))
        for r in range(world):
            got = port[r]["chain"][c]
            for key in ("signs", "server_signs"):
                np.testing.assert_array_equal(got[key], want[c][key][r],
                                              err_msg=f"call {c} rank {r}")
            for key in ("result", "worker_error", "server_error"):
                np.testing.assert_allclose(
                    got[key], want[c][key][r], rtol=0, atol=TOL * rms,
                    err_msg=f"{key}, call {c} rank {r}")
            # every rank reconstructs the identical average
            np.testing.assert_array_equal(got["result"],
                                          port[0]["chain"][c]["result"])


@pytest.mark.parametrize("world", WORLDS)
def test_wire_bytes_counted_against_the_formula(world):
    """In each phase a rank sends (world-1)/world of the n/8 sign bytes and
    world-1 scales, and receives as much; at world 2 what it sends and
    receives is the TPU package's ``wire_bytes_compressed``."""
    n = _n(world)
    for r in range(world):
        for call in _port(world)[r]["chain"]:
            sent, received = call["wire"]["sent"], call["wire"]["received"]
            assert sent == received == 2 * (world - 1) * (n // world // 8 + 4)
            if world == 2:
                assert sent + received == pcp.wire_bytes_compressed(n, world)


@pytest.mark.parametrize("world", WORLDS)
def test_error_feedback_converges(world):
    """The running mean of 24 compressed all-reduces of a CONSTANT buffer
    converges to the true mean: the compression error is carried, not
    lost (tests/test_onebit.py::test_error_feedback_converges)."""
    target = _ef_buf(world).mean(0)
    for r in range(world):
        got = _port(world)[r]["ef"]
        rel = np.linalg.norm(got - target) / np.linalg.norm(target)
        assert rel < 0.2, rel


def test_backend_error_shapes():
    from deepspeed_tpu_torch.comm.comm import CommGroup
    for world in (2, 4, 6):
        backend = pcp.CompressedBackend(CommGroup(axes=("dp",),
                                                  ranks=tuple(range(world))))
        npad = jcp.padded_size(1000, world)
        assert backend.size == world
        assert backend.error_shapes(1000) == ((npad,), (npad // world,))
