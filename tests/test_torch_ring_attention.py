"""Ring attention in the port (``deepspeed_tpu_torch/ops/ring_attention.py``)
against the TPU package's ``ring_attention``, on the CPU in f32.

The TPU package runs its ``shard_map`` over the 8 virtual devices (a mesh
with sp 2 or 4, dp the rest) and is differentiated by ``jax.vjp``; the
port runs ``RingAttention`` over sp gloo ranks
(``torch_dist_helpers.run_ranks``, one start at 2 ranks and one at 4, each
rank its sequence chunk), the blocks through the flash kernels' plain
versions (CPU tensors). Held to it, within ``TOL`` (f32: the port merges
blocks by their log-sum-exps, JAX by running max and exp-sum, so the sums
differ in order):

  * each rank's output chunk and its q / k / v grads under
    ``sum(out * dout)``, causal and not, at sp 2 and 4;
  * the plain version (``ring_attention_reference``, every rank's walk in
    one process) and its autograd grads, at sp 2 and 4;
  * the hops a rank makes: n - 1 of K/V forward, n - 1 of the dk/dv
    accumulators backward (no K/V sent again);
  * one rank (no group) is one causal flash block, as JAX's ``ring == 1``;
    local windows and sparse layouts refuse, as in the TPU model (and a
    sparse layout under Ulysses over an sp group).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as helpers
from torch_test_threads import one_torch_thread  # noqa: F401

from deepspeed_tpu_torch.ops.ring_attention import (ring_attention,
                                                    ring_attention_reference)

B, S, H, D = 2, 32, 2, 16
TOL = dict(rtol=1e-5, atol=2e-5)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(4)]


@functools.lru_cache(None)
def _jax_ring(sp, causal):
    """The TPU package's output and q / k / v grads over the whole
    sequence, on a mesh with sp = ``sp``."""
    from deepspeed_tpu.ops.ring_attention import ring_attention as jring
    from deepspeed_tpu.parallel import mesh as mesh_lib
    mesh = mesh_lib.build_mesh(mesh_lib.MeshShape.infer(8, sp=sp))

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(
            lambda q, k, v: jring(q, k, v, mesh, causal=causal), q, k, v)
        return out, vjp(do)

    out, grads = run(*(jnp.asarray(t) for t in _inputs(sp)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _calls(sp):
    return {f"causal{int(c)}": ("ring", dict(zip(
        ("q", "k", "v", "dout"), _inputs(sp)), causal=c))
        for c in (True, False)}


@pytest.fixture(scope="module")
def ranks():
    return {sp: helpers.run_ranks("torch_sp_helpers:cases", sp,
                                  calls=_calls(sp))
            for sp in (2, 4)}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_chunks_and_grads_equal_jax(ranks, sp, causal):
    out, grads = _jax_ring(sp, causal)
    got = [r[f"causal{int(causal)}"] for r in ranks[sp]]
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got], 1),
                               out, **TOL)
    for name, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(
            np.concatenate([g[name] for g in got], 1), want, **TOL,
            err_msg=name)


@pytest.mark.parametrize("sp", [2, 4])
def test_hops_a_rank_makes(ranks, sp):
    """Forward: n - 1 hops of the stacked K/V chunk (2 B S/n H D f32);
    backward: n - 1 of the f32 dk/dv accumulators, the same size."""
    kv = 2 * B * (S // sp) * H * D * 4
    for r in ranks[sp]:
        for case in ("causal1", "causal0"):
            t = r[case]["traffic"]
            assert t["ring_hops"] == 2 * (sp - 1)
            assert t["ring_bytes"] == 2 * (sp - 1) * kv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4])
def test_reference_and_its_grads_equal_jax(sp, causal):
    out, grads = _jax_ring(sp, causal)
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(sp))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ref = ring_attention_reference(q, k, v, sp, causal=causal)
    (ref * do).sum().backward()
    np.testing.assert_allclose(ref.detach().numpy(), out, **TOL)
    for t, want in zip((q, k, v), grads):
        np.testing.assert_allclose(t.grad.numpy(), want, **TOL)


def test_one_rank_is_one_causal_block():
    from deepspeed_tpu_torch.ops.cuda.flash_attention import \
        flash_attention_forward
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs(1))
    want, _ = flash_attention_forward(q, k, v, True, D ** -0.5)
    assert torch.equal(ring_attention(q, k, v), want)
    np.testing.assert_allclose(
        ring_attention_reference(q, k, v, 1).numpy(), want.numpy(), **TOL)


def test_windows_and_sparse_layouts_refuse():
    from deepspeed_tpu_torch.comm.comm import CommGroup
    from deepspeed_tpu_torch.models.gpt import (GPT, GPTConfig,
                                                set_sequence_parallel)
    from deepspeed_tpu_torch.ops.sparse_attention import \
        BigBirdSparsityConfig
    kw = dict(vocab_size=64, max_seq_len=32, num_layers=2, num_heads=2,
              d_model=32, d_ff=64, dtype=torch.float32,
              sequence_parallel=True, cp_impl="ring")
    ids = torch.zeros(1, 32, dtype=torch.long)
    sparse = dict(attention_impl="sparse",
                  sparse_attention=BigBirdSparsityConfig(num_heads=2,
                                                         block=16))
    for extra in (dict(attn_windows=(None, 8), scan_layers=False), sparse):
        with pytest.raises(NotImplementedError, match="ring"):
            GPT(GPTConfig(**kw, **extra))(ids)
    # Ulysses over an sp group (two ranks named; the refusal comes before
    # any exchange)
    model = set_sequence_parallel(
        GPT(GPTConfig(**dict(kw, cp_impl="ulysses"), **sparse)),
        CommGroup(axes=("sp",), ranks=(0, 1)))
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        model(ids[:, :16])
