"""Port decode attention (deepspeed_tpu_torch/ops/cuda/decode_attention.py)
against the TPU package's: the Pallas kernel in interpret mode and the
masked einsum. CPU tensors, so the port runs its plain version; the CUDA
kernel is held to the same plain version in tests/test_torch_cuda_kernels.py.
Tolerance: f32 on both sides, atol 1e-5 (summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu_torch.ops.cuda import _build
from deepspeed_tpu_torch.ops.cuda import decode_attention as pda

B, S, H, D = 3, 64, 2, 64
ATOL = 1e-5


def _inputs(s_q, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s_q, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, H * D)).astype(np.float32)
    v = rng.standard_normal((B, S, H * D)).astype(np.float32)
    # per-row fills: the shortest legal fill (s_q), mid-cache, and the
    # retired-lane sentinel (write index max_seq_len -> clamped to S)
    fills = np.array([s_q, 37, S + s_q], np.int32)
    return q, k, v, fills


def _port(q, k, v, fills, scale):
    return pda.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(fills),
                                scale=scale).numpy()


@pytest.mark.parametrize("s_q", [1, 4])
def test_plain_matches_pallas_kernel_interpret(s_q):
    q, k, v, fills = _inputs(s_q, seed=s_q)
    scale = 1.0 / np.sqrt(D)
    assert jda.pallas_decode_supported(B, S, H, D, jnp.float32, s_q)
    ref = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(fills),
        scale=scale))
    out = _port(q, k, v, fills, scale)
    assert out.shape == (B, s_q, H, D)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("s_q", [1, 4])
def test_plain_matches_masked_cache_attention(s_q):
    q, k, v, fills = _inputs(s_q, seed=10 + s_q)
    scale = 0.125
    first_q = np.minimum(fills, S) - s_q
    ref = np.asarray(jda.masked_cache_attention(
        jnp.asarray(q), jnp.asarray(k.reshape(B, S, H, D)),
        jnp.asarray(v.reshape(B, S, H, D)), jnp.asarray(first_q), scale))
    out = _port(q, k, v, fills, scale)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    # the port's own masked einsum is the same function
    mine = pda.masked_cache_attention(
        torch.from_numpy(q), torch.from_numpy(k.reshape(B, S, H, D)),
        torch.from_numpy(v.reshape(B, S, H, D)), torch.from_numpy(first_q),
        scale).numpy()
    np.testing.assert_allclose(mine, ref, rtol=0, atol=ATOL)


def test_query_that_sees_no_key_returns_zeros():
    q, k, v, _ = _inputs(4, seed=3)
    fills = np.array([1, 2, 64], np.int32)      # fewer than s_q positions
    out = _port(q, k, v, fills, 0.125)
    # row 0: queries 0..2 see nothing; row 1: queries 0..1
    assert np.all(out[0, :3] == 0) and np.any(out[0, 3] != 0)
    assert np.all(out[1, :2] == 0) and np.any(out[1, 2] != 0)
    assert np.all(np.any(out[2] != 0, axis=(1, 2)))


def test_cpu_tensors_never_launch_and_rank4_cache_is_viewed_flat():
    q, k, v, fills = _inputs(1, seed=5)
    before = _build.LAUNCHES["decode_attention"]
    flat = _port(q, k, v, fills, 0.125)
    rank4 = pda.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k.reshape(B, S, H, D)),
        torch.from_numpy(v.reshape(B, S, H, D)), torch.from_numpy(fills),
        scale=0.125).numpy()
    np.testing.assert_array_equal(flat, rank4)
    assert _build.LAUNCHES["decode_attention"] == before


def test_kernel_shape_gate():
    assert pda.decode_supported(1, 64, torch.bfloat16)
    assert pda.decode_supported(8, 128, torch.float32)
    assert not pda.decode_supported(9, 64, torch.bfloat16)
    assert not pda.decode_supported(1, 48, torch.bfloat16)
    assert not pda.decode_supported(1, 64, torch.float16)
    assert pda.decode_supported(1, 96, torch.bfloat16)


@pytest.mark.parametrize("d,dtype,s", [(48, torch.bfloat16, 1),
                                       (64, torch.float16, 1),
                                       (64, torch.bfloat16, 9)])
def test_model_auto_raises_on_unsupported_non_cpu_shape(d, dtype, s):
    """decode_impl="auto" never gives way to the einsum off the CPU: a shape
    the kernel does not take raises. Meta tensors take the wrapper's card
    path without a card; the shape check comes before any build."""
    from deepspeed_tpu_torch.models.gpt import GPTConfig, SelfAttention
    cfg = GPTConfig(vocab_size=64, max_seq_len=16, num_layers=1,
                    num_heads=2, d_model=2 * d, d_ff=4 * d)
    attn = SelfAttention(cfg, device="meta")
    q = torch.empty(2, s, 2, d, dtype=dtype, device="meta")
    cache = torch.empty(2, 16, 2 * d, dtype=dtype, device="meta")
    cur = torch.zeros(2, dtype=torch.int64, device="meta")
    before = _build.LAUNCHES["decode_attention"]
    with pytest.raises(ValueError, match="decode kernel takes"):
        attn._decode_attention(q, cache, cache, cur, "auto")
    assert _build.LAUNCHES["decode_attention"] == before


def test_int8_cache_scales_raise():
    q, k, v, fills = _inputs(1, seed=6)
    scales = torch.ones(B, S)
    with pytest.raises(NotImplementedError):
        pda.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(fills),
                             k_scale=scales, v_scale=scales)
