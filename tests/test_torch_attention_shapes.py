"""The shapes the sparse (B5/B5b) and decode (B2/B3) kernels added, on the
CPU: the port's plain versions against the TPU package's Pallas kernels in
interpret mode, at d = 96 and in fp16.

  * sparse: forward and the grads of ``sparse_attention`` against the
    JAX ``sparse_attention`` and ``jax.grad`` of it, BigBird (block 16) at
    S = 128, d = 96 in f32 and d in {64, 96} in fp16 (f32 at d = 64 is
    test_torch_sparse_attention.py's), causal and not;
  * decode: the dense kernel (``decode_attention``, Pallas) and the paged
    one (``paged_decode_attention(impl="pallas")``) over fp16 caches, and
    both over int8 caches with an fp16 query, d in {64, 96}, s_q in {1, 4}.

Tolerances: f32 as the existing parity tests (forward 2e-4, grads 1e-3,
decode 1e-5). fp16: both sides compute in f32 and round the result to
fp16, so they part by one fp16 rounding of values of size ~1: 2e-3; the
sparse grads sum rounded fp16 inputs over 128 keys, 1e-2; the decode
plain version rounds its probabilities to the query's dtype as the TPU
package's XLA path does (the Pallas kernel keeps them f32), 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.sparse_attention.sparsity_config as jsc
import deepspeed_tpu_torch.ops.sparse_attention.sparsity_config as psc
from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu.ops.sparse_attention import sparse_attention as jsparse
from deepspeed_tpu_torch.ops.cuda import decode_attention as pda
from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention
from torch_test_threads import one_torch_thread  # noqa: F401

SPARSE_TOL = {np.float32: (2e-4, 1e-3), np.float16: (2e-3, 1e-2)}
DECODE_TOL = {np.float32: 1e-5, np.float16: 2e-3}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,d", [(np.float32, 96), (np.float16, 64),
                                     (np.float16, 96)])
def test_sparse_plain_matches_pallas(dtype, d, causal):
    kw = dict(num_heads=2, block=16, num_random_blocks=1)
    jcfg = jsc.BigBirdSparsityConfig(**kw)
    pcfg = psc.BigBirdSparsityConfig(**kw)
    rng = np.random.default_rng(d)
    q, k, v, g = (rng.standard_normal((1, 128, 2, d)).astype(dtype)
                  for _ in range(4))
    fwd_tol, grad_tol = SPARSE_TOL[dtype]

    def jloss(q, k, v):
        out = jsparse(q, k, v, jcfg, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * g.astype(np.float32)), out
    (_, want), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = sparse_attention(tq, tk, tv, pcfg, causal=causal)
    assert out.dtype == tq.dtype
    (out.float() * torch.from_numpy(g).float()).sum().backward()
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=fwd_tol,
                               atol=fwd_tol)
    for got, w, n in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        assert got.dtype == tq.dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32), rtol=grad_tol,
                                   atol=grad_tol, err_msg=f"d{n}")


def _decode_inputs(dtype, d, s_q, seed, b=3, S=64, h=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s_q, h, d)).astype(dtype)
    k = rng.standard_normal((b, S, h * d)).astype(dtype)
    v = rng.standard_normal((b, S, h * d)).astype(dtype)
    fills = np.array([s_q, 37, S + s_q], np.int32)
    return q, k, v, fills


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("s_q", [1, 4])
@pytest.mark.parametrize("d", [64, 96])
def test_decode_plain_matches_pallas_fp16(d, s_q):
    """Dense (B2) over an fp16 cache: the Pallas kernel against the plain
    version."""
    q, k, v, fills = _decode_inputs(np.float16, d, s_q, d + s_q)
    b, S = k.shape[:2]
    assert jda.pallas_decode_supported(b, S, 4, d, jnp.float16, s_q)
    ref = jda.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(fills),
                               scale=d ** -0.5)
    out = pda.decode_attention(_t(q), _t(k), _t(v), _t(fills),
                               scale=d ** -0.5)
    assert out.dtype == torch.float16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=DECODE_TOL[np.float16])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s_q", [1, 4])
@pytest.mark.parametrize("d", [64, 96])
def test_paged_plain_matches_pallas_fp16(d, s_q, int8):
    """Paged (B3) over an fp16 pool, or an int8 pool with an fp16 query:
    the Pallas kernel against the plain version, over a permuted table
    (blocks of 16 positions, 32 for int8: the TPU kernel's sublane)."""
    from deepspeed_tpu.ops.quantizer import quantize_kv
    b, h, S, bs = 3, 4, 64, 32 if int8 else 16
    T = S // bs
    q, k, v, fills = _decode_inputs(np.float16, d, s_q, 7 * d + s_q, b, S, h)
    perm = np.random.default_rng(d).permutation(b * T).astype(np.int32)
    tables = perm.reshape(b, T)
    kp = np.empty((b * T, bs, h * d), np.float16)
    vp = np.empty_like(kp)
    kp[perm] = k.reshape(b * T, bs, h * d)
    vp[perm] = v.reshape(b * T, bs, h * d)
    scales = {}
    if int8:
        (kq, ks), (vq, vs) = (quantize_kv(jnp.asarray(x, jnp.float32))
                              for x in (kp, vp))
        kp, vp = np.array(kq), np.array(vq)
        scales = dict(k_scale=np.array(ks)[..., 0],
                      v_scale=np.array(vs)[..., 0])
    assert jda.paged_decode_supported(b, bs, h, d, kp.dtype, s_q)
    ref = jda.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(fills), scale=d ** -0.5,
        impl="pallas", **{n: jnp.asarray(x) for n, x in scales.items()})
    out = pda.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(fills), scale=d ** -0.5,
        **{n: _t(x) for n, x in scales.items()})
    assert out.dtype == torch.float16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=DECODE_TOL[np.float16])
