"""The port's flash attention (ops/cuda/flash_attention.py) on the CPU
against the TPU package's Pallas kernels run in interpret mode, f32:

  * the plain forward's out and lse against ``_flash_fwd``'s residuals;
  * the plain backward's dq, dk, dv against ``_flash_bwd`` given the same
    residuals and cotangent;
  * the ``FlashAttention`` autograd function against ``jax.grad`` of the TPU
    ``flash_attention``;

causal and not, S in {64, 100} (one tile each on the TPU side), D = 64.
Tolerance 1e-5 absolute: both sides compute in f32 and differ only in
summation order."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import flash_attention as pfa
from torch_test_threads import one_torch_thread  # noqa: F401

# the module (the package re-exports its flash_attention function)
jfa = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")

ATOL = 1e-5
B, H, D = 2, 2, 64
SCALE = 1 / 8


def _inputs(S, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(4)]                   # q, k, v, dO


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 100])
def test_plain_forward_matches_pallas_fwd(causal, S):
    q, k, v, _ = _inputs(S, S)
    out, (_, _, _, _, lse) = jfa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, SCALE, S, S)
    p_out, p_lse = pfa.flash_attention_forward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, SCALE)
    assert p_lse.shape == (B, H, S) and p_lse.dtype == torch.float32
    _close(p_out, out)
    _close(p_lse, np.asarray(lse)[..., 0])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 100])
def test_plain_backward_matches_pallas_bwd(causal, S):
    q, k, v, g = _inputs(S, S + 1)
    _, res = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, SCALE, S, S)
    ref = jfa._flash_bwd(causal, SCALE, S, S, res, jnp.asarray(g))
    out = torch.from_numpy(np.asarray(res[3]).transpose(0, 2, 1, 3).copy())
    lse = torch.from_numpy(np.asarray(res[4])[..., 0].copy())
    grads = pfa.flash_attention_backward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), out,
        lse, torch.from_numpy(g), causal, SCALE)
    for got, want in zip(grads, ref):
        _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [64, 100])
def test_autograd_matches_jax_grad(causal, S):
    q, k, v, w = _inputs(S, S + 2)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal,
                                           sm_scale=SCALE) * w)

    jout = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, sm_scale=SCALE)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = pfa.flash_attention(tq, tk, tv, causal=causal, sm_scale=SCALE)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out, jout)
    for t, want in zip((tq, tk, tv), jgrads):
        _close(t.grad, want)


def test_cpu_tensors_never_reach_the_kernels():
    """On the CPU the wrappers run the plain versions and launch nothing."""
    from deepspeed_tpu_torch.ops.cuda import _build
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(16, 3))
    before = dict(_build.LAUNCHES)
    out, lse = pfa.flash_attention_forward(q, k, v, True, SCALE)
    pfa.flash_attention_backward(q, k, v, out, lse, g, True, SCALE)
    assert dict(_build.LAUNCHES) == before
    assert pfa.flash_supported(64, torch.bfloat16)
    assert pfa.flash_supported(64, torch.float16)
    assert pfa.flash_supported(96, torch.bfloat16)
    assert not pfa.flash_supported(48, torch.float32)
    assert not pfa.flash_supported(48, torch.float16)
