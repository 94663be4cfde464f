"""The shapes the Hopper flash kernels added, on the CPU: the port's plain
flash versions against the TPU package's Pallas kernels run in interpret
mode at D in {64, 80, 96} x {f32, fp16}, causal and not, S in {64, 100}
(D 80: GPT 2.7B's head, which the 16-bit kernels run as 96 with
zero-filled columns):

  * the plain forward's out and lse against ``_flash_fwd``;
  * the plain backward's dq, dk, dv against ``_flash_bwd`` given the same
    residuals and cotangent;
  * the ``FlashAttention`` autograd function against ``jax.grad`` of the TPU
    ``flash_attention``.

Tolerances: f32 1e-5 absolute (summation order only). fp16: both sides
compute in f32 and round their outputs to fp16, so they part by one fp16
rounding of values of size ~1 (2^-11 relative): 2e-3 absolute and relative.
The lse is f32 on both sides (1e-5).

Also: which head dims and dtypes the flash and sparse kernels take, and the
ROADMAP's gate for fault C2: ``DeepSpeedTransformerLayer(fp16=True)``
without a mask (the flash path) against the JAX layer in fp16.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import flash_attention as pfa
from deepspeed_tpu_torch.ops.cuda import sparse_attention as psa
from torch_test_threads import one_torch_thread  # noqa: F401

jfa = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")

B, H = 2, 2
TOL = {np.float32: dict(rtol=0, atol=1e-5),
       np.float16: dict(rtol=2e-3, atol=2e-3)}
JNP = {np.float32: jnp.float32, np.float16: jnp.float16}
GRID = pytest.mark.parametrize("dtype,D,causal,S", [
    (dt, d, c, s) for dt in (np.float32, np.float16) for d in (64, 80, 96)
    for c in (True, False) for s in (64, 100)])


def _inputs(S, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(dtype)
            for _ in range(4)]                   # q, k, v, dO


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


def _t(x):
    return torch.from_numpy(x)


@GRID
def test_plain_forward_matches_pallas_fwd(dtype, D, causal, S):
    q, k, v, _ = _inputs(S, D, dtype, S + D)
    scale = D ** -0.5
    out, (_, _, _, _, lse) = jfa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale, S, S)
    p_out, p_lse = pfa.flash_attention_forward_reference(
        _t(q), _t(k), _t(v), causal, scale)
    assert p_out.dtype == _t(q).dtype and p_lse.dtype == torch.float32
    _close(p_out, out, dtype)
    _close(p_lse, np.asarray(lse)[..., 0], np.float32)


@GRID
def test_plain_backward_matches_pallas_bwd(dtype, D, causal, S):
    q, k, v, g = _inputs(S, D, dtype, S + D + 1)
    scale = D ** -0.5
    _, res = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, scale, S, S)
    ref = jfa._flash_bwd(causal, scale, S, S, res, jnp.asarray(g))
    out = torch.from_numpy(np.asarray(res[3]).transpose(0, 2, 1, 3).copy())
    lse = torch.from_numpy(np.asarray(res[4])[..., 0].copy())
    grads = pfa.flash_attention_backward_reference(
        _t(q), _t(k), _t(v), out, lse, _t(g), causal, scale)
    for got, want in zip(grads, ref):
        assert got.dtype == _t(q).dtype
        _close(got, want, dtype)


@GRID
def test_autograd_matches_jax_grad(dtype, D, causal, S):
    q, k, v, w = _inputs(S, D, dtype, S + D + 2)
    scale = D ** -0.5
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, sm_scale=scale)
        return jnp.sum(o.astype(jnp.float32) * w.astype(np.float32))

    jout = jfa.flash_attention(jq, jk, jv, causal=causal, sm_scale=scale)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = pfa.flash_attention(tq, tk, tv, causal=causal, sm_scale=scale)
    (out.float() * _t(w).float()).sum().backward()
    _close(out, jout, dtype)
    for t, want in zip((tq, tk, tv), jgrads):
        assert t.grad.dtype == tq.dtype
        _close(t.grad, want, dtype)


@pytest.mark.parametrize("name", ["flash", "sparse"])
def test_kernel_shapes_take_fp16_and_96_but_not_48(name):
    """Flash and sparse take d 80 too (GPT 2.7B's head dim)."""
    supported = (pfa.flash_supported if name == "flash"
                 else psa.sparse_supported)
    takes = (32, 64, 80, 96, 128)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in takes:
            assert supported(d, dtype), (d, dtype)
        for d in {16, 48, 80, 256} - set(takes):
            assert not supported(d, dtype), (d, dtype)
    assert not supported(64, torch.float64)


def test_fp16_layer_without_mask_matches_jax():
    """Fault C2's gate: the fp16 layer takes the flash path without a mask
    (on the card, the fp16 kernels). Against the JAX layer in fp16 (its
    Pallas flash in interpret mode), same f32-initialized weights cast to
    fp16: the output within 1e-2 (fp16 activations through two
    LayerNorms, attention and the MLP round at different places in the two
    frameworks), and the loss's gradients with respect to the input
    within 2e-2 of the largest gradient."""
    from deepspeed_tpu.ops.transformer import (
        DeepSpeedTransformerConfig as JCfg,
        DeepSpeedTransformerLayer as JLayer)
    from deepspeed_tpu_torch.convert import \
        transformer_layer_params_to_state_dict
    from deepspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
    hidden, heads, seq = 64, 4, 64
    kw = dict(hidden_size=hidden, heads=heads, num_hidden_layers=12,
              fp16=True, bf16=False, pre_layer_norm=True)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, seq, hidden)).astype(np.float16)
    jlayer = JLayer(JCfg(**kw))
    params = jlayer.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                         None, deterministic=True)["params"]
    layer = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(**kw))
    layer.load_state_dict(transformer_layer_params_to_state_dict(
        jax.tree.map(np.asarray, params)))

    def jloss(xx):
        y = jlayer.apply({"params": params}, xx, None, deterministic=True)
        return jnp.mean(jnp.square(y.astype(jnp.float32))), y
    (_, jout), jgx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt, None, deterministic=True)
    assert out.dtype == torch.float16
    out.float().square().mean().backward()
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout, np.float32), rtol=1e-2,
                               atol=1e-2)
    jg = np.asarray(jgx, np.float32)
    np.testing.assert_allclose(xt.grad.float().numpy(), jg, rtol=0,
                               atol=2e-2 * np.abs(jg).max())
