"""The port's ``TiledLinear`` (deepspeed_tpu_torch/runtime/zero/tiling.py)
against the TPU package's ``TiledDense`` on the CPU, f32, over a grid of
(in_splits, out_splits), with and without bias: the JAX layer's params
through ``convert.tiled_params_to_state_dict``, the same numpy input, the
output and the grads of a weighted sum with respect to the input, the
kernel and the bias within 1e-5 relative and 1e-6 absolute (f32 products in
XLA's and torch's summation orders; the tiles are summed in the same
order). The init's variance (fault C5) against the JAX layer's: the tile
axis counts as receptive field, fan-in = in_features x out_splits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_test_threads import one_torch_thread  # noqa: F401

D_IN, D_OUT = 24, 36
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("splits", [(1, 1), (2, 1), (1, 3), (2, 3), (4, 2)])
def test_tiled_linear_matches_jax_tiled_dense(splits, bias):
    from deepspeed_tpu.runtime.zero.tiling import TiledDense
    from deepspeed_tpu_torch.convert import tiled_params_to_state_dict
    from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear
    p, q = splits
    rng = np.random.default_rng(p * 10 + q)
    x = rng.standard_normal((3, 5, D_IN)).astype(np.float32)
    w = rng.standard_normal((3, 5, D_OUT)).astype(np.float32)
    jlayer = TiledDense(features=D_OUT, in_splits=p, out_splits=q,
                        use_bias=bias)
    params = jlayer.init(jax.random.PRNGKey(p + q), jnp.asarray(x))["params"]
    if bias:    # a nonzero bias, so its add is checked
        params = dict(params, bias=jnp.asarray(
            rng.standard_normal(D_OUT).astype(np.float32)))

    def jloss(prm, xx):
        y = jlayer.apply({"params": prm}, xx)
        return (y * jnp.asarray(w)).sum(), y
    (_, jy), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(params,
                                                          jnp.asarray(x))
    layer = TiledLinear(D_IN, D_OUT, in_splits=p, out_splits=q, bias=bias)
    layer.load_state_dict(tiled_params_to_state_dict(
        jax.tree.map(np.asarray, params)))
    assert layer.kernel.shape == (p * q, D_IN // p, D_OUT // q)
    tx = torch.from_numpy(x).requires_grad_()
    y = layer(tx)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    want = tiled_params_to_state_dict(jax.tree.map(np.asarray, jg))
    for name, prm in layer.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


# the init's sample variance over 512 x 512 = 262144 draws of a normal cut
# at two standard deviations: its relative standard error is below
# sqrt(2 / 262144) = 0.28%, so 3% is more than ten of them, and the wrong
# rule (1 / in_features) is off by out_splits x at q > 1
INIT_RTOL = 0.03


@pytest.mark.parametrize("splits", [(1, 1), (2, 1), (1, 4), (2, 4), (4, 2)])
def test_tiled_linear_init_variance_matches_jax(splits):
    from deepspeed_tpu.runtime.zero.tiling import TiledDense
    from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear
    p, q = splits
    d = 512
    jk = np.asarray(TiledDense(features=d, in_splits=p, out_splits=q).init(
        jax.random.PRNGKey(p * 10 + q), jnp.zeros((1, d)))["params"]
        ["kernel"])
    layer = TiledLinear(d, d, in_splits=p, out_splits=q)
    layer.reset_parameters(torch.Generator().manual_seed(p * 10 + q))
    pk = layer.kernel.detach().numpy()
    assert pk.shape == jk.shape == (p * q, d // p, d // q)
    want = 1.0 / (d * q)
    for k in (jk, pk):
        assert abs(k.var() / want - 1) < INIT_RTOL, (k.var(), want)
        assert abs(k.mean()) < 0.01 * np.sqrt(want)
    # both cut at two standard deviations of the widened normal
    cut = 2 * np.sqrt(want) / 0.87962566103423978
    assert np.abs(pk).max() <= cut and np.abs(jk).max() <= cut * (1 + 1e-6)
    assert np.abs(pk).max() > 0.95 * cut
    assert not layer.bias.any()


def test_tiled_linear_equals_linear_with_the_assembled_weight():
    from deepspeed_tpu_torch.runtime.zero.tiling import TiledDense, \
        TiledLinear
    assert TiledDense is TiledLinear
    layer = TiledLinear(D_IN, D_OUT, in_splits=1, out_splits=3)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    weight = torch.cat(list(layer.kernel), dim=-1)       # [in, out]
    x = torch.randn(4, D_IN, generator=torch.Generator().manual_seed(1))
    assert torch.equal(layer(x), x @ weight + layer.bias)
    with pytest.raises(ValueError, match="divisible"):
        TiledLinear(D_IN, D_OUT, in_splits=5)
