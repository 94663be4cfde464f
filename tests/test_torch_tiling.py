"""The port's ``TiledLinear`` (deepspeed_tpu_torch/runtime/zero/tiling.py)
against the TPU package's ``TiledDense`` on the CPU, f32, over a grid of
(in_splits, out_splits), with and without bias: the JAX layer's params
through ``convert.tiled_params_to_state_dict``, the same numpy input, the
output and the grads of a weighted sum with respect to the input, the
kernel and the bias within 1e-5 relative and 1e-6 absolute (f32 products in
XLA's and torch's summation orders; the tiles are summed in the same
order). The init's variance (fault C5) against the JAX layer's: the tile
axis counts as receptive field, fan-in = in_features x out_splits. Under
ZeRO-3 at 2 gloo ranks (``torch_dist_helpers.tiled_zero3``): each gather
assembles one tile's bytes and holds one tile at a time, and one SGD step
equals the whole-kernel gather and the JAX layer's gradient."""

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


# ZeRO-3 over 2 gloo ranks: the kernel [p*q, in/p, out/q] gathered a tile at
# a time against the same engine gathering it whole, and one SGD step
# against the JAX TiledDense's gradient on the whole batch (f32; the tiles'
# products are the same ops on both ranks, the reductions sum two terms)
Z3_IN, Z3_OUT, Z3_ROWS, Z3_LR = 48, 40, 6, 0.5


@pytest.mark.parametrize("splits", [(2, 4), (3, 1), (1, 5)])
def test_zero3_gathers_one_tile_at_a_time(splits):
    from deepspeed_tpu.runtime.zero.tiling import TiledDense
    from deepspeed_tpu_torch.convert import tiled_params_to_state_dict
    import torch_dist_helpers as helpers
    p, q = splits
    rng = np.random.default_rng(p * 10 + q)
    x = rng.standard_normal((Z3_ROWS, Z3_IN)).astype(np.float32)
    w = rng.standard_normal((Z3_ROWS, Z3_OUT)).astype(np.float32)
    jlayer = TiledDense(features=Z3_OUT, in_splits=p, out_splits=q)
    params = jlayer.init(jax.random.PRNGKey(p + q), jnp.asarray(x))["params"]
    params = dict(params, bias=jnp.asarray(
        rng.standard_normal(Z3_OUT).astype(np.float32)))

    def jloss(prm):
        return (jlayer.apply({"params": prm}, jnp.asarray(x))
                * jnp.asarray(w)).sum()
    jl, jg = jax.value_and_grad(jloss)(params)
    state = {f"layer.{k}": v.numpy() for k, v in tiled_params_to_state_dict(
        jax.tree.map(np.asarray, params)).items()}
    runs = {}
    for tiles in (True, False):
        runs[tiles] = helpers.run_ranks(
            "torch_dist_helpers:tiled_zero3", 2, state=state, x=x, w=w,
            splits=splits, lr=Z3_LR, gather_tiles=tiles)
    tile_bytes = Z3_IN * Z3_OUT // (p * q) * 4
    for r, run in enumerate(runs[True]):
        assert run["tiled"], r
        # the forward gathers each tile once, one tile's bytes each, and
        # holds one at a time; the step adds the backward's gathers
        assert run["forward"] == (p * q, p * q * tile_bytes, 1), run
        assert run["step"] == (2 * p * q, 2 * p * q * tile_bytes, 1), run
    assert not any(run["tiled"] for run in runs[False])
    # each rank's loss is its rows' sum: the two add up to the JAX sum, and
    # the step's gradient is their mean, the JAX gradient / 2
    for r in range(2):
        np.testing.assert_allclose(runs[True][r]["loss"],
                                   runs[False][r]["loss"], rtol=1e-6)
    np.testing.assert_allclose(runs[True][0]["loss"] + runs[True][1]["loss"],
                               float(jl), rtol=1e-5)
    want = tiled_params_to_state_dict(jax.tree.map(
        lambda a, g: np.asarray(a) - Z3_LR * np.asarray(g) / 2, params, jg))
    for name in ("kernel", "bias"):
        got, whole = (runs[t][0]["state"][f"layer.{name}"]
                      for t in (True, False))
        np.testing.assert_array_equal(got, runs[True][1]["state"]
                                      [f"layer.{name}"])
        np.testing.assert_allclose(got, whole, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
        np.testing.assert_allclose(got, want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
