"""Port sampling (deepspeed_tpu_torch/ops/cuda/sampling.py and
serving/sampling.py) against the TPU package's: the Pallas sampling kernel
in interpret mode and the sort-based reference. CPU tensors, so the port
runs its plain bisection. Top-k filtered logits and greedy draws must agree
bitwise; top-p kept sets must agree (the mass sums differ only in order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import sampling as jsp
from deepspeed_tpu.serving import sampling as jserve
from deepspeed_tpu_torch.ops.cuda import _build
from deepspeed_tpu_torch.ops.cuda import sampling as psp
from deepspeed_tpu_torch.serving import sampling as pserve

B, V = 4, 256


def _logits(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    x[0, 7] = x[0, 9] = x[0].max() + 1.0      # a tie at the top
    return x


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("top_k", [1, 8, 50])
def test_top_k_filter_bitwise(temperature, top_k):
    x = _logits(top_k)
    kern = np.asarray(jsp.threshold_filter_logits(jnp.asarray(x),
                                                  temperature, top_k))
    ref = np.asarray(jserve.filter_logits(jnp.asarray(x), temperature,
                                          top_k))
    plain = psp.threshold_filter_logits(torch.from_numpy(x), temperature,
                                        top_k).numpy()
    sort_based = pserve.filter_logits(torch.from_numpy(x), temperature,
                                      top_k).numpy()
    np.testing.assert_array_equal(plain, kern)
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(sort_based, ref)


@pytest.mark.parametrize("top_k,top_p", [(None, 0.5), (None, 0.9),
                                         (20, 0.8)])
def test_top_p_kept_sets_equal(top_k, top_p):
    x = _logits(int(top_p * 10))
    kern = np.asarray(jsp.threshold_filter_logits(jnp.asarray(x), 1.0,
                                                  top_k, top_p))
    ref = np.asarray(jserve.filter_logits(jnp.asarray(x), 1.0, top_k,
                                          top_p))
    plain = psp.threshold_filter_logits(torch.from_numpy(x), 1.0, top_k,
                                        top_p).numpy()
    sort_based = pserve.filter_logits(torch.from_numpy(x), 1.0, top_k,
                                      top_p).numpy()
    for other in (kern, ref, sort_based):
        np.testing.assert_array_equal(plain > -1e9, other > -1e9)
    kept = plain > -1e9
    np.testing.assert_array_equal(plain[kept], x[kept])


@pytest.mark.parametrize("top_k,top_p", [(None, None), (8, None),
                                         (None, 0.9), (8, 0.9)])
def test_draws_match_pallas_kernel(top_k, top_p):
    x = _logits(3)
    rng = np.random.default_rng(4)
    gumbel = rng.gumbel(size=(B, V)).astype(np.float32)
    greedy = np.asarray(jsp.fused_sample(jnp.asarray(x), None, 0.0, top_k,
                                         top_p))
    mine = psp.fused_sample(torch.from_numpy(x), None, 0.0, top_k,
                            top_p).numpy()
    np.testing.assert_array_equal(mine, greedy)
    assert mine[0] == 7                       # first index of a tie
    hot = np.asarray(jsp.fused_sample(jnp.asarray(x), jnp.asarray(gumbel),
                                      0.7, top_k, top_p))
    mine = psp.fused_sample(torch.from_numpy(x), torch.from_numpy(gumbel),
                            0.7, top_k, top_p).numpy()
    np.testing.assert_array_equal(mine, hot)


def test_router_and_reference_agree_greedy():
    x = torch.from_numpy(_logits(5))
    fused = pserve.fused_sample_tokens(x, None, 0.0, None)
    ref = pserve.sample_tokens(x, None, 0.0, None)
    np.testing.assert_array_equal(fused.numpy(), ref.numpy())
    jref = np.asarray(jserve.sample_tokens(jnp.asarray(x.numpy()), None,
                                           0.0, None))
    np.testing.assert_array_equal(fused.numpy(), jref)


def test_temperature_draws_stay_inside_the_filter():
    x = torch.from_numpy(_logits(6))
    gen = torch.Generator().manual_seed(0)
    kept = pserve.filter_logits(x, 0.8, 5) > -1e9
    for _ in range(5):
        tok = pserve.fused_sample_tokens(x, gen, 0.8, 5).long()
        assert kept[torch.arange(B), tok].all()


def test_supported_gate_and_unsupported_vocab_uses_reference():
    for b, v in ((1, 128), (8, 50304), (2, 100), (1, 512 * 1024)):
        assert psp.sampling_supported(b, v) == jsp.sampling_supported(b, v)
    x = torch.randn(2, 100)                   # not a multiple of 128
    before = _build.LAUNCHES["sampling"]
    np.testing.assert_array_equal(
        pserve.fused_sample_tokens(x, None, 0.0, None).numpy(),
        x.argmax(-1).numpy())
    assert _build.LAUNCHES["sampling"] == before


def test_order_key_is_monotonic():
    vals = torch.tensor([-1e10, -3.5, -1.0, -1e-30, -0.0, 0.0, 1e-30, 1.0,
                         2.0, 3e38])
    keys = psp.order_key(vals)
    assert torch.all(keys[1:] >= keys[:-1])
    jkeys = np.asarray(jsp._order_key(jnp.asarray(vals.numpy())))
    np.testing.assert_array_equal(keys.numpy(), jkeys)


def test_bad_arguments_raise():
    x = torch.randn(2, 128)
    with pytest.raises(ValueError):
        psp.fused_sample(x, None, 0.0, 0)
    with pytest.raises(ValueError):
        psp.fused_sample(x, None, 0.0, None, 0.0)
    with pytest.raises(ValueError):
        psp.fused_sample(x, None, 1.0, None)       # no gumbel noise
