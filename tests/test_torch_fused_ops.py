"""The port's fused ops (LayerNorm B6, bias-GELU B7, softmax B8) against the
TPU package's, on the CPU: forwards and gradients from the same numpy
inputs and cotangents.

The JAX ops run as the TPU package's own tests run them: Pallas in
interpret mode where a row block >= 8 divides the row count, their XLA
expression where none does (N = 12). The port's wrappers run their plain
versions on a CPU tensor, and those hold the CUDA kernels' equations.

Tolerances: f32 forwards within 1e-5 and gradients within 1e-4 (absolute
and relative; summation order and rsqrt/tanh/exp rounding of the two
libraries). bf16 within one bf16 ulp of the reference (relative 2^-7):
both compute in f32 and round once to bf16, so they differ only where the
f32 values straddle a rounding boundary; plus, for values near zero, 1e-6
absolute on forwards and the f32 gradient tolerance (1e-4) on gradients,
where the f32 values themselves part: XLA's CPU tanh returns -1 exactly
from about -7.9 down, torch's does not, so the tanh-GELU derivative at
from torch_test_threads import one_torch_thread  # noqa: F401
x + bias = -4.9 is 0 in JAX and 6.4e-6 here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# With some CPU builds of torch the first torch.tanh of a process sends
# one worker thread's chunk through a less accurate path (errors up to
# 9e-5; every later call agrees with float64 to 3e-8). One throwaway call,
# large enough to run on every thread, takes it.
torch.tanh(torch.zeros(1 << 20))

F32_FWD, F32_GRAD = 1e-5, 1e-4
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-6

_JAX_DTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}


def _close(got, ref, dtype, grad=False):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    if dtype == "bf16":
        np.testing.assert_allclose(got, ref, rtol=BF16_RTOL,
                                   atol=F32_GRAD if grad else BF16_ATOL)
    else:
        tol = F32_GRAD if grad else F32_FWD
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def _pair(a, dtype, grad=True):
    """The same numpy array as a JAX array and a torch tensor of dtype."""
    j = jnp.asarray(a, jnp.float32).astype(_JAX_DTYPE[dtype])
    t = torch.from_numpy(np.asarray(a, np.float32)).to(_TORCH_DTYPE[dtype])
    return j, t.requires_grad_(grad)


def _vjp(jax_fn, torch_fn, j_args, t_args, j_w, t_w):
    """(jax out, jax grads, torch out, torch grads) of sum(f(args) * w)."""
    j_out, pull = jax.vjp(jax_fn, *j_args)
    j_grads = pull(j_w)
    t_out = torch_fn(*t_args)
    t_out.backward(t_w)
    return j_out, j_grads, t_out, [a.grad for a in t_args]


# --------------------------------------------------------------- LayerNorm

@pytest.mark.parametrize("dtype,param", [("f32", "f32"), ("bf16", "bf16"),
                                         ("bf16", "f32")])
@pytest.mark.parametrize("d", [32, 96, 1024, 1032])
@pytest.mark.parametrize("n", [64, 12])
def test_layer_norm_matches_jax(n, d, dtype, param):
    """d 1024 is the widest row the CUDA forward holds in one warp, 1032
    the narrowest it holds in a block."""
    from deepspeed_tpu.ops.pallas.layer_norm import layer_norm as jax_ln
    from deepspeed_tpu_torch.ops.transformer import layer_norm
    rng = np.random.default_rng(n * 100 + d)
    x = rng.normal(1.0, 2.0, (n // 4, 4, d))
    gamma = rng.normal(1.0, 0.3, d)
    beta = rng.normal(0.0, 0.3, d)
    w = rng.normal(size=x.shape)
    (jx, tx), (jg, tg), (jb, tb) = (_pair(x, dtype), _pair(gamma, param),
                                    _pair(beta, param))
    jw, tw = _pair(w, dtype, grad=False)
    j_out, j_grads, t_out, t_grads = _vjp(
        lambda a, g, b: jax_ln(a, g, b, 1e-5),
        lambda a, g, b: layer_norm(a, g, b, 1e-5),
        (jx, jg, jb), (tx, tg, tb), jw, tw)
    assert t_out.dtype == tx.dtype
    _close(t_out, j_out, dtype)
    for got, ref, dt in zip(t_grads, j_grads, (dtype, param, param)):
        assert got.dtype == _TORCH_DTYPE[dt]
        _close(got, ref, dt, grad=True)


def test_layer_norm_saves_f32_statistics():
    from deepspeed_tpu_torch.ops.cuda.layer_norm import layer_norm_forward
    x = torch.randn(8, 16).bfloat16()
    y, mean, rstd = layer_norm_forward(x, torch.ones(16), torch.zeros(16),
                                       1e-5)
    assert y.dtype == torch.bfloat16
    assert mean.dtype == rstd.dtype == torch.float32
    assert mean.shape == rstd.shape == (8,)


# --------------------------------------------------------------- bias-GELU

@pytest.mark.parametrize("n,dtype", [(64, "f32"), (64, "bf16"), (12, "f32")])
@pytest.mark.parametrize("with_bias", [True, False])
def test_bias_gelu_matches_jax(n, dtype, with_bias):
    from deepspeed_tpu.ops.pallas.gelu import bias_gelu as jax_bg
    from deepspeed_tpu.ops.pallas.gelu import gelu as jax_gelu
    from deepspeed_tpu_torch.ops.transformer import bias_gelu, gelu
    d = 96
    rng = np.random.default_rng(n + with_bias)
    x = rng.normal(0.0, 2.0, (n // 4, 4, d))
    bias = rng.normal(0.0, 0.5, d)
    w = rng.normal(size=x.shape)
    (jx, tx), (jb, tb) = _pair(x, dtype), _pair(bias, dtype)
    jw, tw = _pair(w, dtype, grad=False)
    if with_bias:
        j_out, j_grads, t_out, t_grads = _vjp(jax_bg, bias_gelu, (jx, jb),
                                              (tx, tb), jw, tw)
    else:
        j_out, j_grads, t_out, t_grads = _vjp(jax_gelu, gelu, (jx,), (tx,),
                                              jw, tw)
    assert t_out.dtype == tx.dtype
    _close(t_out, j_out, dtype)
    for got, ref in zip(t_grads, j_grads):
        _close(got, ref, dtype, grad=True)


# ----------------------------------------------------------------- softmax

SOFTMAX_SHAPES = {
    "square": (2, 4, 16, 16),       # N = 128
    "non_square": (2, 3, 8, 24),    # N = 48, Sq = 8 < S: top-left causal
    "untileable": (3, 4, 4),        # N = 12: the JAX op's XLA expression
    # the CUDA forward's path edges: S 1024, the widest row one warp holds,
    # and 1025, the narrowest a block holds (no whole 16-byte pack)
    "wide_square": (1, 1024, 1024),       # N = 1024
    "wide_non_square": (2, 8, 1024),      # N = 16
    "ragged_non_square": (2, 8, 1025),    # N = 16
    "ragged_square": (1025, 1025),        # N = 1025: XLA
}


# bf16 only where the JAX op runs its Pallas kernel: its XLA expression
# (the untileable N) rounds its softmax to bf16 in another place
@pytest.mark.parametrize("shape,dtype", [("square", "f32"),
                                         ("square", "bf16"),
                                         ("non_square", "f32"),
                                         ("non_square", "bf16"),
                                         ("untileable", "f32"),
                                         ("wide_square", "f32"),
                                         ("wide_square", "bf16"),
                                         ("wide_non_square", "f32"),
                                         ("wide_non_square", "bf16"),
                                         ("ragged_non_square", "f32"),
                                         ("ragged_non_square", "bf16"),
                                         ("ragged_square", "f32")])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_softmax_matches_jax(shape, causal, dtype):
    from deepspeed_tpu.ops.pallas.softmax import fused_softmax as jax_sm
    from deepspeed_tpu_torch.ops.transformer import fused_softmax
    rng = np.random.default_rng(len(shape) + 10 * causal)
    x = rng.normal(0.0, 3.0, SOFTMAX_SHAPES[shape])
    w = rng.normal(size=x.shape)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype, grad=False)
    j_out, j_grads, t_out, t_grads = _vjp(
        lambda a: jax_sm(a, causal), lambda a: fused_softmax(a, causal),
        (jx,), (tx,), jw, tw)
    assert t_out.dtype == tx.dtype
    _close(t_out, j_out, dtype)
    _close(t_grads[0], j_grads[0], dtype, grad=True)
    if causal:
        sq, s = x.shape[-2:]
        above = np.arange(s)[None, :] > np.arange(sq)[:, None]
        above = torch.from_numpy(above)
        assert float((t_out.detach().float() * above).abs().max()) == 0.0


@pytest.mark.parametrize("causal", [False, True])
def test_masked_softmax_matches_jax(causal):
    from deepspeed_tpu.ops.pallas.softmax import masked_softmax as jax_msm
    from deepspeed_tpu_torch.ops.transformer import masked_softmax
    rng = np.random.default_rng(7 + causal)
    x = rng.normal(0.0, 3.0, (2, 4, 16, 16))
    mask = np.where(rng.random((2, 1, 1, 16)) < 0.25, -10000.0, 0.0)
    w = rng.normal(size=x.shape)
    jx, tx = _pair(x, "f32")
    jw, tw = _pair(w, "f32", grad=False)
    jm, tm = _pair(mask, "f32", grad=False)
    j_out, j_grads, t_out, t_grads = _vjp(
        lambda a: jax_msm(a, jm, causal=causal, scale=0.125),
        lambda a: masked_softmax(a, tm, causal=causal, scale=0.125),
        (jx,), (tx,), jw, tw)
    _close(t_out, j_out, "f32")
    _close(t_grads[0], j_grads[0], "f32", grad=True)


# ------------------------------------------------------------------- misc

def test_stochastic_round_bf16_properties():
    """The TPU package's draws cannot be matched bit for bit; the port's
    keep their properties: x truncated to bf16 or one bf16 ulp away from
    zero, the same bits for the same generator state and others for
    another, unbiased where the deterministic cast is not, non-finite
    values cast deterministically."""
    from deepspeed_tpu_torch.ops.quantizer import stochastic_round_bf16
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32))
    a = stochastic_round_bf16(x, torch.Generator().manual_seed(1))
    a2 = stochastic_round_bf16(x, torch.Generator().manual_seed(1))
    b = stochastic_round_bf16(x, torch.Generator().manual_seed(2))
    assert a.dtype == torch.bfloat16
    assert torch.equal(a.view(torch.int16), a2.view(torch.int16))
    assert not torch.equal(a, b)
    trunc = (x.view(torch.int32) & -65536).view(torch.float32)
    away = (trunc.view(torch.int32) + 65536).view(torch.float32)
    got = a.float()
    assert bool(((got == trunc) | (got == away)).all())
    # a quarter ulp above 1: rounds up a quarter of the time (the mean's
    # standard error over 20000 draws is 2.4e-5); nearest rounding gives 1
    q = torch.full((20000,), 1.0 + 2.0 ** -9)
    mean = stochastic_round_bf16(q, torch.Generator().manual_seed(3)
                                 ).double().mean().item()
    assert abs(mean - (1.0 + 2.0 ** -9)) < 2e-4
    assert q.bfloat16().double().mean().item() == 1.0
    nf = stochastic_round_bf16(
        torch.tensor([float("inf"), float("-inf"), float("nan")]),
        torch.Generator().manual_seed(4)).float()
    assert nf[0] == float("inf") and nf[1] == float("-inf")
    assert bool(torch.isnan(nf[2]))
