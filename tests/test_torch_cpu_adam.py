"""The port's native host optimizer (deepspeed_tpu_torch/ops/cpu_adam.py over
its own ops/cpu/csrc/cpu_adam.cpp) against the JAX package's
DeepSpeedCPUAdam / DeepSpeedCPUAdagrad and against a plain torch version,
on the same buffers (numpy seeds).

Both native libraries are built from the same source with the same flags
(the JAX package's builder flags, gated on the same CPU), so the steps are
compared bitwise: params, both moments and the bf16 mirror bits, over sizes
that exercise the 8-wide SIMD body and its scalar tail. The plain torch
version computes the same formula with the same f32 constants but without
the library's fused multiply-adds, so it is held within 4 f32 ulps (2^-21)
of each tensor's largest magnitude after 3 steps. A library that fails to build raises: shown by
pointing the builder at a broken copy of the source."""

import os
import shutil

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import cpu_adam as jax_cpu_adam
from deepspeed_tpu_torch.ops import cpu_adam
from deepspeed_tpu_torch.ops.cpu import _build
from torch_test_threads import one_torch_thread  # noqa: F401

SIZES = (1, 7, 8, 9, 4099)
PLAIN_RTOL = 2.0 ** -21          # 4 f32 ulps: FMA vs separate multiply-add
STEPS = 3


def _buffers(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    grads = [rng.standard_normal(n).astype(np.float32) for _ in range(STEPS)]
    return p, grads


def _plain_adam(p, g, m, v, lr, b1, b2, eps, wd, adamw, step):
    """The update of csrc/cpu_adam.cpp in plain torch, its constants
    computed in f32 as the library computes them (``1 - beta2^step`` in
    f32 is 1.3e-5 away from the f64 value at step 1)."""
    f = np.float32
    lr, b1, b2, eps, wd = f(lr), f(b1), f(b2), f(eps), f(wd)
    if wd:
        if adamw:
            p.mul_(float(f(1) - lr * wd))
        else:
            g = g + float(wd) * p
    m.mul_(float(b1)).add_(float(f(1) - b1) * g)
    v.mul_(float(b2)).add_(float(f(1) - b2) * g * g)
    step_size = lr / (f(1) - np.power(b1, f(step)))
    bc2_sqrt = np.sqrt(f(1) - np.power(b2, f(step)))
    p.sub_(float(step_size) * m / (v.sqrt() / float(bc2_sqrt) + float(eps)))


def _close_to_plain(got, want):
    """Within PLAIN_RTOL of the tensor's largest magnitude: an element that
    the update brought near zero keeps the absolute error of its operands."""
    torch.testing.assert_close(got, want, rtol=PLAIN_RTOL,
                               atol=PLAIN_RTOL * float(want.abs().max()))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("adamw,wd", [(True, 0.01), (False, 0.01),
                                      (True, 0.0)])
def test_adam_equals_jax_bitwise_and_plain_within_ulps(n, adamw, wd):
    p0, grads = _buffers(n, seed=n)
    kw = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd,
              adamw_mode=adamw)
    jopt = jax_cpu_adam.DeepSpeedCPUAdam(**kw)
    assert jopt.native
    popt = cpu_adam.DeepSpeedCPUAdam(**kw)
    jp, jm, jv = p0.copy(), np.zeros(n, np.float32), np.zeros(n, np.float32)
    jbits = np.zeros(n, np.uint16)
    tp = torch.from_numpy(p0.copy())
    tm, tv = torch.zeros(n), torch.zeros(n)
    mirror = torch.empty(n, dtype=torch.bfloat16)
    qp, qm, qv = tp.clone(), tm.clone(), tv.clone()
    for step, g in enumerate(grads, 1):
        jopt.step(jp, g, jm, jv, params_bf16=jbits)
        popt.step(tp, torch.from_numpy(g), tm, tv, params_bf16=mirror)
        _plain_adam(qp, torch.from_numpy(g), qm, qv, 1e-3, 0.9, 0.999, 1e-8,
                    wd, adamw, step)
    assert popt.step_count == STEPS
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(
        mirror.view(torch.int16).numpy().view(np.uint16), jbits)
    for got, want in ((tp, qp), (tm, qm), (tv, qv)):
        _close_to_plain(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_adagrad_equals_jax_bitwise_and_plain(n):
    p0, grads = _buffers(n, seed=100 + n)
    kw = dict(lr=1e-2, eps=1e-10, weight_decay=0.01)
    jopt = jax_cpu_adam.DeepSpeedCPUAdagrad(**kw)
    popt = cpu_adam.DeepSpeedCPUAdagrad(**kw)
    jp, jv = p0.copy(), np.zeros(n, np.float32)
    tp, tv = torch.from_numpy(p0.copy()), torch.zeros(n)
    qp, qv = tp.clone(), tv.clone()
    for g in grads:
        jopt.step(jp, g, jv)
        popt.step(tp, torch.from_numpy(g), tv)
        gg = torch.from_numpy(g) + float(np.float32(0.01)) * qp
        qv.add_(gg * gg)
        qp.sub_(float(np.float32(1e-2)) * gg
                / (qv.sqrt() + float(np.float32(1e-10))))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tv.numpy(), jv)
    _close_to_plain(tp, qp)


def test_bf16_bits_equal_jax_and_torch_rounding():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.standard_normal(5000).astype(np.float32) * 1e3,
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 3.0e38,
                  np.float32(1.00390625), np.float32(1.01171875)],
                 np.float32)])
    got = cpu_adam.f32_to_bf16_bits(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16),
        jax_cpu_adam.f32_to_bf16_bits(x))
    # finite values round as torch's own cast (both nearest even)
    assert torch.equal(got.view(torch.int16),
                       torch.from_numpy(x).to(torch.bfloat16)
                       .view(torch.int16))
    nan = np.array([np.nan], np.float32)
    np.testing.assert_array_equal(
        cpu_adam.f32_to_bf16_bits(torch.from_numpy(nan))
        .view(torch.int16).numpy().view(np.uint16),
        jax_cpu_adam.f32_to_bf16_bits(nan))


def test_one_openmp_runtime_and_checked_buffers():
    """The library shares torch's OpenMP runtime (one runtime file
    mapped) and runs as many threads as torch; bad buffers raise."""
    opt = cpu_adam.DeepSpeedCPUAdam()
    runtimes = _build.loaded_openmp_runtimes()
    assert runtimes == [os.path.realpath(_build.openmp_runtime())]
    assert cpu_adam.omp_threads() == torch.get_num_threads()
    p, m, v = torch.zeros(8), torch.zeros(8), torch.zeros(8)
    with pytest.raises(ValueError, match="grads"):
        opt.step(p, torch.zeros(8, dtype=torch.float64), m, v)
    with pytest.raises(ValueError, match="exp_avg"):
        opt.step(p, torch.zeros(8), torch.zeros(16)[::2], v)
    with pytest.raises(ValueError, match="params_bf16"):
        opt.step(p, torch.zeros(8), m, v, params_bf16=torch.zeros(8))


def test_a_broken_native_source_raises_in_the_offload_engine(
        tmp_path, monkeypatch):
    """No numpy stand-in: with the builder pointed at a copy of the
    sources whose cpu_adam.cpp does not compile, building the optimizer
    (and so the offload engine) raises the compiler's error."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    import torch_dist_helpers as helpers
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    with open(src / "cpu_adam.cpp", "a") as fh:
        fh.write("\nthis is not C++;\n")
    monkeypatch.setattr(_build, "CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native host"):
        cpu_adam.DeepSpeedCPUAdam()
    with pytest.raises(RuntimeError, match="not C"):
        dst.initialize(model=helpers.port_model(), loss_fn=lm_loss_fn,
                       device="cpu", config={
                           "train_micro_batch_size_per_gpu": 2,
                           "zero_optimization": {
                               "stage": 2,
                               "offload_optimizer": {"device": "cpu"}}})
    assert not list((tmp_path / "build").glob("*/libdstorch_cpu.so"))
