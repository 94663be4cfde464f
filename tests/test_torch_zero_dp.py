"""ZeRO-1 over data parallelism in the port against the TPU engine, on the
CPU, f32, the tiny GPT (torch_port_helpers.TINY), inputs from numpy seeds.

The port runs 2 gloo ranks × micro 4 (``torch_dist_helpers.run_ranks``);
the JAX engine is built as
``test_torch_training.test_engine_matches_jax_engine`` builds it (dp 8 × micro 1 on the virtual CPU mesh, gas 2, clipping,
AdamW, WarmupLR), so both take the same global micro-batches of 8 rows for
3 steps. Checked: losses and grad norms within that test's ``RTOL``; the
gathered Adam moments within its moment tolerances (rtol 1e-4, atol 1e-4 ×
the tree's largest magnitude), the gathered fp32 masters within the same
for all but 1% of the elements and within the peak lr for every one (Adam
moves an element whose gradient is f32 summation noise by up to lr a step
in either direction); stage 0 and stage 1
at dp 2 against each other and against dp 1; each rank holding
ceil(N / 2) elements of each moment; ``communication_data_type: bf16``
against the JAX engine with the same setting; the last step's
``loss_mask`` batches, whose two halves hold equal loss-token counts
(where the ranks' mean of token means is the global token mean)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_helpers as helpers
from test_torch_training import ENGINE_CONFIG, RTOL, _state_dict_np
from torch_port_helpers import model_pair
from torch_test_threads import one_torch_thread  # noqa: F401

GLOBAL_MICRO = 8                  # rows a micro-step: JAX dp 8 x 1, port 2 x 4
STEPS, GAS = 3, ENGINE_CONFIG["gradient_accumulation_steps"]
MOMENT_RTOL = 1e-4
# bf16 grads on the wire: each rank's sum is rounded to bf16 (2^-8
# relative) before the reduction, and the JAX engine rounds per device
# (1 row) where the port rounds per rank (4 rows)
BF16_LOSS_RTOL, BF16_NORM_RTOL = 1e-3, 2e-2


def _micros():
    """The global micro-batches; the last step's carry a ``loss_mask``
    whose two halves (the two ranks' rows) hold equal loss-token counts:
    rows 4-7 hold rows 0-3's masks, shuffled."""
    micros = [{"input_ids": helpers.ids(12 + i, GLOBAL_MICRO)}
              for i in range(STEPS * GAS)]
    rng = np.random.default_rng(5)
    for m in micros[-GAS:]:
        half = rng.random((GLOBAL_MICRO // 2, 32)) > 0.3
        m["loss_mask"] = np.concatenate(
            [half, half[rng.permutation(GLOBAL_MICRO // 2)]]
        ).astype(np.float32)
    return micros


CASES = {"f32": {}, "bf16comm": {"communication_data_type": "bf16"}}


@functools.lru_cache(None)
def _pair():
    jmodel, params, pmodel = model_pair(seed=13)
    state = {k: v.detach().numpy().copy()
             for k, v in pmodel.state_dict().items()}
    return jmodel, params, pmodel.cfg, state


@functools.lru_cache(None)
def _jax(case):
    import deepspeed_tpu as ds
    from deepspeed_tpu.models.gpt import lm_loss_fn
    jmodel, params, pcfg, _ = _pair()
    eng, *_ = ds.initialize(
        model=jmodel, model_parameters=params, loss_fn=lm_loss_fn,
        config=dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=1,
                    **CASES[case]))
    assert eng.dp_world_size == GLOBAL_MICRO
    micros = _micros()
    losses, norms = [], []
    for step in range(STEPS):
        batch = [{k: jnp.asarray(v) for k, v in m.items()}
                 for m in micros[GAS * step:GAS * (step + 1)]]
        losses.append(float(eng.train_batch(iter(batch))))
        norms.append(float(eng.get_global_grad_norm()))
    opt = eng.state["opt"]
    return {"losses": losses, "norms": norms,
            "master": _state_dict_np(eng.state["master"], pcfg),
            "mu": _state_dict_np(opt.mu, pcfg),
            "nu": _state_dict_np(opt.nu, pcfg),
            "samples": eng.global_samples}


def _config(stage=1, micro=GLOBAL_MICRO // 2, **extra):
    return dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=micro,
                zero_optimization={"stage": stage}, **extra)


@functools.lru_cache(None)
def _port():
    """Both ranks' results of every case, from one start of 2 ranks."""
    state = _pair()[3]
    cases = {name: dict(state=state, config=_config(**extra),
                        micros=_micros(), steps=STEPS)
             for name, extra in CASES.items()}
    cases["stage0"] = dict(state=state, config=_config(stage=0),
                           micros=_micros(), steps=STEPS)
    return helpers.run_ranks("torch_dist_helpers:train_cases", 2, cases=cases)


def _close_tree(got, want, rtol=MOMENT_RTOL):
    scale = max(np.abs(v).max() for v in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=rtol,
                                   atol=rtol * scale, err_msg=name)


def test_dp2_losses_and_grad_norms_match_jax():
    want = _jax("f32")
    for got in (r["f32"] for r in _port()):
        assert got["dp"] == 2
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=RTOL)
        assert got["samples"] == want["samples"] == 48


def test_dp2_gathered_masters_and_moments_match_jax():
    want = _jax("f32")
    for got in (r["f32"] for r in _port()):
        helpers.close_masters(got["master"], want["master"])
        assert got["opt"]["count"] == STEPS
        for m in ("mu", "nu"):
            _close_tree({k.split("/", 1)[1]: v for k, v in got["opt"].items()
                         if k.startswith(m + "/")}, want[m])


def test_dp2_stage0_stage1_and_dp1_agree():
    one = helpers.train_ranks(0, 1, _pair()[3], _config(micro=GLOBAL_MICRO),
                              _micros(), STEPS)
    r0, r1 = _port()
    for a in (r0, r1):
        s0, s1 = a["stage0"], a["f32"]
        # stage 0 steps the whole leaves, stage 1 their slices: the same
        # elementwise update on the same reduced grads
        np.testing.assert_allclose(s0["losses"], s1["losses"], rtol=1e-6)
        np.testing.assert_allclose(s0["norms"], s1["norms"], rtol=1e-6)
        _close_tree(s0["master"], s1["master"], rtol=1e-6)
        np.testing.assert_allclose(s1["losses"], one["losses"], rtol=RTOL)
        np.testing.assert_allclose(s1["norms"], one["norms"], rtol=RTOL)
        helpers.close_masters(s1["master"], one["master"])
    # the replicated and the gathered states are the same on both ranks
    for case in ("stage0", "f32"):
        for k, v in r0[case]["master"].items():
            np.testing.assert_array_equal(v, r1[case]["master"][k])


def test_dp2_each_rank_holds_half_of_each_moment():
    numels = [v.size for v in _pair()[3].values()]
    for r in _port():
        for m in ("mu", "nu"):
            assert r["f32"]["held"][m] == [math.ceil(n / 2) for n in numels]
            assert r["stage0"]["held"][m] == numels


def test_dp2_bf16_communication_matches_jax():
    want = _jax("bf16comm")
    for got in (r["bf16comm"] for r in _port()):
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=BF16_LOSS_RTOL)
        np.testing.assert_allclose(got["norms"], want["norms"],
                                   rtol=BF16_NORM_RTOL)
        # the first step's loss comes before any update: equal as in f32
        np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                                   rtol=RTOL)


def test_dp2_equal_count_loss_mask_matches_jax():
    """The f32 run's last step is the masked one."""
    assert all("loss_mask" in m for m in _micros()[-GAS:])
    want = _jax("f32")
    for got in (r["f32"] for r in _port()):
        np.testing.assert_allclose(got["losses"][-1], want["losses"][-1],
                                   rtol=RTOL)
        np.testing.assert_allclose(got["norms"][-1], want["norms"][-1],
                                   rtol=RTOL)
    # the mask changed the loss: the unmasked mean of the same rows differs
    unmasked = helpers.train_ranks(
        0, 1, _pair()[3], _config(micro=GLOBAL_MICRO),
        [{"input_ids": m["input_ids"]} for m in _micros()], STEPS)
    assert abs(unmasked["losses"][-1] - want["losses"][-1]) > 1e3 * RTOL


@pytest.mark.parametrize("shape", [(7, 5), (5,), (3, 2, 4), (1,), ()])
@pytest.mark.parametrize("dp", [1, 2, 3])
def test_leaf_shards_partition_and_gather(shape, dp):
    """Each rank's slice of a flattened leaf, padded with zeros; the
    slices cover the leaf once, and unpad of their concatenation is it."""
    import torch
    from deepspeed_tpu_torch.runtime.sharding import ShardingRules
    full = torch.arange(math.prod(shape), dtype=torch.float32
                        ).reshape(shape) + 1
    shards = [ShardingRules(dp, 1, r).master_spec("w", shape)
              for r in range(dp)]
    parts = [s.take(full) for s in shards]
    per = -(-full.numel() // dp)
    assert [s.offset for s in shards] == [r * per for r in range(dp)]
    assert all(p.numel() == per and s.padded == per * dp
               for p, s in zip(parts, shards))
    torch.testing.assert_close(shards[0].unpad(torch.cat(parts)), full,
                               rtol=0, atol=0)
    assert float(torch.cat(parts).sum()) == float(full.sum())
    whole = ShardingRules(dp, 0, dp - 1).master_spec("w", shape)
    grad = ShardingRules(dp, 1, dp - 1).grad_spec("w", shape)
    for s in (whole, grad):
        assert (s.offset, s.numel) == (0, full.numel())
