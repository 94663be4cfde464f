"""ZeRO-Offload and ZeRO-Infinity in the port (deepspeed_tpu_torch/runtime/
zero/offload.py and the engine's offload path) against the TPU engine's
offload path and against the port's own dense engine, on the CPU, f32, the
tiny GPT, inputs from numpy seeds.

The port runs in fresh rank processes (``torch_dist_helpers.run_ranks``,
one torch thread each, so two runs of the same arithmetic are bitwise
alike): micro 8 at dp 1, micro 4 at dp 2. The JAX engine runs dp 8 x micro
1 on the virtual CPU mesh with the same offload block, as
tests/test_torch_zero_stages.py builds it; both over the same global
micro-batches for 3 steps with clipping. Checked: losses and grad norms
within ``RTOL``, masters through ``close_masters``, moments within rtol
1e-4, for the cpu and nvme tiers (``tmp_path``); the nvme tier and the
param tiers (offload_param cpu / nvme) bitwise the cpu tier; without a
schedule, offload against the port's dense stage-1 engine (the TPU offload
path reads the schedule at the step count before the step, its dense path
after, and the port keeps each); at dp 2 each rank's host state is half
and the losses are dp 1's within RTOL; a checkpoint saved at step 2 and
loaded into a fresh engine gives bitwise the uninterrupted losses, and the
dropped zero_to_fp32.py rebuilds its weights; a meta-device model trains
under offload from the counter-based fill, and the dense path refuses it."""

import functools
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as helpers
from test_torch_training import ENGINE_CONFIG, RTOL, _state_dict_np
from test_torch_zero_dp import GLOBAL_MICRO, GAS, MOMENT_RTOL, STEPS, \
    _close_tree, _micros
from torch_port_helpers import model_pair
from torch_test_threads import one_torch_thread  # noqa: F401


def _zero(device, stage=2, nvme=None, param=None):
    z = {"stage": stage, "offload_optimizer": {"device": device}}
    if nvme:
        z["offload_optimizer"]["nvme_path"] = nvme
    if param:
        z["offload_param"] = {"device": param}
        if param == "nvme":
            z["offload_param"]["nvme_path"] = os.path.join(nvme, "params")
    return z


@functools.lru_cache(None)
def _pair():
    jmodel, params, pmodel = model_pair(seed=19)
    state = {k: v.detach().numpy().copy()
             for k, v in pmodel.state_dict().items()}
    return jmodel, params, pmodel.cfg, state


def _jax(zero):
    import deepspeed_tpu as ds
    from deepspeed_tpu.models.gpt import lm_loss_fn
    jmodel, params, pcfg, _ = _pair()
    eng, *_ = ds.initialize(
        model=jmodel, model_parameters=params, loss_fn=lm_loss_fn,
        config=dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=1,
                    zero_optimization=zero))
    assert eng.dp_world_size == GLOBAL_MICRO and eng.offload_enabled
    losses, norms = [], []
    micros = _micros()
    for step in range(STEPS):
        batch = [{k: jnp.asarray(v) for k, v in m.items()}
                 for m in micros[GAS * step:GAS * (step + 1)]]
        losses.append(float(eng.train_batch(iter(batch))))
        norms.append(float(eng.get_global_grad_norm()))
    opt = eng.host_optimizer.opt_state_tree()
    return {"losses": losses, "norms": norms,
            "master": _state_dict_np(eng.host_optimizer.master_tree(), pcfg),
            "exp_avg": _state_dict_np(opt["exp_avg"], pcfg),
            "exp_avg_sq": _state_dict_np(opt["exp_avg_sq"], pcfg)}


def _config(zero, dp=1, **extra):
    return dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=(
        GLOBAL_MICRO // dp), zero_optimization=zero, **extra)


NO_SCHEDULE = {k: v for k, v in ENGINE_CONFIG.items() if k != "scheduler"}


@pytest.fixture(scope="module")
def nvme_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("nvme"))


@pytest.fixture(scope="module")
def dp1(nvme_root):
    """Every dp-1 case from one start of one rank."""
    state = _pair()[3]
    run = dict(state=state, micros=_micros(), steps=STEPS)
    cases = {
        "cpu": _config(_zero("cpu")),
        "nvme": _config(_zero("nvme", nvme=os.path.join(nvme_root, "a"))),
        "param_cpu": _config(_zero("cpu", stage=3, param="cpu")),
        "param_nvme": _config(_zero("nvme", stage=3, nvme=os.path.join(
            nvme_root, "b"), param="nvme")),
        "cpu_flat": dict(NO_SCHEDULE, train_micro_batch_size_per_gpu=8,
                         zero_optimization=_zero("cpu")),
        "dense_flat": dict(NO_SCHEDULE, train_micro_batch_size_per_gpu=8,
                           zero_optimization={"stage": 1}),
    }
    (out,) = helpers.run_ranks("torch_dist_helpers:zero_cases", 1, cases={
        name: dict(run, config=c) for name, c in cases.items()})
    return out


def _moments(got, m):
    return {k.split("/", 1)[1]: v for k, v in got["opt"].items()
            if k.startswith(m + "/")}


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_offload_matches_jax_offload(tier, dp1, nvme_root):
    want = _jax(_zero(tier, nvme=os.path.join(nvme_root, "jax")
                      if tier == "nvme" else None))
    got = dp1[tier]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=RTOL)
    helpers.close_masters(got["master"], want["master"])
    assert got["opt"]["count"] == STEPS
    for m in ("exp_avg", "exp_avg_sq"):
        _close_tree(_moments(got, m), want[m], rtol=MOMENT_RTOL)


def test_nvme_and_param_tiers_equal_the_cpu_tier_bitwise(dp1):
    cpu = dp1["cpu"]
    for tier in ("nvme", "param_cpu", "param_nvme"):
        got = dp1[tier]
        assert got["losses"] == cpu["losses"], tier
        assert got["norms"] == cpu["norms"], tier
        for k, v in cpu["master"].items():
            np.testing.assert_array_equal(got["master"][k], v, err_msg=k)
    # the nvme tiers really went through files: master+moments swapped,
    # and the param tier's mirrors too
    assert sum(dp1["nvme"]["aio_opens"].values()) > 0
    assert sum(dp1["param_nvme"]["aio_opens"].values()) > \
        sum(dp1["nvme"]["aio_opens"].values())
    assert "master_and_moments" in dp1["cpu"]["host_bytes"]
    assert "swap_slots" in dp1["nvme"]["host_bytes"]
    assert "mirror" not in dp1["param_nvme"]["host_bytes"]


def test_offload_matches_the_port_dense_engine(dp1):
    got, want = dp1["cpu_flat"], dp1["dense_flat"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=RTOL)
    helpers.close_masters(got["master"], want["master"])
    for m, d in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        _close_tree(_moments(got, m), _moments(want, d), rtol=MOMENT_RTOL)


def test_card_holds_params_and_grad_accumulator_only(dp1):
    """6 B a parameter at bf16 compute; 8 B in these f32 runs (4 B params
    + 4 B grads), 0 B of params between steps in the param tiers."""
    n = sum(v.size for v in _pair()[3].values())
    assert dp1["cpu"]["device_bytes"] == {"params": 4 * n, "grad_acc": 4 * n}
    for tier in ("param_cpu", "param_nvme"):
        assert dp1[tier]["device_bytes"] == {"params": 0, "grad_acc": 4 * n}


@pytest.mark.parametrize("stage", [2, 3])
def test_dp2_offload_holds_half_and_matches_dp1(stage, dp1):
    r0, r1 = helpers.run_ranks(
        "torch_dist_helpers:zero_cases", 2, cases={"off": dict(
            state=_pair()[3], micros=_micros(), steps=STEPS,
            config=_config(dict(_zero("cpu", stage=stage),
                                stage3_param_persistence_threshold=1000),
                           dp=2))})
    one = dp1["cpu"]
    numels = [v.size for v in _pair()[3].values()]
    for r in (r0["off"], r1["off"]):
        assert r["dp"] == 2
        assert r["host"] == [math.ceil(n / 2) for n in numels]
        assert r["acc"] == [math.ceil(n / 2) for n in numels]
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=RTOL)
        np.testing.assert_allclose(r["norms"], one["norms"], rtol=RTOL)
        helpers.close_masters(r["master"], one["master"])
    assert r0["off"]["losses"] == r1["off"]["losses"]


def test_offload_resume_is_bitwise_and_converts(tmp_path):
    """Host-shard files (the offload default) and the npz layout
    (``sharded_checkpoint: false``)."""
    config = dict(_config(_zero("nvme", nvme=str(tmp_path / "swap"))),
                  gradient_accumulation_steps=1)
    micros = [{"input_ids": helpers.ids(50 + i, GLOBAL_MICRO)}
              for i in range(4)]
    save = {"shards": str(tmp_path / "a"), "npz": str(tmp_path / "b")}
    (out,) = helpers.run_ranks("torch_dist_helpers:resume_cases", 1, cases={
        "shards": dict(config=config, micros=micros, save_dir=save["shards"]),
        "npz": dict(config=dict(config, sharded_checkpoint=False),
                    micros=micros, save_dir=save["npz"])})
    for name, layout in (("shards", "zero_host_shard_p0.npz"),
                         ("npz", "model_states.npz")):
        r = out[name]
        assert r["resumed"] == r["cont"] and r["steps"] == 4
        for k, v in r["saved"][0].items():
            np.testing.assert_array_equal(r["loaded"][0][k], v)
        for k, v in r["saved"][1].items():
            np.testing.assert_array_equal(r["loaded"][1][k], v)
        tag = os.path.join(save[name], "two")
        assert os.path.exists(os.path.join(tag, layout))
        fp32 = str(tmp_path / f"{name}.npz")
        subprocess.run([sys.executable, os.path.join(tag, "zero_to_fp32.py"),
                        save[name], fp32], check=True, capture_output=True,
                       env={"PATH": os.environ.get("PATH", "")})
        with np.load(fp32) as f:
            for k, v in r["saved"][0].items():
                np.testing.assert_array_equal(f[k], v)


def test_meta_model_trains_under_offload_and_the_dense_path_refuses():
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig, lm_loss_fn
    from deepspeed_tpu_torch.runtime.zero.partition_params import \
        abstract_init
    from torch_port_helpers import TINY
    config = dict(NO_SCHEDULE, train_micro_batch_size_per_gpu=8, seed=11,
                  zero_optimization=_zero("cpu", stage=3))
    micros = [_micros()[0]] * (GAS * STEPS)        # a repeated batch
    (out,) = helpers.run_ranks("torch_dist_helpers:zero_cases", 1, cases={
        "meta": dict(config=config, micros=micros, steps=STEPS,
                     abstract=True)})
    losses = out["meta"]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    model = abstract_init(GPT, GPTConfig(dtype=torch.float32, **TINY))
    with pytest.raises(ValueError, match="meta device"):
        dst.initialize(model=model, loss_fn=lm_loss_fn, device="cpu",
                       config=dict(config, zero_optimization={"stage": 3}))
