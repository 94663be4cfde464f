"""ZeRO stages 2 and 3 over data parallelism in the port against the TPU
engine at the same stage, on the CPU, f32, the tiny GPT
(torch_port_helpers.TINY), inputs from numpy seeds.

The port runs 2 gloo ranks x micro 4 (``torch_dist_helpers.run_ranks``,
one torch thread a rank); the JAX engine dp 8 x micro 1 on the virtual CPU
mesh, as tests/test_torch_zero_dp.py builds it (gas 2, clipping, AdamW,
WarmupLR), both over the same global micro-batches for 3 steps, with
``stage3_param_persistence_threshold`` 1000 so that the matrices and the
embeddings are partitioned and the biases and norms persist. Checked, with
that file's tolerances: losses and grad norms within ``RTOL``, masters
through ``close_masters``, moments within rtol 1e-4; each stage against the
port's stage 1 at dp 2; at stage 2 each rank's accumulator holds ceil(N/2)
elements of every leaf, at stage 3 each rank's compute parameters
ceil(N/2) of every leaf above the threshold and whole leaves below it;
stage 3 under remat (the gather inside the checkpointed block) equal to
stage 3 without, and no block's gathered weights held once its forward
is done (held by every later matmul's saved tensors without remat); stage 3 with ``communication_data_type: bf16`` against
the JAX engine with it (test_torch_zero_dp.py's bf16 tolerances); a stage-3 checkpoint saved at dp 2 resumes bitwise and
the dropped zero_to_fp32.py rebuilds its weights."""

import functools
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_helpers as helpers
from test_torch_training import ENGINE_CONFIG, RTOL, _state_dict_np
from test_torch_zero_dp import BF16_LOSS_RTOL, BF16_NORM_RTOL, \
    GLOBAL_MICRO, GAS, MOMENT_RTOL, STEPS, _close_tree, _micros
from torch_port_helpers import model_pair
from torch_test_threads import one_torch_thread  # noqa: F401

THRESHOLD = 1000


def _zero(stage):
    return {"stage": stage, "stage3_param_persistence_threshold": THRESHOLD}


@functools.lru_cache(None)
def _pair():
    jmodel, params, pmodel = model_pair(seed=17)
    state = {k: v.detach().numpy().copy()
             for k, v in pmodel.state_dict().items()}
    return jmodel, params, pmodel.cfg, state


@functools.lru_cache(None)
def _jax(stage, **extra):
    import deepspeed_tpu as ds
    from deepspeed_tpu.models.gpt import lm_loss_fn
    jmodel, params, pcfg, _ = _pair()
    eng, *_ = ds.initialize(
        model=jmodel, model_parameters=params, loss_fn=lm_loss_fn,
        config=dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=1,
                    zero_optimization=_zero(stage), **extra))
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
            "nu": _state_dict_np(opt.nu, pcfg)}


def _config(stage, **extra):
    return dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=GLOBAL_MICRO // 2,
                zero_optimization=_zero(stage), **extra)


@functools.lru_cache(None)
def _port():
    """Both ranks' results of every case, from one start of 2 ranks."""
    state = _pair()[3]
    run = dict(state=state, micros=_micros(), steps=STEPS)
    cases = {f"stage{s}": dict(run, config=_config(s)) for s in (1, 2, 3)}
    cases["stage3_remat"] = dict(run, config=_config(3), remat=True)
    cases["stage3_bf16comm"] = dict(run, config=_config(
        3, communication_data_type="bf16"))
    return helpers.run_ranks("torch_dist_helpers:zero_cases", 2,
                             cases=cases)


@pytest.mark.parametrize("stage", [2, 3])
def test_dp2_stage_matches_jax_at_that_stage(stage):
    want = _jax(stage)
    for got in (r[f"stage{stage}"] for r in _port()):
        assert got["dp"] == 2
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=RTOL)
        helpers.close_masters(got["master"], want["master"])
        assert got["opt"]["count"] == STEPS
        for m in ("mu", "nu"):
            _close_tree({k.split("/", 1)[1]: v for k, v in got["opt"].items()
                         if k.startswith(m + "/")}, want[m],
                        rtol=MOMENT_RTOL)


@pytest.mark.parametrize("stage", [2, 3])
def test_dp2_stage_matches_the_port_stage1(stage):
    r0, r1 = _port()
    for r in (r0, r1):
        got, one = r[f"stage{stage}"], r["stage1"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=RTOL)
        np.testing.assert_allclose(got["norms"], one["norms"], rtol=RTOL)
        helpers.close_masters(got["master"], one["master"])
    # the gathered states are the same on both ranks
    for k, v in r0[f"stage{stage}"]["master"].items():
        np.testing.assert_array_equal(v, r1[f"stage{stage}"]["master"][k])
    assert r0[f"stage{stage}"]["losses"] == r1[f"stage{stage}"]["losses"]


def test_dp2_what_each_rank_holds():
    numels = [v.size for v in _pair()[3].values()]
    half = [math.ceil(n / 2) for n in numels]
    for r in _port():
        assert r["stage1"]["acc"] == numels
        assert r["stage1"]["params"] == numels
        assert r["stage2"]["acc"] == half
        assert r["stage2"]["params"] == numels
        assert r["stage3"]["acc"] == half
        assert r["stage3"]["params"] == [
            h if n > THRESHOLD else n for n, h in zip(numels, half)]
        assert sum(n > THRESHOLD for n in numels) >= 2 * 4   # matrices
        assert any(n <= THRESHOLD for n in numels)            # persisted
        # stage 2 reduce-scatters what stage 1 all-reduced; stage 3 also
        # gathers every block's parameters in each micro-step's forward
        c1, c2, c3 = (r[f"stage{s}"]["comm"] for s in (1, 2, 3))
        assert c2["reduce_scatter"] == c1["all_reduce"]
        assert "all_reduce" not in c2
        assert c3["all_gather"] > c2["all_gather"]


def test_dp2_stage3_bf16_communication_matches_jax():
    """The units' grad reduce-scatters and the persisted leaves' one in
    bf16 (half the bytes), against the JAX engine with the same setting;
    test_torch_zero_dp.py's bf16 tolerances."""
    want = _jax(3, communication_data_type="bf16")
    for r in _port():
        got = r["stage3_bf16comm"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=BF16_LOSS_RTOL)
        np.testing.assert_allclose(got["norms"], want["norms"],
                                   rtol=BF16_NORM_RTOL)
        np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                                   rtol=RTOL)
        assert got["comm"]["reduce_scatter"] * 2 == \
            r["stage3"]["comm"]["reduce_scatter"]


def test_stage3_under_remat_equals_stage3():
    for r in _port():
        a, b = r["stage3_remat"], r["stage3"]
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=RTOL)
        np.testing.assert_allclose(a["norms"], b["norms"], rtol=RTOL)
        helpers.close_masters(a["master"], b["master"])


@functools.lru_cache(None)
def _lifetimes():
    return helpers.run_ranks("torch_dist_helpers:gather_lifetimes", 2,
                             config=_config(3), micros=_micros()[:GAS],
                             remats=(True, False))


@pytest.mark.parametrize("remat", [True, False])
def test_stage3_gathered_weights_die_with_their_block(remat):
    """Under remat the gather sits inside the checkpointed block: once a
    block's forward is done, no block's gathered weights are held. Without
    remat the matmuls' saved tensors hold every block's so far."""
    for r in _lifetimes():
        got = r[remat]
        blocks = got["blocks"]
        assert blocks == _pair()[2].num_layers
        # a gather a block and micro-step, and again in each recompute
        assert got["gathers"] == blocks * GAS * (2 if remat else 1)
        assert got["live"] == ([0] * blocks if remat
                               else list(range(1, blocks + 1)))


def test_stage3_holds_half_of_each_partitioned_compute_leaf():
    """bf16 compute: once built, a stage-3 rank holds ceil(N/2) elements
    of each partitioned compute leaf where a stage-2 rank holds all N, and
    nothing else differs (the whole copies are freed, not kept beside the
    shards)."""
    bf16 = {"bf16": {"enabled": True}}
    got = helpers.run_ranks("torch_dist_helpers:built_bytes", 2, configs={
        s: _config(s, **bf16) for s in (2, 3)})
    held = [v.size for v in _pair()[3].values() if v.size > THRESHOLD]
    saved = sum(n - math.ceil(n / 2) for n in held) * 2
    for r in got:
        assert r[2] - r[3] == saved


def test_stage3_checkpoint_resumes_bitwise_and_converts(tmp_path):
    config = dict(_config(3), gradient_accumulation_steps=1)
    micros = [{"input_ids": helpers.ids(40 + i, GLOBAL_MICRO)}
              for i in range(4)]
    save = str(tmp_path / "ckpt")
    r0, r1 = helpers.run_ranks("torch_dist_helpers:resume_cases", 2,
                               cases={"z3": dict(config=config,
                                                 micros=micros,
                                                 save_dir=save)})
    for r in (r0["z3"], r1["z3"]):
        assert r["resumed"] == r["cont"]
        assert r["steps"] == 4
        for k, v in r["saved"][0].items():
            np.testing.assert_array_equal(r["loaded"][0][k], v)
    tag = os.path.join(save, "two")
    assert sorted(f for f in os.listdir(tag) if f.endswith(".npz")) == [
        "zero_host_shard_p0.npz", "zero_host_shard_p1.npz"]
    out = str(tmp_path / "fp32.npz")
    subprocess.run([sys.executable, os.path.join(tag, "zero_to_fp32.py"),
                    save, out], check=True, capture_output=True,
                   env={"PATH": os.environ.get("PATH", "")})
    with np.load(out) as f:
        for k, v in r0["z3"]["saved"][0].items():
            np.testing.assert_array_equal(f[k], v)
