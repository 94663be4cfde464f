"""Expert parallelism in the port: GPT-MoE over the mesh's ``ep`` axis on
gloo ranks (``torch_dist_helpers.run_ranks``), on the CPU, f32, the tiny
GPT (``torch_dist_helpers.TINY``) with 4 experts.

  * four ranks at ep 2 × dp 2 train 3 steps (gas 2, clipping, AdamW,
    WarmupLR) on the same global micro-batches of 8 rows as the TPU engine
    at ``mesh {"ep": 2}`` (dp 4 × ep 2 on the 8 virtual CPU devices) at a
    capacity that drops nothing: losses and grad norms within rtol 2e-4,
    the gathered fp32 masters within ``close_masters``' bounds; and as the
    port at ep 1 × dp 4;
  * with drops (capacity factor 0.5: Random Token Selection draws top-1,
    Gumbel draws top-2) ep 2 × dp 2 against the port's own ep 1 × dp 4:
    the training gate draws over the dp group's whole token set from one
    seeded generator, so the routing is the same at every degree;
  * ZeRO stages 1 and 2 at ep 2 against stage 0; each rank holds half of
    every expert bank; LAMB at ep 2 against ep 1;
  * a checkpoint saved at ep 2 × dp 2 (the same files an ep-1 engine at dp
    2 writes) loads at ep 1 × dp 4 and trains on as the saving run does,
    and the standalone ``zero_to_fp32.py`` rebuilds its weights;
  * two ranks: ``InferenceEngine(ep_size=2)``'s forward logits and greedy
    tokens equal ep 1's with half the expert bytes a rank; a
    ``ServingEngine`` over it raises naming ROADMAP A9, and so do ZeRO-3
    and the offload tiers at ep 2; an ep that does not divide the experts
    is a ValueError.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_helpers as helpers
from test_torch_training import ENGINE_CONFIG, RTOL, _state_dict_np
from torch_port_helpers import model_pair
from torch_test_threads import one_torch_thread  # noqa: F401

MOE = dict(moe=True, num_experts=4)
NO_DROPS = dict(MOE, moe_capacity_factor=4.0)
DROPS = dict(MOE, moe_capacity_factor=0.5)
GLOBAL_MICRO, STEPS, GAS = 8, 3, ENGINE_CONFIG["gradient_accumulation_steps"]
# ep partners sum the same rows' grads in another grouping than dp ranks:
# f32 summation noise, as tests/test_moe.py holds ep degrees in JAX
EP_RTOL = 2e-4


def _micros(seed=20):
    return [{"input_ids": helpers.ids(seed + i, GLOBAL_MICRO)}
            for i in range(STEPS * GAS + 2 * GAS)]


LAMB = {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}}


def _config(ep, stage=1, **extra):
    dp = 4 // ep
    return {**ENGINE_CONFIG, "train_micro_batch_size_per_gpu":
            GLOBAL_MICRO // dp, "zero_optimization": {"stage": stage},
            "mesh": {"ep": ep} if ep > 1 else {}, **extra}


@functools.lru_cache(None)
def _pair():
    jmodel, params, pmodel = model_pair(seed=31, **NO_DROPS)
    state = {k: v.detach().numpy().copy()
             for k, v in pmodel.state_dict().items()}
    return jmodel, params, pmodel.cfg, state


def _model(**overrides):
    return dict(dtype="float32", **overrides)


def _port(tmp):
    state = _pair()[3]
    micros = _micros()
    run = dict(micros=micros, steps=STEPS, state=state)
    # LAMB: the first ep coordinate's experts 8x larger, so each ep rank's
    # share of an expert leaf has another norm than the whole leaf
    lamb_state = {k: np.concatenate([v[:2] * 8, v[2:]])
                  if ".experts." in k else v for k, v in state.items()}
    lamb_run = dict(run, state=lamb_state)
    cases = {
        "ep2": dict(config=_config(2), model=_model(**NO_DROPS), **run),
        "ep1": dict(config=_config(1), model=_model(**NO_DROPS), **run),
        "ep2_stage0": dict(config=_config(2, 0), model=_model(**NO_DROPS),
                           **run),
        "ep2_stage2": dict(config=_config(2, 2), model=_model(**NO_DROPS),
                           **run),
        "ep2_rts": dict(config=_config(2), model=_model(**DROPS), **run),
        "ep1_rts": dict(config=_config(1), model=_model(**DROPS), **run),
        "ep2_top2": dict(config=_config(2), model=_model(moe_top_k=2,
                                                         **DROPS), **run),
        "ep1_top2": dict(config=_config(1), model=_model(moe_top_k=2,
                                                         **DROPS), **run),
        "ep2_lamb": dict(config=_config(2, optimizer=LAMB),
                         model=_model(**NO_DROPS), **lamb_run),
        "ep1_lamb": dict(config=_config(1, optimizer=LAMB),
                         model=_model(**NO_DROPS), **lamb_run),
        # save after 3 steps at ep 2 x dp 2 (host-sharded files), then 2
        # more steps there from the save; the ep 1 x dp 4 engine loads the
        # save and trains the same 2
        "save": dict(config=_config(2, sharded_checkpoint=True),
                     model=_model(**NO_DROPS), save_dir=tmp, **run),
        "cont": dict(config=_config(2), model=_model(**NO_DROPS),
                     micros=micros[STEPS * GAS:], steps=2, state=state,
                     load_dir=tmp),
        "load": dict(config=_config(1), model=_model(**NO_DROPS),
                     micros=micros[STEPS * GAS:], steps=2, state=state,
                     load_dir=tmp),
    }
    return helpers.run_ranks("torch_dist_helpers:moe_train_cases", 4,
                             timeout=420.0, cases=cases)


@pytest.fixture(scope="module")
def save_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("moe_ep_ckpt"))


@pytest.fixture(scope="module")
def port(save_dir):
    return _port(save_dir)


@functools.lru_cache(None)
def _jax():
    import deepspeed_tpu as ds
    from deepspeed_tpu.models.gpt import lm_loss_fn
    from deepspeed_tpu.parallel import mesh as mesh_lib
    jmodel, params, pcfg, _ = _pair()
    eng, *_ = ds.initialize(
        model=jmodel, model_parameters=params, loss_fn=lm_loss_fn,
        config=dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=2,
                    mesh={"ep": 2}))
    try:
        assert (eng.dp_world_size, eng.mesh.shape["ep"]) == (4, 2)
        micros = _micros()
        losses, norms = [], []
        for step in range(STEPS):
            batch = [{k: jnp.asarray(v) for k, v in m.items()}
                     for m in micros[GAS * step:GAS * (step + 1)]]
            losses.append(float(eng.train_batch(iter(batch))))
            norms.append(float(eng.get_global_grad_norm()))
        master = _state_dict_np(eng.state["master"], pcfg)
    finally:
        mesh_lib.reset_global_mesh()
    return {"losses": losses, "norms": norms, "master": master}


def test_ep2_matches_jax_ep_mesh_and_port_ep1(port):
    want = _jax()
    for r, got in enumerate(port):
        ep2, ep1 = got["ep2"], got["ep1"]
        assert (ep2["ep"], ep2["dp"], ep1["ep"], ep1["dp"]) == (2, 2, 1, 4)
        np.testing.assert_allclose(ep2["losses"], want["losses"],
                                   rtol=EP_RTOL)
        np.testing.assert_allclose(ep2["norms"], want["norms"], rtol=EP_RTOL)
        helpers.close_masters(ep2["master"], want["master"])
        np.testing.assert_allclose(ep2["losses"], ep1["losses"], rtol=RTOL)
        np.testing.assert_allclose(ep2["norms"], ep1["norms"], rtol=RTOL)
        helpers.close_masters(ep2["master"], ep1["master"])


@pytest.mark.parametrize("gating", ["rts", "top2", "lamb"])
def test_ep2_routes_drops_as_ep1(port, gating):
    """Top-1 with Random Token Selection and top-2 with Gumbel noise drop
    tokens at capacity factor 0.5; LAMB's trust ratios take each expert
    leaf's norm whole (its partial sums summed over ep)."""
    for got in port:
        a, b = got[f"ep2_{gating}"], got[f"ep1_{gating}"]
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=RTOL)
        np.testing.assert_allclose(a["norms"], b["norms"], rtol=RTOL)
        helpers.close_masters(a["master"], b["master"])
    # the drops change the run: a capacity that keeps every token trains
    # otherwise
    assert not np.allclose(port[0]["ep1_rts"]["losses"],
                           port[0]["ep1"]["losses"], rtol=1e-6)


@pytest.mark.parametrize("stage", [0, 2])
def test_zero_stages_at_ep2(port, stage):
    """Stage 0 and 2 at ep 2 train as stage 1 does; every rank holds half
    of each expert bank (its ep coordinate's two experts)."""
    for got in port:
        a, b = got[f"ep2_stage{stage}"], got["ep2"]
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=RTOL)
        helpers.close_masters(a["master"], b["master"])
        assert a["expert_bytes"] * 2 == got["ep1"]["expert_bytes"]
        for m in ("mu", "nu"):
            keys = [k for k in a["opt"] if k.startswith(m + "/")]
            for k in keys:           # moments gathered whole over ep
                assert a["opt"][k].shape == b["opt"][k].shape


def test_checkpoint_saved_at_ep2_loads_at_ep1(port, save_dir, tmp_path):
    """The ep 1 × dp 4 engine resumes the ep 2 × dp 2 save as the ep-2
    engine does; the save is one shard file a dp rank, as an ep-1 engine
    at dp 2 writes, and zero_to_fp32.py rebuilds the saved weights."""
    for r in port:
        assert r["save"]["ep"] == 2
        np.testing.assert_allclose(r["load"]["losses"], r["cont"]["losses"],
                                   rtol=RTOL)
        helpers.close_masters(r["load"]["master"], r["cont"]["master"])
    tag = open(os.path.join(save_dir, "latest")).read().strip()
    tag_dir = os.path.join(save_dir, tag)
    shards = sorted(f for f in os.listdir(tag_dir) if f.endswith(".npz"))
    assert shards == ["zero_host_shard_p0.npz", "zero_host_shard_p1.npz"]
    out = str(tmp_path / "fp32.npz")
    subprocess.run([sys.executable, os.path.join(tag_dir, "zero_to_fp32.py"),
                    save_dir, out], check=True, capture_output=True)
    with np.load(out) as f:
        for name, want in port[0]["save"]["master"].items():
            np.testing.assert_array_equal(f[name], want)


@functools.lru_cache(None)
def _two_ranks():
    _, _, _, state = _pair()
    return helpers.run_ranks(
        "torch_dist_helpers:moe_two_ranks", 2,
        inference=dict(state=state, model=_model(
            **dict(MOE, moe_eval_capacity_factor=0.5)),
            prompts=helpers.ids(3, 3, seq=12), max_new=8, ep_sizes=(1, 2)),
        refusals=dict(state=state, model=_model(**MOE)))


def test_inference_ep2_matches_ep1_with_half_the_expert_bytes():
    for got in (r["inference"] for r in _two_ranks()):
        np.testing.assert_array_equal(got[2]["logits"], got[1]["logits"])
        np.testing.assert_array_equal(got[2]["tokens"], got[1]["tokens"])
        assert got[2]["expert_bytes"] * 2 == got[1]["expert_bytes"]
        assert got[2]["serving"].startswith("NotImplementedError")
        assert "ROADMAP A9" in got[2]["serving"]


@pytest.mark.parametrize("case", ["zero3", "offload", "ep_not_dividing"])
def test_ep2_refusals(case):
    """ZeRO-3 and the offload tiers at ep 2 raise naming ROADMAP A9 (queued
    MoE leftovers); an ep that does not divide the experts is a
    ValueError."""
    for got in (r["refusals"] for r in _two_ranks()):
        if case == "ep_not_dividing":
            assert got[case].startswith("ValueError") and \
                "divide" in got[case], got[case]
        else:
            assert got[case].startswith("NotImplementedError") and \
                "ROADMAP A9" in got[case], got[case]
