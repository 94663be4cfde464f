"""Checkpoints of the port's training engine on the CPU: the tiny GPT
(torch_port_helpers.TINY), inputs from numpy seeds, gas 2, clipping,
ZeRO-1, AdamW under WarmupLR.

  * resume: train 2 steps, save, train 2 more; a fresh engine (other random
    weights) loads and trains the same 2. Its losses are bitwise the
    uninterrupted ones, f32 and bf16 compute, at dp 1 (the npz layout) and
    at 2 gloo ranks (per-rank shard files), and the state it loaded is
    bitwise the state saved. Across a dp change (dp 2 -> dp 1 and back) the
    loaded state is bitwise the saved one; the next losses agree with the
    uninterrupted run within ``RTOL`` only, because one and two ranks sum
    the same gradients in another order;
  * ``load_module_only`` and ``load_optimizer_states=False`` restore what
    the JAX engine restores (weights, counters, schedule, loss scale; a
    fresh optimizer state);
  * ``latest`` and ``meta.json`` carry the JAX engine's keys;
  * the port's ``zero_to_fp32.py`` (dropped into each tag directory) and the
    JAX package's, each run as a script, rebuild from a port checkpoint of
    either layout the arrays ``consolidated_fp32_state_dict`` gives;
  * the JAX engine's ``model_states.npz`` after 2 steps, mapped through
    ``convert.py``, equals the port's after the same 2 steps within
    ``torch_dist_helpers.close_masters`` (an Adam step on two summation
    orders);
  * tag validation across ranks, the refusal of a client optimizer, and
    ``chip_smoke.py`` importing nothing of JAX.
"""

import ast
import functools
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_helpers as helpers
from test_torch_training import ENGINE_CONFIG, RTOL
from torch_port_helpers import model_pair
from torch_test_threads import one_torch_thread  # noqa: F401

REPO = helpers.REPO
GAS = ENGINE_CONFIG["gradient_accumulation_steps"]
DTYPES = ("float32", "bfloat16")


def _config(micro):
    return dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=micro)


def _micros():
    return [{"input_ids": helpers.ids(40 + i, 8)} for i in range(4 * GAS)]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpt")


@pytest.fixture(scope="module")
def dp1(root):
    """The resume gate at one rank, in this process, per compute dtype."""
    return {dt: helpers.resume_ranks(0, 1, _config(8), _micros(),
                                     str(root / f"dp1_{dt}"), dtype=dt)
            for dt in DTYPES}


@pytest.fixture(scope="module")
def dp2(root):
    """The resume gate at two ranks, per compute dtype, and tag validation,
    from one start of the ranks."""
    cases = {dt: dict(config=_config(4), micros=_micros(),
                      save_dir=str(root / f"dp2_{dt}"), dtype=dt)
             for dt in DTYPES}
    return helpers.run_ranks("torch_dist_helpers:resume_cases", 2,
                             cases=cases, tag_config=_config(4))


def _assert_state_equal(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_resume_is_bitwise_at_dp1(dp1, root, dtype):
    out = dp1[dtype]
    assert out["resumed"] == out["cont"], (out["resumed"], out["cont"])
    _assert_state_equal(out["loaded"], out["saved"])
    assert out["steps"] == 4
    tag_dir = root / f"dp1_{dtype}" / "two"
    assert (tag_dir / "model_states.npz").exists()
    assert not glob.glob(str(tag_dir / "zero_host_shard_p*"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_resume_is_bitwise_at_dp2(dp2, root, dtype):
    for out in dp2:
        out = out[dtype]
        assert out["resumed"] == out["cont"], (out["resumed"], out["cont"])
        _assert_state_equal(out["loaded"], out["saved"])
    # the two ranks saved one state and resumed the same run
    _assert_state_equal(dp2[0][dtype]["saved"], dp2[1][dtype]["saved"])
    assert dp2[0][dtype]["cont"] == dp2[1][dtype]["cont"]
    tag_dir = root / f"dp2_{dtype}" / "two"
    assert sorted(os.path.basename(p) for p in glob.glob(
        str(tag_dir / "zero_host_shard_p*"))) == [
        "zero_host_shard_p0.json", "zero_host_shard_p0.npz",
        "zero_host_shard_p1.json", "zero_host_shard_p1.npz"]
    assert not (tag_dir / "model_states.npz").exists()
    with open(tag_dir / "meta.json") as fh:
        assert json.load(fh)["format"] == "host_sharded"


def test_dp2_checkpoint_loads_at_dp1(dp2, root):
    want = dp2[0]["float32"]
    out = helpers.resume_ranks(0, 1, _config(8), _micros(), None,
                               load_dir=str(root / "dp2_float32"))
    _assert_state_equal(out["loaded"], want["saved"])
    np.testing.assert_allclose(out["resumed"], want["cont"], rtol=RTOL)
    assert out["steps"] == 4


def test_dp1_checkpoint_loads_at_dp2(dp1, root):
    want = dp1["float32"]
    ranks = helpers.run_ranks("torch_dist_helpers:resume_ranks", 2,
                              config=_config(4), micros=_micros(),
                              save_dir=None,
                              load_dir=str(root / "dp1_float32"))
    for out in ranks:
        _assert_state_equal(out["loaded"], want["saved"])
        np.testing.assert_allclose(out["resumed"], want["cont"], rtol=RTOL)


def test_tag_validation_across_ranks(dp2):
    for out in dp2:
        assert "differ across ranks" in out["tags_fail"]
        assert out["tags_warn"] == "passed"


# --------------------------------------------------------------------------
# Against the JAX engine
# --------------------------------------------------------------------------

@functools.lru_cache(None)
def _pair():
    return model_pair(seed=13)


@pytest.fixture(scope="module")
def jax_ckpt(root):
    """The JAX engine (dp 8 x micro 1) trained 2 steps and saved."""
    import deepspeed_tpu as ds
    from deepspeed_tpu.models.gpt import lm_loss_fn
    jmodel, params, _ = _pair()
    eng, *_ = ds.initialize(model=jmodel, model_parameters=params,
                            loss_fn=lm_loss_fn, config=_config(1))
    micros = _micros()
    for step in range(2):
        eng.train_batch(iter(micros[GAS * step:GAS * (step + 1)]))
    eng.save_checkpoint(str(root / "jax"), tag="two")
    return str(root / "jax")


@pytest.fixture(scope="module")
def port_ckpt(root):
    """The port (dp 1 x micro 8) from the same weights, the same 2 steps."""
    _, _, pmodel = _pair()
    state = {k: v.detach().numpy().copy()
             for k, v in pmodel.state_dict().items()}
    engine = helpers.port_engine(helpers.port_model(state), _config(8))
    helpers.train(engine, _micros(), 2, GAS)
    engine.save_checkpoint(str(root / "port"), tag="two")
    return str(root / "port"), state


def test_jax_model_states_through_convert_equal_the_ports(jax_ckpt,
                                                          port_ckpt):
    from deepspeed_tpu.checkpoint.saving import (load_tree_arrays,
                                                 unflatten_tree)
    from deepspeed_tpu_torch.convert import jax_params_to_state_dict
    jtree = unflatten_tree(load_tree_arrays(
        os.path.join(jax_ckpt, "two", "model_states.npz")))
    want = {k: v.numpy() for k, v in
            jax_params_to_state_dict(jtree, _pair()[2].cfg).items()}
    with np.load(os.path.join(port_ckpt[0], "two",
                              "model_states.npz")) as got:
        assert sorted(got.files) == sorted(want)
        helpers.close_masters({k: got[k] for k in got.files}, want)


def test_latest_and_meta_have_the_jax_keys(jax_ckpt, port_ckpt, root):
    port_dir = port_ckpt[0]
    for d in (jax_ckpt, port_dir):
        with open(os.path.join(d, "latest")) as fh:
            assert fh.read() == "two"
    metas = []
    for d in (jax_ckpt, port_dir, str(root / "dp2_float32")):
        with open(os.path.join(d, "two", "meta.json")) as fh:
            metas.append(json.load(fh))
    jmeta, pmeta, shard_meta = metas
    assert pmeta.keys() == jmeta.keys()
    assert shard_meta.keys() == jmeta.keys() | {"format"}
    for key in ("global_steps", "global_samples", "micro_steps",
                "skipped_steps", "loss_scale", "lr_scheduler", "zero_stage",
                "client_state", "curriculum", "quantizer"):
        assert pmeta[key] == jmeta[key], key
    assert (jmeta["dp_world_size"], pmeta["dp_world_size"],
            shard_meta["dp_world_size"]) == (8, 1, 2)


@pytest.fixture(scope="module")
def jax_fresh():
    """A fresh JAX engine to load into (load_checkpoint resets it)."""
    import deepspeed_tpu as ds
    from deepspeed_tpu.models.gpt import lm_loss_fn
    jmodel, params, _ = _pair()
    jeng, *_ = ds.initialize(model=jmodel, model_parameters=params,
                             loss_fn=lm_loss_fn, config=_config(1))
    return jeng


@pytest.mark.parametrize("flags", [{"load_module_only": True},
                                   {"load_optimizer_states": False}])
def test_partial_loads_restore_what_jax_restores(jax_ckpt, jax_fresh,
                                                 port_ckpt, flags):
    jeng = jax_fresh
    jeng.load_checkpoint(jax_ckpt, **flags)
    port_dir, state = port_ckpt
    peng = helpers.port_engine(helpers.port_model(state), _config(8))
    path, client = peng.load_checkpoint(port_dir, **flags)
    assert path == os.path.join(port_dir, "two") and client == {}
    for attr in ("global_steps", "global_samples", "micro_steps",
                 "skipped_steps", "loss_scale"):
        assert getattr(peng, attr) == getattr(jeng, attr), attr
    assert peng.lr_scheduler.state_dict() == jeng.lr_scheduler.state_dict()
    # the optimizer state is the fresh one in both
    assert peng.optimizer.count == int(jeng.state["opt"].count) == 0
    assert all(not m.any() for m in peng.optimizer.mu)
    with np.load(os.path.join(port_dir, "two", "model_states.npz")) as saved:
        for name, p in zip(peng._names, peng.master):
            np.testing.assert_array_equal(p.detach().numpy(), saved[name])


@pytest.mark.parametrize("layout", ["npz", "host_sharded"])
@pytest.mark.parametrize("script", ["port", "jax"])
def test_zero_to_fp32_scripts_rebuild_the_weights(dp1, dp2, root, layout,
                                                  script, tmp_path):
    src = root / ("dp1_float32" if layout == "npz" else "dp2_float32")
    want = (dp1["float32"] if layout == "npz"
            else dp2[0]["float32"])["saved"][0]
    path = (src / "two" / "zero_to_fp32.py" if script == "port" else
            os.path.join(REPO, "deepspeed_tpu", "checkpoint",
                         "zero_to_fp32.py"))
    out = tmp_path / "fp32.npz"
    res = subprocess.run([sys.executable, str(path), str(src), str(out)],
                         capture_output=True, text=True, timeout=60,
                         cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    with np.load(out) as got:
        assert sorted(got.files) == sorted(want)
        for name, w in want.items():
            assert got[name].dtype == np.float32
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    from deepspeed_tpu_torch.checkpoint import zero_to_fp32
    with open(src / "two" / "zero_to_fp32.py") as a, \
            open(zero_to_fp32.__file__) as b:
        assert a.read() == b.read()


def test_no_checkpoint_and_client_optimizer(tmp_path):
    import torch
    engine = helpers.port_engine(helpers.port_model(), _config(8))
    assert engine.load_checkpoint(str(tmp_path)) == (None, {})
    model = helpers.port_model()
    import deepspeed_tpu_torch as dst
    client, *_ = dst.initialize(
        model=model, optimizer=torch.optim.SGD(model.parameters(), 0.1),
        config={"train_batch_size": 8}, device="cpu")
    for call in (client.save_checkpoint, client.load_checkpoint):
        with pytest.raises(NotImplementedError, match="ROADMAP A13"):
            call(str(tmp_path))


def test_chip_smoke_imports_nothing_of_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "optax", "orbax",
                        "deepspeed_tpu"}, names
