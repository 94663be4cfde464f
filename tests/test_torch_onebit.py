"""The port's 1-bit optimizers (``deepspeed_tpu_torch.runtime.fp16.onebit``:
OneBitAdam, ZeroOneAdam, OneBitLamb) and their engine path against the TPU
package's, on the CPU, f32.

One start of two gloo ranks (``torch_dist_helpers.run_ranks``) runs every
multi-rank case of this file:

  * each optimizer's per-rank ``step`` over a mode sequence (OneBitAdam
    warmup x2, comp x3; OneBitLamb warmup past ``freeze_step``, comp x3;
    ZeroOneAdam dense, dense, grad_comp, sync, local, sync, the sequence of
    ``ZeroOnePolicy(2, 1, 1, 2)``) from the same numpy-seeded per-rank
    gradients. Each step is held to the JAX ``step`` under ``shard_map`` on
    a sub-mesh of the first two virtual CPU devices, given the port's
    params and state before that step: params and every state entry within
    ``STEP_RTOL`` relative and ``STEP_ATOL`` x the entry's largest
    magnitude (f32 in other orders: the port's norms accumulate in f64
    for the 1-bit scales and in ``_foreach_norm``'s order for LAMB's
    trust ratios), and the sign bits of every compressed quantity equal.
    OneBitLamb's first compressed step takes its scaling coefficients from
    the last warmup momentum, the same on both ranks, where the TPU package
    takes each rank's local momentum and its ranks' params part (ROADMAP
    §C): that step's JAX input carries the port's coefficients, which are
    checked against their formula on their own;
  * the engine (the tiny GPT of ``torch_port_helpers.model_pair``, weights
    carried over by ``convert.py``, eps 1e-4) for 5-6 steps that span
    each optimizer's modes, against the JAX engine in a child process
    whose ``XLA_FLAGS`` give it two devices (``torch_onebit_jax.py``). The
    runner lays its flat master out as the JAX runner does (its flax
    leaves in ``jax.tree.leaves`` order), so the 1-bit chunks, scales and
    OneBitLamb's per-leaf ratios cover the same elements. Losses and grad
    norms within ``RTOL`` through the first compressed update's loss,
    ``COMP_RTOL`` after it, masters through ``close_masters`` but for
    ``FLIPS`` elements (see ``EXACT_STEPS``). OneBitLamb is held to JAX up
    to its first compressed step's loss (the coefficients above part the
    two after it). The warmup of OneBitAdam equals the port's dense AdamW
    without bias correction (the TPU package's
    ``test_onebit_adam_warmup_matches_dense_adam``); on both ranks the
    losses and masters are equal, and after the first compressed step the
    worker errors differ (the gradients stay local);
  * a bitwise checkpoint round trip for each optimizer saved
    mid-compression (ZeroOneAdam saved and restored inside its local
    regime); fp16 at a static scale whose one overflowing step, on one rank
    only, is skipped on both and leaves every buffer as it was (ZeroOneAdam
    then runs the skipped mode again); the mesh refusals.

Refusals that need no ranks run in the test process.
"""

import functools
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_helpers as helpers
from test_torch_training import RTOL, _state_dict_np
from torch_port_helpers import TINY, model_pair
from torch_test_threads import one_torch_thread  # noqa: F401

from deepspeed_tpu.comm.compressed import padded_size
from deepspeed_tpu.runtime.fp16.onebit import ONEBIT_OPTIMIZERS as JAX_OPTS
from deepspeed_tpu.runtime.fp16.onebit.zoadam import \
    ZeroOnePolicy as JaxPolicy
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.runtime.fp16.onebit.zoadam import ZeroOnePolicy

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6

# ---- per-rank steps ----------------------------------------------------------
N = 1000
LEAVES = [(0, 300), (300, 700), (700, 1000)]
NPAD = padded_size(N, WORLD)
LR = 1e-2
ZO_KNOBS = dict(var_freeze_step=2, var_update_scaler=1, local_step_scaler=1,
                local_step_clipper=2)
CHAINS = {
    "onebitadam": (dict(freeze_step=2, weight_decay=0.01),
                   ["warmup"] * 2 + ["comp"] * 3),
    "onebitlamb": (dict(freeze_step=2, weight_decay=0.01),
                   ["warmup"] * 2 + ["comp"] * 3),
    "zerooneadam": (dict(weight_decay=0.01, **ZO_KNOBS),
                    ["dense", "dense", "grad_comp", "sync", "local",
                     "sync"]),
}
# the step before which the runner zeroes 0/1 Adam's error buffers
ZO_REINIT = 3


def _chain_inputs(kind):
    rng = np.random.default_rng(len(kind))
    steps = len(CHAINS[kind][1])
    grads = np.zeros((steps, WORLD, NPAD), np.float32)
    grads[..., :N] = rng.standard_normal((steps, WORLD, N))
    p0 = (0.5 * rng.standard_normal(N)).astype(np.float32)
    return p0, grads


# ---- the engine ----------------------------------------------------------------
EPS = 1e-4
MICRO, GAS, SEQ = 2, 2, 32             # rows a rank; the JAX engine's per device
ENGINE = {"train_micro_batch_size_per_gpu": MICRO,
          "gradient_accumulation_steps": GAS, "steps_per_print": 10 ** 6}


def _opt(kind, **params):
    return {"optimizer": {"type": kind, "params": dict(lr=2e-3, eps=EPS,
                                                       **params)}}


RUNS = {
    "adam": (dict(ENGINE, **_opt("OneBitAdam", freeze_step=2,
                                 weight_decay=0.01)), 5),
    "zeroone": (dict(ENGINE, **_opt("ZeroOneAdam", weight_decay=0.01,
                                    **ZO_KNOBS)), 6),
    "lamb": (dict(ENGINE, **_opt("OneBitLamb", freeze_step=2,
                                 weight_decay=0.01)), 4),
}
# the port's dense AdamW without bias correction, against OneBitAdam's
# warmup (freeze_step past the run)
WARMUP = {
    "onebit_warmup": (dict(ENGINE, **_opt("OneBitAdam", freeze_step=100,
                                          weight_decay=0.01)), 3),
    "dense_adamw": (dict(ENGINE, **_opt("AdamW", weight_decay=0.01,
                                        bias_correction=False)), 3),
}
# OneBitLamb is held to JAX up to its first compressed step's loss (the
# scaling coefficients part the two after it)
JAX_STEPS = {"adam": 5, "zeroone": 6, "lamb": 3}
# The steps held to RTOL: through the first compressed update's loss.
# After it the two packages' gradients, which differ by f32 summation
# order, can put a 1-bit sign that sits within rounding of zero on the
# other side: such an element moves by 2 lr s_scale / (sqrt(nu) + eps) the
# other way (eps 1e-4 bounds that, as a long warmup would). Later losses
# and grad norms are held to COMP_RTOL (the largest gap on these inputs:
# 1.1e-5), the masters allow FLIPS such elements (12 and 2 here).
EXACT_STEPS = {"adam": 3, "zeroone": 3, "lamb": 3}
COMP_RTOL = 1e-4
FLIPS = 32


def _micros(steps=7):
    return [{"input_ids": helpers.ids(40 + i, MICRO * WORLD, SEQ)}
            for i in range(steps * GAS)]


@functools.lru_cache(None)
def _pair():
    jmodel, params, pmodel = model_pair(seed=21)
    state = {k: v.detach().numpy().copy()
             for k, v in pmodel.state_dict().items()}
    return params, pmodel.cfg, state


RESUMES = {
    # saved after warmup x2 and one compressed step, then two more
    "adam": (RUNS["adam"][0], 3, 2),
    "lamb": (RUNS["lamb"][0], 3, 2),
    # saved after step 5 (a local step: delta is not zero), then sync, local
    "zeroone": (RUNS["zeroone"][0], 5, 2),
}
# fp16 at a static scale: (config, steps before the overflowing one, the
# mode the step after it runs). OneBitAdam overflows in its compressed
# phase; ZeroOneAdam at its grad_comp step, which it then runs again (its
# policy replayed to the applied count; the JAX runner's assertion fails
# there, ROADMAP §C)
_FP16 = {"enabled": True, "loss_scale": 128}
FP16 = {"adam": (dict(ENGINE, fp16=_FP16,
                      **_opt("OneBitAdam", freeze_step=1)), 2, "comp"),
        "zeroone": (dict(ENGINE, fp16=_FP16,
                         **_opt("ZeroOneAdam", **ZO_KNOBS)), 2,
                    "grad_comp")}


def _mesh_refusals():
    one = _opt("OneBitAdam")
    return {"tp": dict(ENGINE, mesh={"tp": 2}, **one),
            "ep": dict(ENGINE, mesh={"ep": 2}, **one)}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Every two-rank case in one start of the ranks, beside the JAX
    engines in their two-device child process."""
    params, _, state = _pair()
    child = _start_jax(tmp_path_factory.mktemp("jax"), params)
    chains = {}
    for kind, (kw, modes) in CHAINS.items():
        p0, grads = _chain_inputs(kind)
        chains[kind] = ("step_chain", dict(
            kind=kind, kwargs=kw, n=N, leaf_slices=LEAVES, p0=p0,
            grads=grads, modes=modes, lrs=[LR] * len(modes),
            reinit=(ZO_REINIT,) if kind == "zerooneadam" else ()))
    save = tmp_path_factory.mktemp("ckpt")
    calls = dict(chains)
    calls["engine"] = ("engine_runs", dict(state=state,
                                           runs=dict(RUNS, **WARMUP),
                                           micros=_micros()))
    calls["resume"] = ("resumes", dict(cases={
        name: dict(state=state, config=cfg, micros=_micros(), first=first,
                   then=then, save_dir=str(save / name))
        for name, (cfg, first, then) in RESUMES.items()}))
    calls["fp16"] = ("fp16_skips", dict(cases={
        name: dict(state=state, config=cfg, micros=_micros(),
                   before=before, overflow_rank=0)
        for name, (cfg, before, _) in FP16.items()}))
    calls["refusals"] = ("refusals", dict(state=state,
                                          configs=_mesh_refusals()))
    try:
        ranks = helpers.run_ranks("torch_onebit_helpers:cases", WORLD,
                                  timeout=420.0, calls=calls)
    finally:
        jax_runs = _finish_jax(*child)
    return ranks, jax_runs


def _start_jax(d, params):
    src, dst = d / "in.pkl", d / "out.pkl"
    with open(src, "wb") as fh:
        pickle.dump({"model": dict(TINY, remat=False),
                     "params": jax.tree.map(np.asarray, params),
                     "runs": {k: (cfg, JAX_STEPS[k])
                              for k, (cfg, _) in RUNS.items()},
                     "micros": _micros()}, fh)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=os.pathsep.join([os.path.dirname(TESTS),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "torch_onebit_jax.py"),
         str(src), str(dst)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, dst


def _finish_jax(proc, dst):
    try:
        out = proc.communicate(timeout=420)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-4000:]
    with open(dst, "rb") as fh:
        return pickle.load(fh)


# ------------------------------------------------------------------ policy

@pytest.mark.parametrize("knobs", [(2, 1, 1, 2), (10, 2, 4, 4), (4, 3, 2, 8),
                                   (100000, 16, 32678, 16), (0, 1, 1, 1)])
def test_zero_one_policy_equals_jax(knobs):
    mine, theirs = ZeroOnePolicy(*knobs), JaxPolicy(*knobs)
    for _ in range(60):
        assert mine.next() == theirs.next()
        assert vars(mine) == vars(theirs)


# ---------------------------------------------------------- per-rank steps

@functools.lru_cache(None)
def _jax_step(kind, mode, count):
    kw, _ = CHAINS[kind]
    opt = JAX_OPTS[kind](N, WORLD, LEAVES, **kw)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))

    def per(g, st, p):
        st = {k: v[0] for k, v in st.items()}
        new_p, st = opt.step(mode, g[0], st, p[0], LR, count, "dp")
        return new_p[None], {k: v[None] for k, v in st.items()}
    return jax.jit(shard_map(per, mesh=mesh, in_specs=(P("dp"),) * 3,
                             out_specs=(P("dp"), P("dp")), check_vma=False))


def _stack(ranks, kind, k, key):
    return np.stack([r[kind][k][key] for r in ranks])


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL,
                               atol=STEP_ATOL * scale, err_msg=what)


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_optimizer_steps_match_jax(two, kind):
    ranks, _ = two
    _, grads = _chain_inputs(kind)
    modes = CHAINS[kind][1]
    for k, mode in enumerate(modes):
        st_in = {a: np.stack([r[kind][k]["st_in"][a] for r in ranks])
                 for a in ranks[0][kind][k]["st_in"]}
        if kind == "onebitlamb" and mode == "comp":
            st_in["scaling"] = np.stack([r[kind][k]["st"]["scaling"]
                                         for r in ranks])
        p, st = _jax_step(kind, mode, k + 1)(
            jnp.asarray(grads[k]), {a: jnp.asarray(v) for a, v in
                                    st_in.items()},
            jnp.asarray(_stack(ranks, kind, k, "p_in")))
        for r in range(WORLD):
            got = ranks[r][kind][k]
            what = f"{kind} step {k + 1} ({mode}) rank {r}"
            _close(got["p"], np.asarray(p)[r], what + " params")
            for a, v in st.items():
                _close(got["st"][a], np.asarray(v)[r], f"{what} {a}")
            for a in ("mu", "worker_error", "server_error", "delta"):
                if a in got["st"]:
                    np.testing.assert_array_equal(
                        got["st"][a] >= 0, np.asarray(st[a])[r] >= 0,
                        err_msg=f"{what}: signs of {a}")
        # the master stays the same on both ranks
        np.testing.assert_array_equal(ranks[0][kind][k]["p"],
                                      ranks[1][kind][k]["p"])


def test_lamb_scaling_from_the_last_warmup_momentum(two):
    """OneBitLamb's coefficients, set on the first compressed step: the
    united mean of the tensors' momentum rms over each tensor's, from the
    last warmup momentum (equal on both ranks). The TPU package's, taken
    from each rank's local momentum, part its ranks' params."""
    ranks, _ = two
    first = CHAINS["onebitlamb"][1].index("comp")
    mu = ranks[0]["onebitlamb"][first]["st_in"]["mu"].astype(np.float64)
    rms = np.array([np.linalg.norm(mu[s:e]) / np.sqrt(e - s)
                    for s, e in LEAVES])
    want = rms.mean() / rms
    for r in range(WORLD):
        np.testing.assert_allclose(
            ranks[r]["onebitlamb"][first]["st"]["scaling"], want, rtol=1e-5)
    # the JAX step from the same inputs, its own coefficients
    _, grads = _chain_inputs("onebitlamb")
    st_in = {a: jnp.asarray(np.stack([r["onebitlamb"][first]["st_in"][a]
                                      for r in ranks]))
             for a in ranks[0]["onebitlamb"][first]["st_in"]}
    p, st = _jax_step("onebitlamb", "comp", first + 1)(
        jnp.asarray(grads[first]), st_in,
        jnp.asarray(_stack(ranks, "onebitlamb", first, "p_in")))
    assert np.abs(np.asarray(st["scaling"])[0]
                  - np.asarray(st["scaling"])[1]).max() > 1e-3
    assert np.abs(np.asarray(p)[0] - np.asarray(p)[1]).max() > 1e-4


# ------------------------------------------------------------------ engine

def _close_but_flips(got, want, bound, flips):
    """``helpers.close_masters`` with the lr bound ``bound``, leaving out
    the key third of each ``qkv.bias`` (its exact gradient is 0: what each
    package computes is rounding noise, so its 1-bit signs are coin flips)
    and at most ``flips`` other elements: those whose 1-bit sign sat
    within f32 rounding of zero and came out the other way."""
    d = TINY["d_model"]
    got, want = dict(got), dict(want)
    for name in want:
        if name.endswith("attn.qkv.bias"):
            keep = np.r_[0:d, 2 * d:3 * d]
            got[name], want[name] = got[name][keep], want[name][keep]
    over = sum(int((np.abs(got[k] - w) > bound).sum())
               for k, w in want.items())
    assert over <= flips, (over, flips)
    helpers.close_masters(
        got, {k: np.where(np.abs(got[k] - w) > bound, got[k], w)
              for k, w in want.items()}, lr=bound)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_matches_jax_engine(two, run):
    ranks, jax_runs = two
    _, pcfg, _ = _pair()
    want = jax_runs[run]
    steps = JAX_STEPS[run]
    exact = EXACT_STEPS[run]
    for r in ranks:
        got = r["engine"][run]
        for key in ("losses", "norms"):
            np.testing.assert_allclose(got[key][:exact], want[key][:exact],
                                       rtol=RTOL, err_msg=key)
            np.testing.assert_allclose(got[key][exact:steps],
                                       want[key][exact:], rtol=COMP_RTOL,
                                       err_msg=key)
    if run != "lamb":       # its master after the first compressed step
        _close_but_flips(ranks[0]["engine"][run]["master"],
                         _state_dict_np(want["master"], pcfg), 2e-3 * steps,
                         FLIPS)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_ranks_agree_and_grads_stay_local(two, run):
    """Losses and the master the same on both ranks after every step;
    after the first compressed step the ranks' worker errors differ (they
    would be equal had the gradients been averaged before compression);
    ZeroOneAdam's delta is zero after each sync; the wire accounting is
    the formula's for the modes run."""
    ranks, _ = two
    a, b = (r["engine"][run] for r in ranks)
    assert a["losses"] == b["losses"] and a["norms"] == b["norms"]
    assert np.isfinite(a["losses"]).all()
    for k in range(len(a["masters"])):
        np.testing.assert_array_equal(a["masters"][k], b["masters"][k])
    modes = {"adam": CHAINS["onebitadam"][1],
             "lamb": CHAINS["onebitlamb"][1][:4],
             "zeroone": CHAINS["zerooneadam"][1]}[run]
    first = modes.index("comp" if run != "zeroone" else "grad_comp")
    assert not np.array_equal(a["states"][first]["worker_error"],
                              b["states"][first]["worker_error"])
    if run == "zeroone":
        for k, mode in enumerate(modes):
            delta = a["states"][k]["delta"]
            if mode == "sync":
                assert not delta.any()
            elif mode == "local":
                assert delta.any()
    dense = sum(m in ("warmup", "dense") for m in modes)
    comp = sum(m in ("comp", "grad_comp", "sync") for m in modes)
    from deepspeed_tpu_torch.comm.compressed import (wire_bytes_compressed,
                                                     wire_bytes_dense)
    assert a["comm_bytes"] == {
        "dense": dense * wire_bytes_dense(a["n"], WORLD),
        "compressed": comp * wire_bytes_compressed(a["npad"], WORLD)}
    assert a["ratio"] == len(modes) * wire_bytes_dense(a["n"], WORLD) / (
        dense * wire_bytes_dense(a["n"], WORLD)
        + comp * wire_bytes_compressed(a["npad"], WORLD))


def test_onebit_adam_warmup_matches_dense_adamw(two):
    """Before freeze_step, 1-bit Adam is AdamW without bias correction on
    the dp-mean gradient (the TPU package's
    test_onebit_adam_warmup_matches_dense_adam)."""
    ranks, _ = two
    for r in ranks:
        onebit, dense = r["engine"]["onebit_warmup"], r["engine"]["dense_adamw"]
        np.testing.assert_allclose(onebit["losses"], dense["losses"],
                                   rtol=RTOL)
        helpers.close_masters(onebit["master"], dense["master"],
                              lr=2e-3 * len(onebit["losses"]))


# -------------------------------------------------------------- behaviours

@pytest.mark.parametrize("name", sorted(RESUMES))
def test_checkpoint_round_trip_is_bitwise(two, name):
    ranks, _ = two
    _, first, then = RESUMES[name]
    for r in ranks:
        got = r["resume"][name]
        assert got["resumed"] == got["cont"], (got["resumed"], got["cont"])
        np.testing.assert_array_equal(got["resumed_master"],
                                      got["cont_master"])
        for k, v in got["cont_state"].items():
            np.testing.assert_array_equal(got["resumed_state"][k], v)
            np.testing.assert_array_equal(got["loaded_state"][k],
                                          got["saved_state"][k])
        assert got["loaded_counts"] == (first, 0, first)
        if name == "zeroone":
            # inside the local regime: the errors are not zeroed again
            assert got["policy"] == (first, True, 2, True)
            assert got["saved_state"]["delta"].any()
    # each rank's state is its own
    assert not np.array_equal(ranks[0]["resume"][name]["saved_state"][
        "worker_error"], ranks[1]["resume"][name]["saved_state"][
        "worker_error"])


@pytest.mark.parametrize("name", sorted(FP16))
def test_fp16_overflow_on_one_rank_skips_the_step_on_both(two, name):
    ranks, _ = two
    _, before, next_mode = FP16[name]
    for r in ranks:
        got = r["fp16"][name]
        assert got["skipped"] == (1, 1) and got["count"] == before
        assert got["next_mode"] == next_mode
        np.testing.assert_array_equal(got["master_after"],
                                      got["master_before"])
        for k, v in got["state_before"].items():
            np.testing.assert_array_equal(got["state_after"][k], v)
        assert got["state_before"]["mu"].any()
        assert np.isfinite(got["losses"]).all()
        assert not np.array_equal(got["master_next"], got["master_after"])
    assert ranks[0]["fp16"][name]["losses"] == \
        ranks[1]["fp16"][name]["losses"]


@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_mesh_axes_other_than_dp_refused(two, axis):
    ranks, _ = two
    for r in ranks:
        kind, msg = r["refusals"][axis]
        assert kind == "ValueError" and "dp axis only" in msg, (kind, msg)


def _initialize_model(model, cfg, **kw):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    return dst.initialize(model=model, loss_fn=lm_loss_fn, device="cpu",
                          config=dict(ENGINE, **cfg), **kw)


def _initialize(cfg, **kw):
    return _initialize_model(model_pair(seed=0)[2], cfg, **kw)


REFUSED = {
    "dynamic_fp16": ({"fp16": {"enabled": True, "loss_scale": 0}},
                     ValueError, "DYNAMIC"),
    "clipping": ({"gradient_clipping": 1.0}, ValueError, "clip"),
    "zero2": ({"zero_optimization": {"stage": 2}}, ValueError, "ZeRO"),
    "offload": ({"zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu"}}}, ValueError,
        "offload_optimizer"),
    "pld": ({"progressive_layer_drop": {"enabled": True}}, ValueError,
            "progressive_layer_drop"),
    "moq": ({"quantize_training": {"enabled": True}}, ValueError,
            "quantize_training"),
    "stochastic_rounding": ({"bf16": {"enabled": True,
                                      "stochastic_rounding": True}},
                            NotImplementedError, "stochastic_rounding"),
    "unknown_param": ({}, ValueError, "not onebitadam params"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
@pytest.mark.parametrize("kind", ["OneBitAdam", "ZeroOneAdam", "OneBitLamb"])
def test_refusals_match_jax(name, kind):
    extra, exc, match = REFUSED[name]
    params = {"lr": 1e-3}
    if name == "unknown_param":
        params["momentum"] = 0.9
        match = f"not {kind.lower()} params"
    with pytest.raises(exc, match=match):
        _initialize(dict(extra, optimizer={"type": kind, "params": params}))


def test_three_call_api_and_client_optimizer_refused():
    import torch
    eng, opt, *_ = _initialize(_opt("OneBitAdam"))
    assert type(opt).__name__ == "OnebitAdam" and eng._onebit is not None
    batch = {"input_ids": helpers.ids(0, MICRO)}
    for call in (lambda: eng.forward(batch), lambda: eng.backward(None),
                 eng.step):
        with pytest.raises(NotImplementedError, match="train_batch"):
            call()
    _, _, pmodel = model_pair(seed=0)
    with pytest.raises(ValueError, match="client torch.optim"):
        _initialize(_opt("OneBitAdam"), optimizer=torch.optim.SGD(
            pmodel.parameters(), lr=0.1))


def test_flat_layout_is_the_jax_runners():
    """A GPT's flat master is the JAX runner's ``_flatten`` of the same
    params (``jax.tree.leaves`` order, blocks stacked, kernels [in, out]),
    bit for bit, with one leaf slice a JAX leaf; a module without a flax
    leaf map is flattened in parameter order."""
    import torch
    from deepspeed_tpu_torch.runtime.fp16.onebit.integration import \
        flat_layout
    _, params, pmodel = model_pair(seed=3)
    eng, *_ = _initialize_model(pmodel, _opt("OneBitLamb"))
    leaves = jax.tree.leaves(params)
    np.testing.assert_array_equal(
        eng._onebit.master.numpy(),
        np.concatenate([np.asarray(x, np.float32).reshape(-1)
                        for x in leaves]))
    assert [e - s for s, e in eng._onebit.leaf_slices] == \
        [x.size for x in leaves]
    linear = torch.nn.Linear(3, 4)
    assert flat_layout(linear, "cpu") == ([(0, 12), (12, 16)], None)
