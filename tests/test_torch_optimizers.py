"""The port's LAMB, Adagrad and SGD against the TPU package's, and its MFU
report, on the CPU, f32, inputs from numpy seeds.

  * ops: ``fused_lamb``, ``fused_adagrad`` and ``sgd`` trajectories over 5
    steps against ``deepspeed_tpu.ops.lamb.fused_lamb``,
    ``deepspeed_tpu.ops.adam.fused_adagrad`` and ``optax.sgd`` (momentum 0
    and 0.9), with a scheduled learning rate: params within 1e-5 relative,
    state within the same (as ``test_fused_adam_trajectory_matches_jax``);
  * engine: 3 ``train_batch`` steps of the tiny GPT with each optimizer
    against the JAX engine built as in ``test_engine_matches_jax_engine``:
    losses and grad norms within ``RTOL``, moments within rtol 1e-4 and
    atol 1e-4 × the tree's largest magnitude. The JAX engine cannot train
    with Adagrad (``fused_adagrad`` makes a new state type at each call and
    the engine calls it twice; ROADMAP §C), so that run hands the JAX
    engine one transformation for both calls;
  * the TPU table's quirks the port does not copy, pinned: Adagrad ignores
    a configured eps there (always 1e-10) and SGD drops weight_decay; the
    port takes the eps and refuses the weight decay. LAMB's effective eps
    default is the table's 1e-8, not ``fused_lamb``'s 1e-6;
  * LAMB under ZeRO-1 at dp 2 (whole-tensor trust ratios from one
    all-reduce of the [n_leaves, 2] partial sums a step) against dp 1;
  * ``mfu_report`` / ``peak_flops_per_device`` against the TPU package's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_helpers as helpers
from test_torch_training import ENGINE_CONFIG, RTOL, _state_dict_np
from torch_port_helpers import model_pair
from torch_test_threads import one_torch_thread  # noqa: F401

STEPS, GAS = 3, ENGINE_CONFIG["gradient_accumulation_steps"]
MOMENT_RTOL = 1e-4
SHAPES = [(7, 5), (5,), (3, 2, 4)]


def _sgd_pair(momentum):
    from deepspeed_tpu_torch.ops.sgd import sgd
    return (lambda lr: optax.sgd(lr, momentum=momentum),
            lambda p, lr: sgd(p, lr, momentum=momentum))


def _op_pair(kind):
    """(jax factory of lr, port factory of (params, lr), state names)."""
    from deepspeed_tpu.ops.adam import fused_adagrad as jadagrad
    from deepspeed_tpu.ops.lamb import fused_lamb as jlamb
    from deepspeed_tpu_torch.ops.adam import fused_adagrad
    from deepspeed_tpu_torch.ops.lamb import fused_lamb
    if kind.startswith("lamb"):
        kw = dict(betas=(0.9, 0.95), eps=1e-6, weight_decay=0.01,
                  bias_correction=kind == "lamb", max_coeff=5.0,
                  min_coeff=0.05)
        return (lambda lr: jlamb(lr, **kw),
                lambda p, lr: fused_lamb(p, lr, **kw))
    if kind == "adagrad":
        kw = dict(eps=1e-10, weight_decay=0.01)
        return (lambda lr: jadagrad(lr, **kw),
                lambda p, lr: fused_adagrad(p, lr, **kw))
    return _sgd_pair({"sgd": 0.0, "sgd_momentum": 0.9}[kind])


def _jax_state(kind, js):
    """The JAX optimizer state as {port state name: leaves}."""
    if kind.startswith("lamb"):
        return {"mu": js.mu, "nu": js.nu, "count": js.count}
    if kind == "adagrad":
        return {"accum": js.accum, "count": js.count}
    return {"trace": js[0].trace, "count": js[1].count}


@pytest.mark.parametrize("kind", ["lamb", "lamb_no_bias_correction",
                                  "adagrad", "sgd", "sgd_momentum"])
def test_op_trajectory_matches_jax(kind):
    jfactory, pfactory = _op_pair(kind)
    lr = lambda count: 1e-2 / (count + 1)             # noqa: E731
    rng = np.random.default_rng(9)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    init.append(np.zeros((4,), np.float32))       # LAMB: trust ratio 1
    grads = [[rng.standard_normal(x.shape).astype(np.float32)
              for x in init] for _ in range(5)]
    jopt = jfactory(lr)
    jp = [jnp.asarray(x) for x in init]
    js = jopt.init(jp)
    params = [torch.from_numpy(x.copy()) for x in init]
    opt = pfactory(params, lr)
    for g in grads:
        upd, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(x) for x in g])
        for a, b in zip(params, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=1e-7)
    want = _jax_state(kind, js)
    assert opt.count == int(want.pop("count")) == 5
    for name, leaves in want.items():
        for m, jm in zip(getattr(opt, name), leaves):
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=RTOL,
                                       atol=1e-9)


def test_state_dict_round_trip():
    """``load_state_dict`` of ``state_dict`` continues the trajectory
    bitwise (every optimizer, Adam included)."""
    from deepspeed_tpu_torch.ops.adam import fused_adam
    rng = np.random.default_rng(3)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(4)]
    lr = lambda count: 1e-2 / (count + 1)             # noqa: E731
    factories = [lambda p: fused_adam(p, lr, weight_decay=0.01)] + [
        functools.partial(_op_pair(k)[1], lr=lr)
        for k in ("lamb", "adagrad", "sgd_momentum")]
    for make in factories:
        a = [torch.from_numpy(x.copy()) for x in init]
        opt_a = make(a)
        for g in grads[:2]:
            opt_a.step([torch.from_numpy(x) for x in g])
        b = [x.clone() for x in a]
        opt_b = make(b)
        opt_b.load_state_dict(
            {k: [t.clone() for t in v] if isinstance(v, list) else v
             for k, v in opt_a.state_dict().items()})
        for g in grads[2:]:
            opt_a.step([torch.from_numpy(x) for x in g])
            opt_b.step([torch.from_numpy(x) for x in g])
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

# the JAX and the port config of each run: the JAX one carries the knobs
# the TPU table drops (Adagrad's eps, SGD's weight_decay); the port's the
# values the TPU engine actually runs
ENGINE_RUNS = {
    "lamb": ({"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}},
             {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}}),
    "adagrad": ({"type": "Adagrad", "params": {"lr": 1e-2, "eps": 1.0}},
                {"type": "Adagrad", "params": {"lr": 1e-2}}),
    "sgd": ({"type": "SGD", "params": {"lr": 0.1}},
            {"type": "SGD", "params": {"lr": 0.1}}),
    "sgd_momentum": ({"type": "SGD", "params": {
        "lr": 0.1, "momentum": 0.9, "weight_decay": 0.1}},
        {"type": "SGD", "params": {"lr": 0.1, "momentum": 0.9}}),
}


def _micros():
    return [{"input_ids": helpers.ids(12 + i, 8)} for i in range(STEPS * GAS)]


@functools.lru_cache(None)
def _pair():
    jmodel, params, pmodel = model_pair(seed=17)
    return jmodel, params, pmodel.cfg, {
        k: v.detach().numpy().copy() for k, v in pmodel.state_dict().items()}


def _one_adagrad(monkeypatch):
    """The JAX engine builds its optimizer twice (once for the state's
    init, once with the schedule); hand it one Adagrad transformation,
    reading the latest learning rate."""
    import deepspeed_tpu.runtime.engine as jengine
    real, box = jengine.fused_adagrad, {}

    def one(learning_rate, **kw):
        box["lr"] = learning_rate
        if "tx" not in box:
            box["tx"] = real(lambda count: box["lr"](count), **kw)
        return box["tx"]
    monkeypatch.setattr(jengine, "fused_adagrad", one)


@functools.lru_cache(None)
def _jax_run(kind):
    import deepspeed_tpu as ds
    from deepspeed_tpu.models.gpt import lm_loss_fn
    jmodel, params, pcfg, _ = _pair()
    with pytest.MonkeyPatch.context() as mp:
        if kind == "adagrad":
            _one_adagrad(mp)
        eng, *_ = ds.initialize(
            model=jmodel, model_parameters=params, loss_fn=lm_loss_fn,
            config=dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=1,
                        optimizer=ENGINE_RUNS[kind][0]))
        micros = _micros()
        losses, norms = [], []
        for step in range(STEPS):
            losses.append(float(eng.train_batch(
                iter(micros[GAS * step:GAS * (step + 1)]))))
            norms.append(float(eng.get_global_grad_norm()))
    state = _jax_state(kind, eng.state["opt"])
    state.pop("count")
    return {"losses": losses, "norms": norms,
            "state": {k: _state_dict_np(v, pcfg) for k, v in state.items()}}


def _port_run(optimizer, micro=8, stage=1):
    engine = helpers.port_engine(
        helpers.port_model(_pair()[3]),
        dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=micro,
             zero_optimization={"stage": stage}, optimizer=optimizer))
    losses, norms = helpers.train(engine, _micros(), STEPS, GAS)
    return engine, losses, norms


@pytest.mark.parametrize("kind", sorted(ENGINE_RUNS))
def test_engine_trajectory_matches_jax_engine(kind):
    want = _jax_run(kind)
    engine, losses, norms = _port_run(ENGINE_RUNS[kind][1])
    np.testing.assert_allclose(losses, want["losses"], rtol=RTOL)
    np.testing.assert_allclose(norms, want["norms"], rtol=RTOL)
    assert losses[-1] < losses[0]
    for name, tree in want["state"].items():
        scale = max(np.abs(v).max() for v in tree.values())
        for pname, t in zip(engine._names, getattr(engine.optimizer, name)):
            np.testing.assert_allclose(t.numpy(), tree[pname],
                                       rtol=MOMENT_RTOL,
                                       atol=MOMENT_RTOL * scale,
                                       err_msg=f"{name} {pname}")
    if kind == "lamb":
        from deepspeed_tpu_torch.ops.lamb import fused_lamb
        # the TPU table's eps default, not fused_lamb's own
        assert engine.optimizer.eps == 1e-8
        assert fused_lamb([]).eps == 1e-6


def test_adagrad_eps_divergence_pinned():
    """The TPU table passes eps 1e-10 whatever the config says (the JAX
    engine configured with eps 1.0 ran the port's default 1e-10 above);
    the port takes the configured eps."""
    want = _jax_run("adagrad")
    engine, losses, _ = _port_run({"type": "Adagrad",
                                   "params": {"lr": 1e-2, "eps": 1.0}})
    assert engine.optimizer.eps == 1.0
    assert abs(losses[-1] - want["losses"][-1]) > 100 * RTOL * abs(
        want["losses"][-1])
    default, _, _ = _port_run(ENGINE_RUNS["adagrad"][1])
    assert default.optimizer.eps == 1e-10


def test_sgd_weight_decay_divergence_pinned():
    """The TPU table drops SGD's weight_decay (its run configured with 0.1
    matched the port's run without it above); the port refuses it."""
    _jax_run("sgd_momentum")
    with pytest.raises(ValueError, match="weight_decay"):
        _port_run(ENGINE_RUNS["sgd_momentum"][0])
    with pytest.raises(ValueError, match="not SGD params"):
        _port_run({"type": "SGD", "params": {"lr": 0.1, "nesterov": True}})


def test_lamb_dp2_equals_dp1():
    lamb = ENGINE_RUNS["lamb"][1]
    cfg = dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=4,
               optimizer=lamb)
    ranks = helpers.run_ranks("torch_dist_helpers:train_cases", 2,
                              cases={"lamb": dict(
                                  state=_pair()[3], config=cfg,
                                  micros=_micros(), steps=STEPS)})
    engine, losses, norms = _port_run(lamb)
    for r in ranks:
        got = r["lamb"]
        # one all-reduce of the [n_leaves, 2] partial sums a step
        assert got["norm_reduces"] == [(len(engine.master), 2)] * STEPS
        np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
        np.testing.assert_allclose(got["norms"], norms, rtol=RTOL)
        for name, p in zip(engine._names, engine.master):
            np.testing.assert_allclose(got["master"][name],
                                       p.detach().numpy(), rtol=0,
                                       atol=1e-3, err_msg=name)
        for m in ("mu", "nu"):
            tree = {n: t.numpy() for n, t in
                    zip(engine._names, getattr(engine.optimizer, m))}
            scale = max(np.abs(v).max() for v in tree.values())
            for name, t in tree.items():
                np.testing.assert_allclose(got["opt"][f"{m}/{name}"], t,
                                           rtol=MOMENT_RTOL,
                                           atol=MOMENT_RTOL * scale)


# --------------------------------------------------------------------------
# MFU
# --------------------------------------------------------------------------

MFU_CASES = [
    dict(flops_per_call=6.0e12, calls=3, wall_s=1.5, n_devices=1,
         peak_flops=989.4e12, label="train"),
    dict(flops_per_call=2.5e9, calls=10, wall_s=0.25, n_devices=4,
         peak_flops=989.4e12),
    dict(flops_per_call=2.5e9, calls=10, wall_s=0.25, peak_flops=None),
    dict(flops_per_call=None, calls=4, wall_s=1.0, peak_flops=1e12),
    dict(flops_per_call=1e9, calls=0, wall_s=0.0, peak_flops=1e12),
]


@pytest.mark.parametrize("i", range(len(MFU_CASES)))
def test_mfu_report_matches_jax(i):
    from deepspeed_tpu.telemetry.mfu import mfu_report as jreport
    from deepspeed_tpu_torch.telemetry.mfu import mfu_report
    assert mfu_report(**MFU_CASES[i]) == jreport(**MFU_CASES[i])


def test_peak_flops(monkeypatch):
    from deepspeed_tpu.telemetry import mfu as jmfu
    from deepspeed_tpu_torch.telemetry import mfu
    monkeypatch.delenv(mfu.PEAK_FLOPS_ENV, raising=False)
    assert mfu.peak_flops_per_device("cpu") is None
    assert mfu.peak_flops_per_device(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert mfu.peak_flops_per_device() == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA A100-SXM4-80GB")
    assert mfu.peak_flops_per_device() is None
    monkeypatch.setenv(mfu.PEAK_FLOPS_ENV, "123e12")
    assert mfu.peak_flops_per_device("cpu") == 123e12 == \
        jmfu.peak_flops_per_device(jax.devices()[0])
