"""Mixture-of-Experts in the port (``deepspeed_tpu_torch.moe``, GPT-MoE)
against the TPU package on the CPU, f32, inputs and weights from seeds.

  * ``_capacity`` over a grid; ``top1gating`` and ``top2gating`` without
    and with capacity drops, with tied priorities and tied logits, with
    ``used_token``, without dropping, and with the TPU function's own
    draws (RTS uniforms, RSample and top-2 Gumbel noise, split from its
    key exactly as it splits them) injected: dispatch masks and
    ``exp_counts`` equal, combine weights and ``l_aux`` within 1e-6;
  * ``TopKGate`` (eval and train capacity, Jitter from injected draws),
    ``MOELayer`` through ``MoE`` with and without the residual MLP;
  * GPT-MoE: logits within 1e-4 and the loss (aux term included), scanned
    and unscanned, with the TPU tree mapped through ``convert.py`` both
    ways; ``InferenceEngine.generate``'s greedy tokens; the dense, paged,
    fused and speculative ``ServingEngine``'s greedy tokens equal to the
    TPU ``ServingEngine``'s at an eval capacity that drops tokens (every
    row of every call is routed, padding and idle lanes included, so the
    routed populations must match for the tokens to);
  * the TPU engine's losses and grad norms at a capacity that drops
    nothing (rtol 2e-4, as tests/test_moe.py holds ep degrees); the
    training gate's draws seeded and replayed under remat;
  * ``moe.utils`` against the TPU helpers, the config knobs and the
    refusals kept.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import InferenceEngine, ServingEngine
from deepspeed_tpu_torch.moe import sharded_moe as pm
from torch_port_helpers import model_pair, prompts
from torch_test_threads import one_torch_thread  # noqa: F401

ATOL = 1e-6
MOE = dict(moe=True, num_experts=4)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _logits(seed, s=48, e=4, scale=1.0):
    return np.random.default_rng(seed).normal(
        scale=scale, size=(s, e)).astype(np.float32)


def _same(got, want):
    l_aux, combine, dispatch, counts = (t.detach() for t in got)
    jl, jc, jd, jn = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(dispatch.numpy(), jd)
    np.testing.assert_array_equal(counts.numpy(), jn)
    np.testing.assert_allclose(combine.numpy(), jc, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(l_aux), float(jl), atol=ATOL, rtol=0)


def test_capacity_matches_jax():
    from deepspeed_tpu.moe.sharded_moe import _capacity
    for s in (1, 7, 16, 48, 129):
        for e in (1, 2, 4, 16):
            for cf in (0.5, 1.0, 1.25, 2.0):
                for mc in (0, 4, 64):
                    assert pm._capacity(s, e, cf, mc) == _capacity(s, e, cf,
                                                                   mc)


def _tied_logits():
    """Every token prefers expert 0 by the same margin (priority ties for
    the capacity), and odd tokens tie experts 1 and 2 exactly."""
    x = np.zeros((48, 4), np.float32)
    x[:, 0] = 2.0
    x[1::2, 1:3] = 3.0
    return x


TOP1 = {
    "no_drops": dict(logits=_logits(0), cf=4.0, mc=1),
    "drops": dict(logits=_logits(1, scale=2.0), cf=0.5, mc=1),
    "ties": dict(logits=_tied_logits(), cf=1.0, mc=1),
    "used_token": dict(logits=_logits(2), cf=1.0, mc=4, used=True),
    "no_drop_tokens": dict(logits=_logits(3, scale=3.0), cf=0.25, mc=1,
                           drop_tokens=False),
    "rts": dict(logits=_logits(4, scale=2.0), cf=0.5, mc=1, key=5),
    "rsample": dict(logits=_logits(6), cf=0.75, mc=1, key=7,
                    policy="RSample"),
    "rts_ties": dict(logits=_tied_logits(), cf=0.5, mc=1, key=8),
}


@pytest.mark.parametrize("name", sorted(TOP1))
def test_top1gating_matches_jax(name):
    from deepspeed_tpu.moe.sharded_moe import top1gating
    c = TOP1[name]
    logits = c["logits"]
    used = (np.random.default_rng(9).random(logits.shape[0]) > 0.3
            if c.get("used") else None)
    kw = dict(noisy_gate_policy=c.get("policy"),
              drop_tokens=c.get("drop_tokens", True))
    want = top1gating(jnp.asarray(logits), c["cf"], c["mc"],
                      rng=(jax.random.PRNGKey(c["key"]) if "key" in c
                           else None),
                      used_token=None if used is None else jnp.asarray(used),
                      **kw)
    gumbel = rts = None
    if "key" in c:              # the TPU function's own draws, replayed
        rng = jax.random.PRNGKey(c["key"])
        if c.get("policy") == "RSample":
            rng, sub = jax.random.split(rng)
            gumbel = _t(jax.random.gumbel(sub, logits.shape, jnp.float32))
        rng, sub = jax.random.split(rng)
        rts = _t(jax.random.uniform(sub, logits.shape))
    got = pm.top1gating(_t(logits), c["cf"], c["mc"],
                        used_token=None if used is None
                        else torch.from_numpy(used), gumbel=gumbel, rts=rts,
                        **kw)
    _same(got, want)
    if name in ("drops", "rts", "ties", "rts_ties"):
        assert int(got[2].sum()) < logits.shape[0]     # tokens dropped


TOP2 = {"no_drops": dict(logits=_logits(10), cf=2.0, mc=1),
        "drops": dict(logits=_logits(11, scale=2.0), cf=0.5, mc=1),
        "ties": dict(logits=_tied_logits(), cf=0.5, mc=1),
        "gumbel": dict(logits=_logits(12), cf=0.5, mc=1, key=13)}


@pytest.mark.parametrize("name", sorted(TOP2))
def test_top2gating_matches_jax(name):
    from deepspeed_tpu.moe.sharded_moe import top2gating
    c = TOP2[name]
    logits = c["logits"]
    key = jax.random.PRNGKey(c["key"]) if "key" in c else None
    want = top2gating(jnp.asarray(logits), c["cf"], c["mc"], rng=key)
    gumbel = None
    if key is not None:
        _, sub = jax.random.split(key)
        gumbel = _t(jax.random.gumbel(sub, logits.shape, jnp.float32))
    _same(pm.top2gating(_t(logits), c["cf"], c["mc"], gumbel=gumbel), want)


def test_keep_top_capacity_breaks_ties_by_token_index():
    """Priority ties keep the lowest token indices, as jax.lax.top_k does;
    higher priorities go first."""
    from deepspeed_tpu.moe.sharded_moe import _keep_top_capacity
    rng = np.random.default_rng(0)
    mask = (rng.random((40, 3)) > 0.4).astype(np.int32)
    for prio in (mask.astype(np.float32),
                 mask * rng.integers(0, 3, mask.shape).astype(np.float32)):
        for cap in (1, 5, 40):
            want = _keep_top_capacity(jnp.asarray(mask), jnp.asarray(prio),
                                      cap)
            got = pm._keep_top_capacity(torch.from_numpy(mask), _t(prio), cap)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gate_pair(k, **kw):
    from deepspeed_tpu.moe.sharded_moe import TopKGate as JGate
    jg = JGate(model_dim=16, num_experts=4, k=k, capacity_factor=1.0,
               eval_capacity_factor=0.5, min_capacity=2, **kw)
    x = np.random.default_rng(k).normal(size=(24, 16)).astype(np.float32)
    params = jg.init(jax.random.PRNGKey(k), jnp.asarray(x))["params"]
    pg = pm.TopKGate(16, 4, k=k, capacity_factor=1.0,
                     eval_capacity_factor=0.5, min_capacity=2, **kw)
    with torch.no_grad():
        pg.wg.weight.copy_(_t(np.asarray(params["wg"]["kernel"]).T))
    return jg, params, pg, x


@pytest.mark.parametrize("k", [1, 2])
def test_topk_gate_matches_jax(k):
    """Eval (the eval capacity, no draw) against the TPU gate; training
    capacity with no draws equals the functions at capacity_factor; Jitter
    scales the gate input by its draw."""
    from deepspeed_tpu.moe.sharded_moe import top1gating, top2gating
    jg, params, pg, x = _gate_pair(k)
    want = jg.apply({"params": params}, jnp.asarray(x))
    _same(pg(_t(x)), want)
    logits = x @ np.asarray(params["wg"]["kernel"])
    fn = top1gating if k == 1 else top2gating
    _same(pg(_t(x), deterministic=False), fn(jnp.asarray(logits), 1.0, 2))
    jit_g = pm.TopKGate(16, 4, k=1, noisy_gate_policy="Jitter")
    jit_g.load_state_dict(pg.state_dict())
    draws = jit_g.draws(torch.Generator().manual_seed(0), 24)
    assert draws.jitter.shape == (24, 16) and draws.rts.shape == (24, 4)
    assert float(draws.jitter.min()) >= 0.99 and \
        float(draws.jitter.max()) < 1.01
    jl = (x * draws.jitter.numpy()) @ np.asarray(params["wg"]["kernel"])
    _same(jit_g(_t(x), deterministic=False, draws=draws),
          top1gating(jnp.asarray(jl), 1.0, 8,
                     rng=None, noisy_gate_policy="Jitter"))


def _port_moe(jparams, residual, k, **kw):
    from deepspeed_tpu_torch.convert import _moe
    from deepspeed_tpu_torch.moe import MoE
    out = {}
    _moe("x", jax.tree.map(np.asarray, jparams), out)
    sd = {n[2:]: torch.from_numpy(np.array(v, order="C"))
          for n, v in out.items()}
    moe = MoE(16, 32, 4, k=k, use_residual=residual, dtype=torch.float32,
              **kw)
    moe.load_state_dict(sd)
    return moe


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("residual", [False, True])
def test_moe_layer_matches_jax(residual, k):
    from deepspeed_tpu.models.gpt import GPTConfig as JCfg, MLP
    from deepspeed_tpu.moe import MoE as JMoE
    cfg = JCfg(d_model=16, d_ff=32, dtype=jnp.float32)
    kw = dict(capacity_factor=1.0, eval_capacity_factor=0.75,
              min_capacity=2)
    jm = JMoE(hidden_size=16, expert=MLP(cfg), num_experts=4, k=k,
              use_residual=residual, **kw)
    x = np.random.default_rng(3).normal(size=(2, 12, 16)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    jout, jl, jc = jm.apply({"params": params}, jnp.asarray(x))
    out, l_aux, counts = _port_moe(params, residual, k, **kw)(_t(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(l_aux), float(jl), atol=ATOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("residual", [False, True])
def test_gpt_moe_matches_jax(scan, residual):
    """Logits within 1e-4 and the loss (cross entropy + the weighted aux
    loss), at an eval capacity that drops tokens; the port's state_dict
    mapped back to the TPU tree gives the TPU model the same logits."""
    from deepspeed_tpu.models.gpt import lm_loss_fn as jax_loss
    from deepspeed_tpu_torch.convert import state_dict_to_jax_params
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    jmodel, params, pmodel = model_pair(
        seed=21, scan_layers=scan, moe_use_residual=residual,
        moe_eval_capacity_factor=0.5, **MOE)
    ids = np.random.default_rng(5).integers(0, 256, (4, 24)).astype(np.int32)
    jl, jaux = jmodel.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        pl, paux = pmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(paux), float(jaux), atol=1e-7,
                               rtol=1e-5)
    batch = {"input_ids": ids}
    np.testing.assert_allclose(
        float(lm_loss_fn((pl, paux), {"input_ids": torch.from_numpy(ids)})),
        float(jax_loss((jl, jaux), batch)), rtol=1e-5)
    back = state_dict_to_jax_params(pmodel.state_dict(), pmodel.cfg, scan)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.fixture(scope="module")
def serve_pair():
    # an eval capacity that drops at decode (4 lanes over 4 experts: 1
    # slot each) and in prefill
    return model_pair(seed=3, moe_eval_capacity_factor=0.5,
                      moe_min_capacity=1, **MOE)


def test_gpt_moe_generate_matches_jax(serve_pair):
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    jmodel, params, pmodel = serve_pair
    ids = np.random.default_rng(3).integers(1, 256, (3, 9)).astype(np.int32)
    ref = JaxEngine(jmodel, dtype=jnp.float32,
                    model_parameters=params).generate(
        ids, max_new_tokens=10, temperature=0.0)
    eng = InferenceEngine(pmodel, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(
        eng.generate(ids, max_new_tokens=10, temperature=0.0).numpy(),
        np.asarray(ref))
    logits = eng.forward(ids)                      # (logits, aux) unwrapped
    assert logits.shape == (3, 9, 256)


SERVE = dict(max_batch=4, max_prompt_len=32, max_queue=16, decode_chunk=4)
SERVING = {"dense": {}, "paged": dict(paged=True, kv_block_size=8),
           "fused": dict(fused_prefill=True, prefill_chunk=4),
           "speculative": dict(speculative=True, spec_k=3)}


@pytest.mark.parametrize("name", sorted(SERVING))
def test_gpt_moe_serving_matches_jax(serve_pair, name):
    from deepspeed_tpu.serving import ServingEngine as JaxServing
    jmodel, params, pmodel = serve_pair
    reqs = prompts(n=7, seed=4, lo=6, hi=30)
    kw = SERVING[name]

    def ids(out):
        assert all(r.status == "done" for r in out)
        return [r.output_ids.tolist() for r in out]
    ref = ids(JaxServing(jmodel, model_parameters=params, dtype=jnp.float32,
                         **SERVE, **kw).run([p.copy() for p in reqs],
                                            max_new_tokens=8))
    for megakernel in (True, False):
        eng = ServingEngine(pmodel, device="cpu", dtype=torch.float32,
                            megakernel=megakernel, **SERVE, **kw)
        assert ids(eng.run([p.copy() for p in reqs],
                           max_new_tokens=8)) == ref, megakernel


def test_engine_matches_jax_engine_without_drops():
    """Three train_batch steps of a top-1 GPT-MoE against the TPU engine
    (dp 8 × 1 row; the port at one rank × 8 rows) at capacity_factor E,
    where nothing drops and the routing draws cannot matter: losses and
    grad norms within rtol 2e-4."""
    import deepspeed_tpu as ds
    from deepspeed_tpu.models.gpt import lm_loss_fn as jax_loss
    from test_torch_training import ENGINE_CONFIG, _micros, _port_engine
    jmodel, params, pmodel = model_pair(seed=13, moe_capacity_factor=4.0,
                                        **MOE)
    jeng, *_ = ds.initialize(
        model=jmodel, model_parameters=params, loss_fn=jax_loss,
        config=dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=1))
    peng, *_ = _port_engine(pmodel)
    micros = _micros(6)
    for step in range(3):
        batch = micros[2 * step:2 * step + 2]
        jl = float(jeng.train_batch(iter(batch)))
        pl = float(peng.train_batch(iter(batch)))
        np.testing.assert_allclose(pl, jl, rtol=2e-4)
        np.testing.assert_allclose(peng.get_global_grad_norm(),
                                   float(jeng.get_global_grad_norm()),
                                   rtol=2e-4)


def test_training_gate_draws_seeded_and_replayed_under_remat():
    """The training forward draws from its generator: the same seed gives
    the same loss and grads; under remat the recompute routes as the
    forward did (grads equal the no-remat model's)."""
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    _, _, plain = model_pair(seed=8, moe_capacity_factor=0.5,
                             moe_top_k=2, **MOE)
    remat = type(plain)(dataclasses.replace(plain.cfg, remat=True))
    remat.load_state_dict(plain.state_dict())
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (4, 16)))
    grads = []
    for model in (plain, remat, plain):
        model.zero_grad()
        out = model(ids, deterministic=False,
                    generator=torch.Generator().manual_seed(3))
        lm_loss_fn(out, {"input_ids": ids}).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for g in grads[1:]:
        for n in grads[0]:
            torch.testing.assert_close(g[n], grads[0][n], rtol=1e-5,
                                       atol=1e-7)
    other = plain(ids, deterministic=False,
                  generator=torch.Generator().manual_seed(4))
    evald = plain(ids)
    assert not torch.equal(other[0], evald[0])


def test_moe_utils_match_jax():
    from deepspeed_tpu.moe import utils as ju
    from deepspeed_tpu.runtime.sharding import path_str
    from deepspeed_tpu_torch.moe import utils as pu
    _, params, pmodel = model_pair(seed=2, moe_use_residual=True,
                                   scan_layers=False, **MOE)
    assert pu.count_moe_params(pmodel) == ju.count_moe_params(params)
    mask = pu.moe_param_mask(pmodel)
    assert sum(mask.values()) == 8           # 2 layers × up/down × w/b
    shared, expert = pu.split_params_into_shared_and_expert(
        pmodel.state_dict())
    assert set(shared) | set(expert) == set(pmodel.state_dict())
    assert all(".experts." in n for n in expert)
    jmask = jax.tree_util.tree_flatten_with_path(ju.moe_param_mask(params))[0]
    assert sum(bool(v) for _, v in jmask) == len(expert)
    for path, flag in jmask:
        assert pu.is_moe_param_path(path_str(path)) == bool(flag)
    assert pu.is_moe_param(("blocks.0.moe.deepspeed_moe.experts.up_proj."
                            "weight", None))
    assert not pu.is_moe_param("blocks.0.moe.deepspeed_moe.gate.wg.weight")


def test_gpt_moe_config_and_refusals():
    from deepspeed_tpu.models.gpt import gpt_moe_1_3b as jax_cfg
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig, gpt_moe_1_3b
    got, want = gpt_moe_1_3b(num_experts=16), jax_cfg(num_experts=16)
    for f in dataclasses.fields(got):
        if f.name not in ("dtype", "param_dtype", "sparse_attention",
                          "decode_impl"):     # "xla" is the port's "einsum"
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.num_experts == 16 and gpt_moe_1_3b().num_experts == 128
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        GPTConfig(**MOE, sequence_parallel=True)
    # tp_overlap is ported (a config knob, as in JAX); an MoE model split
    # over tp > 1 is what raises (tests/test_torch_tp.py)
    assert GPTConfig(**MOE, tp_overlap=True, parallel_residual=True).moe
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        GPTConfig(cpu_checkpointing=True, **MOE)
    with pytest.raises(ValueError):
        GPTConfig(moe=True, moe_top_k=3)
    model = GPT(GPTConfig(vocab_size=64, max_seq_len=16, num_layers=1,
                          num_heads=2, d_model=16, d_ff=32,
                          dtype=torch.float32, **MOE))
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        InferenceEngine(model, quantize_bits=8, device="cpu",
                        dtype=torch.float32)
    with pytest.raises(ValueError, match="sharded no parameter"):
        dense = GPT(dataclasses.replace(model.cfg, moe=False))
        InferenceEngine(dense, ep_size=2, device="cpu")
    from deepspeed_tpu_torch.runtime.pipe.spmd import gpt_pipe_spec
    with pytest.raises(ValueError, match="aux loss"):
        gpt_pipe_spec(model)
