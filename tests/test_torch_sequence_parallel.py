"""Sequence parallelism in the port (``GPTConfig(sequence_parallel=True)``,
``cp_impl`` "ulysses" or "ring", ``mesh: {"sp": n}``) against the TPU
package, on the CPU in f32.

The TPU package trains on its 8 virtual devices (``tests/
test_sequence_parallel.py``'s ``_train``: mesh sp 2, dp 4, the same global
batch of 8 rows); the port on gloo ranks (``torch_dist_helpers.run_ranks``:
one start at 2 ranks, mesh {"sp": 2}, and one at 4, dp 2 x sp 2), each rank
its dp rows and sp columns, and at sp 1 in this process. Held:

  * the Ulysses exchanges: ``seq_to_heads`` gives a rank the whole
    sequence of its heads (also of q/k/v stacked), ``heads_to_seq`` undoes
    it, the backward is the opposite exchange; where sp does not divide the
    heads, the gathered path's output rows and grads equal plain attention
    and it warns, as the TPU constraint does;
  * training losses at sp 2 and dp 2 x sp 2, both ``cp_impl``s, equal sp
    1's and the TPU package's within ``LOSS_TOL`` (f32; the loss and the
    grads are summed in another grouping over sp and dp), ZeRO 0, 1, 2 at
    dp 2 x sp 2 with the fp32 masters of sp 1;
  * the labels of a rank's last column come from the next rank's first
    token (only the row's last position has none), and a ``loss_mask``
    trains as at sp 1; a checkpoint saved at dp 2 x sp 2 loads at sp 1 and
    trains on as the saving run does;
  * ``GPT.prefill`` over sp 2 gives sp 1's hidden states and K/V by
    chunks, a decode step over an sp group raises;
  * ``ServingEngine(sp_prefill_threshold=)``: the JAX test's route
    (``test_fused_prefill.py::test_sp_threshold_route``), tokens equal to
    the TPU engine's and to the port's engine without the knob, fused and
    bucketed, dense and paged; the budget's lane cost;
  * the refusals: ZeRO-3 and the offload tiers at sp 2, tp x sp, ep x sp,
    an MoE model with sp, a model without ``sequence_parallel`` at mesh sp
    2, a bad ``cp_impl``.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as helpers
from torch_test_threads import one_torch_thread  # noqa: F401

from deepspeed_tpu_torch.convert import jax_params_to_state_dict
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig

# tests/test_sequence_parallel.py's _cfg: 4 heads of 16
MODEL = dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=4,
             d_model=64, d_ff=128, attention_impl="xla")
# f32 losses: the port's sp runs sum the nll and the grads over sp and dp
# in another grouping than sp 1 and the TPU program (the TPU test holds its
# sp run to dp at rtol 2e-4, atol 2e-5)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
STEPS = 4


def _engine_config(dp, sp, stage=0, **extra):
    return {"train_micro_batch_size_per_gpu": 8 // dp,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": stage},
            "mesh": {"sp": sp} if sp > 1 else {}, "steps_per_print": 10000,
            **extra}


def _micros(n=STEPS + 2, mask=False):
    """The TPU test's batches (seeds 100 + i, [8, 64]); ``mask``: a
    ``loss_mask`` zero on a third of the tokens."""
    out = []
    for i in range(n):
        batch = {"input_ids": np.random.default_rng(100 + i).integers(
            0, 256, (8, 64)).astype(np.int32)}
        if mask:
            batch["loss_mask"] = (np.random.default_rng(200 + i).random(
                (8, 64)) > 1 / 3).astype(np.float32)
        out.append(batch)
    return out


@functools.lru_cache(None)
def _state():
    """The TPU test's initial weights (``model.init`` at PRNGKey 0), as the
    port's state dict."""
    from deepspeed_tpu.models.gpt import GPT as JaxGPT
    from deepspeed_tpu.models.gpt import GPTConfig as JaxConfig
    jcfg = JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32, **MODEL)
    params = JaxGPT(jcfg).init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]
    pcfg = GPTConfig(dtype=torch.float32, **MODEL)
    return {k: v.numpy().copy() for k, v in jax_params_to_state_dict(
        jax.tree.map(np.asarray, params), pcfg).items()}


@functools.lru_cache(None)
def _jax_losses(cp_impl):
    from deepspeed_tpu.parallel import mesh as mesh_lib
    from test_sequence_parallel import _train
    try:
        return _train(2, steps=STEPS, cp_impl=cp_impl)[1]
    finally:
        mesh_lib.reset_global_mesh()


def _sp1(micros, steps=STEPS, config=None, load_dir=None):
    """The port at sp 1 in this process: losses and the gathered state."""
    engine = helpers.port_engine(
        helpers.port_model(_state(), **MODEL, remat=True),
        config or _engine_config(1, 1))
    if load_dir is not None:
        engine.load_checkpoint(load_dir)
    losses, _ = helpers.train(engine, micros, steps, 1)
    return losses, helpers.engine_state(engine)[0]


def _sp_model(cp_impl, **extra):
    return dict(MODEL, remat=True, sequence_parallel=True, cp_impl=cp_impl,
                **extra)


def _train_case(cp_impl, dp, stage=0, micros=None, **kw):
    return dict(dict(model=_sp_model(cp_impl),
                     config=_engine_config(dp, 2, stage), state=_state(),
                     micros=micros or _micros(), steps=STEPS), **kw)


def _attention_inputs(seed, heads):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 16, heads, 8)).astype(np.float32)
            for _ in range(4)]


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sp_ckpt"))


@pytest.fixture(scope="module")
def two():
    x, w = _attention_inputs(1, 4)[:2]
    q, k, v, dout = _attention_inputs(2, 3)
    micros = _micros(mask=True)
    configs = {
        "zero3": ({}, _engine_config(1, 2, 3)),
        "offload": ({}, _engine_config(1, 2, 2, zero_optimization={
            "stage": 2, "offload_optimizer": {"device": "cpu"}})),
        "not_sp": ({"sequence_parallel": False}, _engine_config(1, 2)),
    }
    train = {f"{cp}": _train_case(cp, 1) for cp in ("ulysses", "ring")}
    train["mask"] = _train_case("ulysses", 1, micros=micros)
    calls = {
        "exchange": ("exchange", dict(x=x, w=w)),
        "odd_heads": ("odd_heads", dict(q=q, k=k, v=v, dout=dout)),
        "prefill": ("prefill", dict(state=_state(), model=_sp_model(
            "ulysses"), ids=_micros(1)[0]["input_ids"][:2, :48])),
        "refusals": ("refusals", dict(state=_state(),
                                      model=_sp_model("ulysses"),
                                      configs=configs)),
        "train": ("train", dict(cases=train)),
    }
    return helpers.run_ranks("torch_sp_helpers:cases", 2, timeout=300.0,
                             calls=calls)


@pytest.fixture(scope="module")
def four(tmp_dir):
    train = {f"{cp}": _train_case(cp, 2) for cp in ("ulysses", "ring")}
    for stage in (1, 2):
        train[f"ulysses_stage{stage}"] = _train_case("ulysses", 2, stage)
    train["save"] = _train_case("ring", 2, 1, save_dir=tmp_dir,
                                config=_engine_config(
                                    2, 2, 1, sharded_checkpoint=True))
    configs = {name: ({}, dict(_engine_config(1, 2), mesh=mesh))
               for name, mesh in (("tp_x_sp", {"sp": 2, "tp": 2}),
                                  ("ep_x_sp", {"sp": 2, "ep": 2}))}
    calls = {"train": ("train", dict(cases=train)),
             "refusals": ("refusals", dict(state=_state(),
                                           model=_sp_model("ulysses"),
                                           configs=configs))}
    return helpers.run_ranks("torch_sp_helpers:cases", 4, timeout=300.0,
                             calls=calls)


# --------------------------------------------------------------------------
# The Ulysses exchanges
# --------------------------------------------------------------------------

def test_ulysses_exchanges(two):
    x, w = _attention_inputs(1, 4)[:2]
    s, hl = x.shape[1] // 2, x.shape[2] // 2
    for r, got in enumerate(two):
        res = got["exchange"]
        heads = x[:, :, r * hl:(r + 1) * hl]
        np.testing.assert_array_equal(res["heads"], heads)
        np.testing.assert_array_equal(res["stacked"],
                                      np.stack([heads, 2 * heads]))
        np.testing.assert_array_equal(res["back"], x[:, r * s:(r + 1) * s])
        # the grad of sum(seq_to_heads(x) * w_heads): w's rows of the
        # rank's chunk, every head (heads_to_seq of the head-sharded w)
        np.testing.assert_array_equal(res["grad"], w[:, r * s:(r + 1) * s])


def test_heads_sp_does_not_divide(two):
    """3 heads at sp 2: the sequence is gathered, every head attends over
    it and each rank keeps its rows; outputs and grads are plain causal
    attention's (masked einsum, f32: the same sums)."""
    from deepspeed_tpu_torch.models.gpt import causal_attention
    q, k, v, dout = (torch.from_numpy(t) for t in _attention_inputs(2, 3))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = causal_attention(q, k, v, dtype=torch.float32, impl="xla")
    (out * dout).sum().backward()
    s = q.shape[1] // 2
    for r, got in enumerate(two):
        res = got["odd_heads"]
        rows = slice(r * s, (r + 1) * s)
        np.testing.assert_allclose(res["out"], out[:, rows].detach().numpy(),
                                   rtol=0, atol=1e-6)
        for name, t in (("dq", q), ("dk", k), ("dv", v)):
            np.testing.assert_allclose(res[name], t.grad[:, rows].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
        assert len(res["warnings"]) == 1
        assert "not divisible by sp=2" in res["warnings"][0]


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

@functools.lru_cache(None)
def _sp1_run(mask=False):
    return _sp1(_micros(mask=mask))


@pytest.mark.parametrize("cp_impl", ["ulysses", "ring"])
@pytest.mark.parametrize("mesh", ["sp2", "dp2_sp2"])
def test_losses_equal_sp1_and_jax(two, four, mesh, cp_impl):
    ranks = two if mesh == "sp2" else four
    ref, _ = _sp1_run()
    want = _jax_losses(cp_impl)
    for got in ranks:
        res = got["train"][cp_impl]
        assert (res["dp"], res["tp"]) == ((1 if mesh == "sp2" else 2), 1)
        np.testing.assert_allclose(res["losses"], ref, **LOSS_TOL)
        np.testing.assert_allclose(res["losses"], want, **LOSS_TOL)
    assert len({tuple(g["train"][cp_impl]["losses"]) for g in ranks}) == 1


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_zero_stages_at_dp2_sp2(four, stage):
    ref, master = _sp1_run()
    name = "ulysses" if stage == 0 else f"ulysses_stage{stage}"
    for got in four:
        res = got["train"][name]
        np.testing.assert_allclose(res["losses"], ref, **LOSS_TOL)
        helpers.close_masters(res["master"], master)


def test_labels_cross_the_shard_boundary():
    """``_sp_labels`` on a global batch: a rank's last column's label is
    the next rank's first token, the row's last position is masked, a
    ``loss_mask`` of S or S - 1 columns is kept on the others."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    ids = np.arange(16).reshape(2, 8)
    fake = types.SimpleNamespace(sp_world_size=2)
    got = DeepSpeedEngine._sp_labels(fake, {"input_ids": ids})
    np.testing.assert_array_equal(got["labels"][:, :7].numpy(), ids[:, 1:])
    assert got["labels"][0, 3] == ids[0, 4]        # across the boundary
    np.testing.assert_array_equal(got["loss_mask"].numpy(),
                                  [[1] * 7 + [0]] * 2)
    mask = np.ones((2, 7), np.float32)
    mask[1, 2] = 0
    got = DeepSpeedEngine._sp_labels(fake, {"input_ids": ids,
                                           "loss_mask": mask})
    np.testing.assert_array_equal(got["loss_mask"].numpy()[:, :7], mask)
    assert got["loss_mask"][:, 7].sum() == 0
    labels = ids + 1                                # given: kept as is
    got = DeepSpeedEngine._sp_labels(fake, {"input_ids": ids,
                                           "labels": labels})
    np.testing.assert_array_equal(got["labels"], labels)
    assert got["loss_mask"].sum() == 16
    with pytest.raises(ValueError, match="does not divide"):
        DeepSpeedEngine._sp_labels(fake, {"input_ids": ids[:, :7]})


def test_loss_mask_trains_as_at_sp1(two):
    ref, _ = _sp1_run(mask=True)
    for got in two:
        np.testing.assert_allclose(got["train"]["mask"]["losses"], ref,
                                   **LOSS_TOL)
    # the mask is not all ones: the losses are not the unmasked run's
    assert not np.allclose(ref, _sp1_run()[0], rtol=0, atol=1e-3)


def test_checkpoint_saved_at_sp2_loads_at_sp1(four, tmp_dir):
    micros = _micros()
    losses, _ = _sp1(micros[STEPS:], steps=2,
                     config=_engine_config(1, 1, 1), load_dir=tmp_dir)
    for got in four:
        np.testing.assert_allclose(got["train"]["save"]["after_save"],
                                   losses, **LOSS_TOL)


# --------------------------------------------------------------------------
# Prefill, serving
# --------------------------------------------------------------------------

def test_prefill_over_sp2_is_sp1_by_chunks(two):
    model = helpers.port_model(_state(), **_sp_model("ulysses"))
    ids = torch.from_numpy(_micros(1)[0]["input_ids"][:2, :48]).long()
    with torch.inference_mode():
        hidden, ks, vs = model.prefill(ids)
    for name, want, dim in (("hidden", hidden, 1), ("k", ks, 2),
                            ("v", vs, 2)):
        got = np.concatenate([g["prefill"][name] for g in two], dim)
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    for got in two:
        assert "ROADMAP A9" in got["prefill"]["decode"]


@pytest.fixture(scope="module")
def serving():
    """The JAX test's tiny model (tests/test_fused_prefill.py::_tiny) in
    both packages, and its prompts."""
    from test_fused_prefill import _tiny
    jmodel, params = _tiny()
    cfg = GPTConfig(dtype=torch.float32,
                    **{f.name: getattr(jmodel.cfg, f.name)
                       for f in dataclasses.fields(jmodel.cfg)
                       if f.name in ("vocab_size", "max_seq_len",
                                     "num_layers", "num_heads", "d_model",
                                     "d_ff", "remat")})
    pmodel = GPT(cfg)
    pmodel.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, params), cfg))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
               for n in [3, 7, 5, 9, 4, 13, 6, 11]]
    return jmodel, params, pmodel, prompts


SERVE = dict(max_batch=3, max_prompt_len=16, max_queue=16, decode_chunk=4)


def _served(eng, prompts):
    out = eng.run([p.copy() for p in prompts], max_new_tokens=8)
    assert all(r.status == "done" for r in out)
    return [r.output_ids.tolist() for r in out]


def test_sp_threshold_route(serving):
    from deepspeed_tpu.serving import ServingEngine as JaxServing
    from deepspeed_tpu_torch import ServingEngine
    jmodel, params, pmodel, prompts = serving
    route = dict(fused_prefill=True, prefill_chunk=4, sp_prefill_threshold=9)
    want = _served(JaxServing(jmodel, model_parameters=params,
                              dtype=jnp.float32, **SERVE, **route), prompts)
    short = sum(len(p) for p in prompts if len(p) < 9)
    plain = _served(ServingEngine(pmodel, device="cpu", dtype=torch.float32,
                                  **SERVE), prompts)
    assert plain == want
    for extra in ({}, dict(paged=True, kv_block_size=8)):
        eng = ServingEngine(pmodel, device="cpu", dtype=torch.float32,
                            **SERVE, **route, **extra)
        assert _served(eng, prompts) == want
        assert eng.inline_prefill_tokens == short
        assert eng.sp_prefill_tokens == sum(len(p) for p in prompts) - short
    # the bucketed engine's sp leg
    eng = ServingEngine(pmodel, device="cpu", dtype=torch.float32, **SERVE,
                        sp_prefill_threshold=9)
    assert _served(eng, prompts) == want
    assert (eng.sp_prefill_tokens, eng.inline_prefill_tokens) == (
        sum(len(p) for p in prompts) - short, 0)
    assert any(len(key) == 3 for key in eng._prefill_shapes)


def test_sp_lane_cost(serving):
    from deepspeed_tpu_torch import ServingEngine
    from deepspeed_tpu_torch.serving import Request
    pmodel = serving[2]
    long, short = (Request(prompt=np.arange(n, dtype=np.int32))
                   for n in (12, 6))
    for spec, cost in ((False, 1), (True, 4)):
        eng = ServingEngine(pmodel, device="cpu", dtype=torch.float32,
                            **SERVE, fused_prefill=True, prefill_chunk=4,
                            sp_prefill_threshold=9, speculative=spec,
                            spec_k=3)
        assert eng._lane_cost(long) == cost
        assert eng._lane_cost(short) == 4


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def test_refusals(two, four):
    from deepspeed_tpu.models.gpt import GPTConfig as JaxConfig
    for cfg in (JaxConfig, GPTConfig):
        with pytest.raises(ValueError, match="cp_impl"):
            cfg(sequence_parallel=True, cp_impl="zigzag")
    assert GPTConfig(sequence_parallel=True, cp_impl="ring").cp_impl == "ring"
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        GPTConfig(sequence_parallel=True, moe=True, num_experts=2)
    for got in two:
        res = got["refusals"]
        for name in ("zero3", "offload", "split_tp"):
            assert res[name].startswith("NotImplementedError"), name
            assert "ROADMAP A9" in res[name], name
        assert res["not_sp"].startswith("ValueError")
        assert "sequence_parallel=True" in res["not_sp"]
    for got in four:
        for name in ("tp_x_sp", "ep_x_sp"):
            assert "ROADMAP A9" in got["refusals"][name], name
