"""The PyTorch port's pipeline (``deepspeed_tpu_torch.runtime.pipe``) in one
process, against the JAX package's.

  * the three schedules yield the JAX schedules' instruction streams for
    every M in 1-8 and S in 1-4;
  * ``partition_balanced`` and ``PipelineModule.parts`` equal JAX's, for
    ``gpt_pipe_specs`` at GPT-2 125M, GPT-2 1.3B and GPT-NeoX 20B widths
    (specs only) under each partition method;
  * ``PipelineEngine`` at pp 1 (every stage in this process) at S 1, 2, 4,
    tied and untied heads: losses within rtol 1e-5 of the JAX engine's on
    the same converted weights (f32: both sum in another order only) and
    final masters within 3e-4, 1% of the 3 lr an Adam element can move in
    3 steps (Adam divides each grad by its own size, so an element whose
    grad is near rounding noise moves by noise; the key third of
    ``qkv.bias``, whose exact grad is 0, is left out); SGD tied-weight
    values; fp16 static and dynamic scaling (fp16 rounding: rtol 2e-3; the same skipped
    steps and scales); bf16 (rtol 2e-2: both round activations to bf16 in
    another order); ``eval_batch``; a checkpoint loaded by a fresh engine
    whose next steps equal the continued ones;
  * ``GPipeSpmdEngine`` at pp 1 against JAX's;
  * the refusals: ZeRO-3, stochastic rounding, LAMB, clipping, pp x tp x
    sp / pp x tp x ep / pp x sp x ep, ``mpu``, and the dense engine's two
    pipeline refusals.

The multi-rank cases are in ``tests/test_torch_pipe_ranks.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import gpt_pipe as jpipe
from deepspeed_tpu.runtime.pipe import module as jmodule
from deepspeed_tpu.runtime.pipe import schedule as jsched
from deepspeed_tpu.runtime.pipe.spmd import GPipeSpmdEngine as JGPipe
from deepspeed_tpu.runtime.pipe.spmd import gpt_pipe_spec as jspec
from torch_test_threads import one_torch_thread  # noqa: F401

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.convert import (jax_params_to_state_dict,
                                         pipe_params_to_state_dict,
                                         state_dict_to_pipe_params)
from deepspeed_tpu_torch.models import gpt as pgpt
from deepspeed_tpu_torch.models import gpt_pipe as ppipe
from deepspeed_tpu_torch.runtime.pipe import (GPipeSpmdEngine,
                                              PipelineModule, gpt_pipe_spec)
from deepspeed_tpu_torch.runtime.pipe import module as pmodule
from deepspeed_tpu_torch.runtime.pipe import schedule as psched
from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine

TINY = dict(vocab_size=64, max_seq_len=16, num_layers=2, num_heads=2,
            d_model=32, d_ff=64)
CONFIG = {"train_micro_batch_size_per_gpu": 4,
          "gradient_accumulation_steps": 4,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
          "mesh": {"dp": 1}}


def _stream(sched):
    return [[(type(c).__name__, c.kwargs) for c in cmds] for cmds in sched]


@pytest.mark.parametrize("kind", ["TrainSchedule", "InferenceSchedule",
                                  "DataParallelSchedule"])
def test_schedules_match_jax(kind):
    for M in range(1, 9):
        for S in range(1, 5):
            for s in range(S):
                a = getattr(psched, kind)(M, S, s)
                b = getattr(jsched, kind)(M, S, s)
                assert _stream(a) == _stream(b), (kind, M, S, s)
                assert a.num_pipe_buffers == b.num_pipe_buffers


def test_partition_balanced_matches_jax():
    rng = np.random.default_rng(0)
    for n in (3, 7, 16, 40):
        for parts in (1, 2, 3, 4, 8):
            if parts > n:
                continue
            w = rng.integers(1, 100, n).astype(float).tolist()
            assert pmodule.partition_balanced(w, parts) == \
                jmodule.partition_balanced(w, parts)


WIDTHS = {"gpt2_125m": (jgpt.gpt2_125m, pgpt.gpt2_125m),
          "gpt2_1_3b": (jgpt.gpt2_1_3b, pgpt.gpt2_1_3b),
          "gpt_neox_20b": (jgpt.gpt_neox_20b, pgpt.gpt_neox_20b)}


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_partitions_match_jax(width):
    jcfg, pcfg = (f() for f in WIDTHS[width])
    for method in ("parameters", "uniform", "type:pipegptblock"):
        for S in (1, 2, 4, 8):
            j = jmodule.PipelineModule(jpipe.gpt_pipe_specs(jcfg), S,
                                       partition_method=method)
            p = PipelineModule(ppipe.gpt_pipe_specs(pcfg), S,
                               partition_method=method)
            assert p.parts == j.parts, (width, method, S)
    want = {"gpt2_1_3b": {2: [0, 13, 27], 4: [0, 6, 13, 20, 27]},
            "gpt2_125m": {2: [0, 7, 15], 4: [0, 2, 7, 12, 15]}}
    for S, parts in want.get(width, {}).items():
        assert ppipe.gpt_pipe_module(pcfg, S).parts == parts


def _jax_cfg(**kw):
    return jgpt.GPTConfig(**dict(TINY, **kw), dtype=jnp.float32,
                          param_dtype=jnp.float32, scan_layers=False,
                          remat=False)


def _port_cfg(**kw):
    return pgpt.GPTConfig(**dict(TINY, **kw), dtype=torch.float32)


def _tokens(seed=0, n=4, bs=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"],
                         (bs, TINY["max_seq_len"])).astype(np.int32)
            for _ in range(n)]


def _batches(micros):
    return iter([(m, m) for m in micros])


def _pair(S, config=CONFIG, method="uniform", **cfg_kw):
    """The JAX engine (built by one eval) and a port engine over its
    converted stage params."""
    je, *_ = ds.initialize(
        model=jpipe.gpt_pipe_module(_jax_cfg(**cfg_kw), num_stages=S,
                                    partition_method=method),
        config=config)
    je.eval_batch(_batches(_tokens(9, 1)))
    stage_params = jax.tree.map(np.asarray, jax.device_get(je.stage_params))
    pm = ppipe.gpt_pipe_module(_port_cfg(**cfg_kw), num_stages=S,
                               partition_method=method)
    assert pm.parts == je.module.parts
    state = pipe_params_to_state_dict(stage_params, pm)
    pe, *_ = dst.initialize(model=pm, config=config, model_parameters=state,
                            device="cpu")
    return je, pe, pm


def _jax_state(je, pm):
    return pipe_params_to_state_dict(
        jax.tree.map(np.asarray, jax.device_get(je.stage_params)), pm)


def _assert_masters_close(pe, je, pm, atol=3e-4):
    want = _jax_state(je, pm)
    got = pe.state_dict()
    assert set(got) == set(want)
    d = TINY["d_model"]
    for k, v in want.items():
        g, w = got[k].numpy().copy(), v.numpy().copy()
        if k.endswith("attn.qkv.bias"):
            g[d:2 * d] = w[d:2 * d] = 0       # exact grad 0: Adam on noise
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("S,tie", [(1, True), (1, False), (2, True),
                                   (2, False), (4, True), (4, False)])
def test_one_process_matches_jax(S, tie):
    kw = dict(tie_embeddings=tie, num_layers=4 if S == 4 else 2)
    je, pe, pm = _pair(S, **kw)
    assert isinstance(pe, PipelineEngine) and pe.local_stages == \
        list(range(S))
    micros = _tokens(n=4)
    lj = [float(je.train_batch(_batches(micros))) for _ in range(3)]
    lp = [float(pe.train_batch(_batches(micros))) for _ in range(3)]
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    _assert_masters_close(pe, je, pm)
    # eval_batch (deterministic forward through every stage)
    batch = (micros[1], micros[1])
    np.testing.assert_allclose(float(pe.eval_batch(batch)),
                               float(je.eval_batch(batch)), rtol=1e-5)
    if tie:
        # the tied replicas stay equal after updates
        sd = pe.state_dict()
        last = pm.num_layers - 1
        np.testing.assert_array_equal(sd["0.wte.weight"],
                                      sd[f"{last}.wte.weight"])


def test_sgd_tied_values_match_jax():
    """SGD is scale-sensitive: tied grads summed twice (or not at all)
    would move the tied table by another factor. The port at S 1 and 2
    against the JAX engine at S 1 (the TPU test's reference)."""
    cfg = dict(CONFIG, gradient_accumulation_steps=2,
               optimizer={"type": "SGD", "params": {"lr": 1e-2}})
    je, pe1, pm1 = _pair(1, config=cfg)
    _, pe2, _ = _pair(2, config=cfg)
    micros = _tokens(3, n=2)
    for _ in range(5):
        je.train_batch(_batches(micros))
        pe1.train_batch(_batches(micros))
        pe2.train_batch(_batches(micros))
    want = _jax_state(je, pm1)["0.wte.weight"].numpy()
    for pe in (pe1, pe2):
        np.testing.assert_allclose(pe.state_dict()["0.wte.weight"], want,
                                   rtol=1e-5, atol=1e-7)


def _fp16_config(loss_scale, init_power=16):
    return dict(CONFIG, fp16={"enabled": True, "loss_scale": loss_scale,
                              "initial_scale_power": init_power,
                              "hysteresis": 1, "loss_scale_window": 4})


def test_fp16_static_scale_matches_jax():
    je, pe, _ = _pair(2, config=_fp16_config(1024))
    micros = _tokens(n=4)
    lj = [float(je.train_batch(_batches(micros))) for _ in range(4)]
    lp = [float(pe.train_batch(_batches(micros))) for _ in range(4)]
    np.testing.assert_allclose(lp, lj, rtol=2e-3)
    assert pe.skipped_steps == je.skipped_steps == 0


def test_fp16_dynamic_scale_skips_like_jax():
    """2^40 overflows fp16: both engines skip the same steps, halve to the
    same scales, and the skipped steps leave the masters untouched."""
    je, pe, _ = _pair(2, config=_fp16_config(0, init_power=40))
    before = {k: v.clone() for k, v in pe.state_dict().items()}
    micros = _tokens(n=4)
    pe.train_batch(_batches(micros))
    je.train_batch(_batches(micros))
    assert pe.skipped_steps == je.skipped_steps >= 1
    for k, v in pe.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    scales_j, scales_p, lj, lp = [], [], [], []
    for _ in range(30):
        lj.append(float(je.train_batch(_batches(micros))))
        lp.append(float(pe.train_batch(_batches(micros))))
        scales_j.append(float(je.scale_state.cur_scale))
        scales_p.append(float(pe.scale_state.cur_scale))
    assert pe.skipped_steps == je.skipped_steps < 31
    assert scales_p == scales_j
    assert np.isfinite(lp[-1])
    np.testing.assert_allclose(lp, lj, rtol=2e-3)


def test_bf16_matches_jax():
    cfg = dict(CONFIG, bf16={"enabled": True})
    je, pe, _ = _pair(2, config=cfg)
    assert pe.compute_layers[0] is not pe.stage_layers[0]
    assert all(p.dtype == torch.float32 for p in pe.stage_layers[0]
               .parameters())
    micros = _tokens(n=4)
    lj = [float(je.train_batch(_batches(micros))) for _ in range(4)]
    lp = [float(pe.train_batch(_batches(micros))) for _ in range(4)]
    np.testing.assert_allclose(lp, lj, rtol=2e-2)
    assert lp[-1] < lp[0]


def test_checkpoint_resume_equals_continuation(tmp_path):
    """Save after 2 steps; a fresh engine (its own init) loads it and its
    next 2 losses equal the continued engine's, bitwise."""
    _, pe, pm = _pair(2)
    micros = _tokens(n=4)
    for _ in range(2):
        pe.train_batch(_batches(micros))
    pe.save_checkpoint(str(tmp_path), tag="p2")
    cont = [float(pe.train_batch(_batches(micros))) for _ in range(2)]
    fresh, *_ = dst.initialize(
        model=ppipe.gpt_pipe_module(_port_cfg(), 2,
                                    partition_method="uniform"),
        config=CONFIG, device="cpu")
    assert fresh.load_checkpoint(str(tmp_path)) == ("p2", {})
    assert fresh.global_steps == 2
    assert [float(fresh.train_batch(_batches(micros)))
            for _ in range(2)] == cont


def test_state_dict_round_trip_and_model_parameters():
    """``model_parameters`` is loaded (the TPU engine ignores it: a
    deliberate divergence), and the conversion runs both ways."""
    je, pe, pm = _pair(2)
    sd = pe.state_dict()
    want = _jax_state(je, pm)
    for k, v in want.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    back = state_dict_to_pipe_params(sd, pm)
    flat_j = jax.tree_util.tree_leaves(jax.device_get(je.stage_params))
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_j) == len(flat_b)
    for a, b in zip(flat_j, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    # a different state dict gives a different engine
    other = {k: v + 1.0 for k, v in sd.items()}
    pe2, *_ = dst.initialize(model=pm, config=CONFIG,
                             model_parameters=other, device="cpu")
    torch.testing.assert_close(pe2.state_dict()["1.ln_1.bias"],
                               other["1.ln_1.bias"])


def test_gpipe_one_stage_matches_jax():
    """``GPipeSpmdEngine`` at pp 1 (this process) against JAX's on the same
    GPT params: losses within 1e-5, the first equal to the dense loss."""
    jcfg = jgpt.GPTConfig(**dict(TINY, num_layers=2), dtype=jnp.float32,
                          param_dtype=jnp.float32, remat=False)
    model = jgpt.GPT(jcfg)
    ids = _tokens(3, n=1, bs=8)[0]
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids[:1]))[
        "params"]
    je = JGPipe(jspec(jcfg), params, num_stages=1, micro_batches=2, dp=1,
                lr=1e-3, remat=False)
    pcfg = _port_cfg()
    state = jax_params_to_state_dict(jax.tree.map(np.asarray, params), pcfg)
    pe = GPipeSpmdEngine(gpt_pipe_spec(pgpt.GPT(pcfg, device="meta")),
                         state, num_stages=1, micro_batches=2, dp=1,
                         lr=1e-3, remat=True, device="cpu")
    micros = [ids[:4], ids[4:]]
    lj = [float(je.train_batch(iter([{"input_ids": m} for m in micros])))
          for _ in range(3)]
    lp = [float(pe.train_batch(iter([{"input_ids": m} for m in micros])))
          for _ in range(3)]
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    dense = float(jgpt.lm_loss_fn(model.apply({"params": params},
                                              jnp.asarray(ids)),
                                  {"input_ids": jnp.asarray(ids)}))
    np.testing.assert_allclose(lp[0], dense, rtol=1e-5)
    np.testing.assert_allclose(float(pe.eval_loss(np.stack(micros))),
                               float(je.eval_loss(np.stack(micros))),
                               rtol=1e-5)


def _refused(config, exc, match, S=2):
    with pytest.raises(exc, match=match):
        dst.initialize(model=ppipe.gpt_pipe_module(
            _port_cfg(), S, partition_method="uniform"), config=config,
            device="cpu")


def test_refusals():
    _refused(dict(CONFIG, zero_optimization={"stage": 3}), ValueError,
             "ZeRO-3 does not compose")
    _refused(dict(CONFIG, bf16={"enabled": True,
                                "stochastic_rounding": True}),
             NotImplementedError, "stochastic_rounding")
    _refused(dict(CONFIG, optimizer={"type": "Lamb",
                                     "params": {"lr": 1e-3}}),
             ValueError, "Adam, AdamW or SGD")
    _refused(dict(CONFIG, gradient_clipping=1.0), ValueError,
             "does not clip")
    # tp and sp inside a stage are ported; two model-parallel axes at once
    # are not (the dense model refuses tp x sp, MoE at tp and MoE with sp)
    for a, b in (("tp", "sp"), ("tp", "ep"), ("sp", "ep")):
        _refused(dict(CONFIG, mesh={a: 2, b: 2}), NotImplementedError,
                 f"pp x {a} x {b}.*ROADMAP A9")
    _refused(dict(CONFIG, mesh={"pp": 3}), ValueError, "mesh pp=3")
    pm = ppipe.gpt_pipe_module(_port_cfg(), 2, partition_method="uniform")
    with pytest.raises(ValueError, match="stores it and never reads it"):
        dst.initialize(model=pm, config=CONFIG, mpu=object(), device="cpu")
    with pytest.raises(ValueError, match="client optimizer"):
        dst.initialize(model=pm, config=CONFIG, device="cpu",
                       optimizer=torch.optim.SGD([torch.zeros(1)], lr=1))


def test_dense_engine_pipeline_refusals():
    """The dense engine reads no pipeline block: ``pipeline.stages`` and a
    pp mesh raise, pointing at ``PipelineModule``."""
    model = pgpt.GPT(_port_cfg())
    for extra, match in (({"pipeline": {"stages": 2}}, "pipeline.stages=2"),
                         ({"mesh": {"pp": 2}}, "a pp mesh")):
        with pytest.raises(ValueError, match=match) as info:
            dst.initialize(model=model, loss_fn=pgpt.lm_loss_fn,
                           config=dict(CONFIG, **extra), device="cpu")
        assert "PipelineModule" in str(info.value)


def test_layer_classes_are_the_dense_blocks():
    """``PipeGPTBlock`` is ``models.gpt.Block`` (the same parameters);
    ``gpt_pipe_state_dict`` lays a dense GPT's weights out so the pipe's
    first loss is the dense model's."""
    cfg = _port_cfg()
    torch.manual_seed(0)
    dense = pgpt.GPT(cfg)
    pm = ppipe.gpt_pipe_module(cfg, 2, partition_method="uniform")
    pe, *_ = dst.initialize(
        model=pm, config=dict(CONFIG, gradient_accumulation_steps=1),
        model_parameters=ppipe.gpt_pipe_state_dict(dense.state_dict(), cfg),
        device="cpu")
    ids = torch.from_numpy(_tokens(5, n=1)[0]).long()
    de, *_ = dst.initialize(model=dense, loss_fn=pgpt.lm_loss_fn,
                            config=dict(CONFIG, gradient_accumulation_steps=1,
                                        mesh={}), device="cpu")
    want = de.train_batch(iter([{"input_ids": ids}]))
    got = pe.train_batch(iter([(ids, ids)]))
    torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=1e-6)
    # the global grad norm counts the tied table once, with both its grads
    np.testing.assert_allclose(pe.get_global_grad_norm(),
                               de.get_global_grad_norm(), rtol=1e-5)
