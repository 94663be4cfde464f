"""The port's training path on the CPU against the TPU package's, f32, tiny
sizes (torch_port_helpers.TINY), inputs from numpy seeds:

  * model: loss and every parameter grad of ``GPT.forward`` +
    ``lm_loss_fn`` against the JAX model with ``attention_impl="pallas"``
    (the flash kernel in interpret mode; "auto" would be the einsum on the
    CPU) and with ``attention_impl="sparse"`` (a BigBird layout, the sparse
    kernels in interpret mode), with and without remat; the sparse model's
    causality through a bidirectional layout; ``lm_loss_fn`` with labels
    and a loss mask; ``gpt_flops_per_token`` and ``count_params``;
  * optimizer: ``fused_adam`` trajectories over 5 steps;
  * config, schedules and loss scaling: the same dicts give the same batch
    triple and the same errors, the same lr over 50 steps, the same scale
    trajectory;
  * engine: ``initialize`` + 3 x ``train_batch`` against the JAX engine
    (losses, grad norms, Adam moments; and a sparse model's losses and grad
    norms); the 3-call API against
    ``train_batch``; every unported knob raises.

Tolerances: 1e-5 (relative where stated) -- both sides are f32 and differ
in summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import TINY, model_pair

RTOL = 1e-5
SEQ = 32


def _ids(seed, rows=4, seq=SEQ):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (rows, seq)).astype(np.int32)


def _state_dict_np(tree, cfg):
    from deepspeed_tpu_torch.convert import jax_params_to_state_dict
    return {k: v.numpy() for k, v in jax_params_to_state_dict(
        jax.tree.map(np.asarray, tree), cfg).items()}


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    from deepspeed_tpu.models.gpt import lm_loss_fn as jax_loss
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    jmodel, params, pmodel = model_pair(seed=5, attention_impl="pallas",
                                        remat=remat)
    assert pmodel.cfg.remat == remat
    ids = _ids(6)
    jl, jg = jax.value_and_grad(lambda p: jax_loss(
        jmodel.apply({"params": p}, jnp.asarray(ids)),
        {"input_ids": jnp.asarray(ids)}))(params)
    t = torch.from_numpy(ids).long()
    loss = lm_loss_fn(pmodel(t), {"input_ids": t})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    want = _state_dict_np(jg, pmodel.cfg)        # grads map like params
    for name, p in pmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("with_mask", [False, True])
def test_lm_loss_with_labels_matches_jax(with_mask):
    from deepspeed_tpu.models.gpt import lm_loss_fn as jax_loss
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((3, 10, 50)).astype(np.float32) * 3
    batch = {"input_ids": rng.integers(0, 50, (3, 10)),
             "labels": rng.integers(0, 50, (3, 10))}
    if with_mask:
        batch["loss_mask"] = (rng.random((3, 12)) > 0.4).astype(np.float32)
    want = jax_loss(jnp.asarray(logits),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    got = lm_loss_fn(torch.from_numpy(logits),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_flops_and_param_count_match_jax():
    from deepspeed_tpu.models import gpt as jgpt
    from deepspeed_tpu_torch.models import gpt as pgpt
    for preset in ("gpt2_125m", "gpt2_1_3b", "gpt_neox_6_7b"):
        jcfg, pcfg = getattr(jgpt, preset)(), getattr(pgpt, preset)()
        for seq in (None, 1024, 77):
            assert pgpt.gpt_flops_per_token(pcfg, seq) == \
                jgpt.gpt_flops_per_token(jcfg, seq)
    _, params, pmodel = model_pair(seed=0)
    assert pgpt.count_params(pmodel) == jgpt.count_params(params)


def test_attention_impls_agree_and_sparse_raises():
    """flash, auto, the einsum and sparse attention over a dense layout (a
    bidirectional one: causal is forced) agree; "sparse" without a layout
    raises."""
    from deepspeed_tpu_torch.models.gpt import GPTConfig, causal_attention
    from deepspeed_tpu_torch.ops.sparse_attention import DenseSparsityConfig
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, 64))
                                .astype(np.float32)) for _ in range(3))
    flash = causal_attention(q, k, v, dtype=torch.float32, impl="pallas")
    auto = causal_attention(q, k, v, dtype=torch.float32, impl="auto")
    xla = causal_attention(q, k, v, dtype=torch.float32, impl="xla")
    sparse = causal_attention(
        q, k, v, dtype=torch.float32, impl="sparse",
        sparse_config=DenseSparsityConfig(num_heads=2, block=8))
    assert torch.equal(flash, auto)
    np.testing.assert_allclose(flash.numpy(), xla.numpy(), atol=1e-6)
    np.testing.assert_allclose(sparse.numpy(), xla.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="sparse_config"):
        causal_attention(q, k, v, dtype=torch.float32, impl="sparse")
    with pytest.raises(ValueError, match="SparsityConfig"):
        GPTConfig(attention_impl="sparse")


# the long-context case's layout family at the tiny size: BigBird, block 16,
# bidirectional (the model forces causal)
SPARSE = ("BigBirdSparsityConfig", dict(num_heads=TINY["num_heads"],
                                        block=16, num_random_blocks=1))
SPARSE_SEQ = TINY["max_seq_len"]


@pytest.mark.parametrize("remat", [False, True])
def test_sparse_logits_loss_and_grads_match_jax(remat):
    from deepspeed_tpu.models.gpt import lm_loss_fn as jax_loss
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    jmodel, params, pmodel = model_pair(seed=21, sparse=SPARSE, remat=remat)
    ids = _ids(22, rows=2, seq=SPARSE_SEQ)
    jlogits = jmodel.apply({"params": params}, jnp.asarray(ids))
    jl, jg = jax.value_and_grad(lambda p: jax_loss(
        jmodel.apply({"params": p}, jnp.asarray(ids)),
        {"input_ids": jnp.asarray(ids)}))(params)
    t = torch.from_numpy(ids).long()
    logits = pmodel(t)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-5)
    loss = lm_loss_fn(logits, {"input_ids": t})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL)
    want = _state_dict_np(jg, pmodel.cfg)
    for name, p in pmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_sparse_gpt_is_causal_even_with_bidirectional_layout():
    """A future-token change leaves every earlier logit alone."""
    _, _, pmodel = model_pair(seed=0, sparse=SPARSE)
    ids = _ids(23, rows=1, seq=SPARSE_SEQ)
    ids_b = ids.copy()
    ids_b[0, -1] = (ids_b[0, -1] + 1) % TINY["vocab_size"]
    with torch.no_grad():
        a = pmodel(torch.from_numpy(ids).long())
        b = pmodel(torch.from_numpy(ids_b).long())
    np.testing.assert_allclose(a[0, :-1].numpy(), b[0, :-1].numpy(),
                               rtol=0, atol=1e-6)
    assert not torch.equal(a[0, -1], b[0, -1])


def test_prefill_stays_on_the_masked_einsum(monkeypatch):
    """The serving prefill never reaches flash attention (the TPU serving
    prefill runs the cache einsum); the training forward does."""
    from deepspeed_tpu_torch.models import gpt as pgpt
    calls = []
    real = pgpt.flash_attention
    monkeypatch.setattr(pgpt, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _, _, pmodel = model_pair(seed=0)
    ids = torch.from_numpy(_ids(1, rows=2, seq=12)).long()
    with torch.no_grad():
        hidden, _, _ = pmodel.prefill(ids)
        assert not calls
        logits = pmodel(ids)
        assert len(calls) == pmodel.cfg.num_layers
        np.testing.assert_allclose(pmodel.logits(hidden).numpy(),
                                   logits.numpy(), atol=1e-5)


# --------------------------------------------------------------------------
# Optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adamw", "adam", "no_bias_correction"])
def test_fused_adam_trajectory_matches_jax(kind):
    from deepspeed_tpu.ops.adam import fused_adam as jax_adam
    from deepspeed_tpu_torch.ops.adam import fused_adam
    kw = dict(betas=(0.9, 0.95), eps=1e-6, weight_decay=0.01,
              adam_w_mode=kind != "adam",
              bias_correction=kind != "no_bias_correction")
    lr = lambda count: 1e-2 / count                    # noqa: E731
    rng = np.random.default_rng(9)
    shapes = [(7, 5), (5,), (3, 2, 4)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    jopt = jax_adam(lr, **kw)
    jp = [jnp.asarray(x) for x in init]
    js = jopt.init(jp)
    params = [torch.from_numpy(x.copy()) for x in init]
    opt = fused_adam(params, lr, **kw)
    for g in grads:
        upd, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(x) for x in g])
        for a, b in zip(params, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=1e-7)
    assert opt.count == int(js.count) == 5
    for m, jm in zip(opt.mu + opt.nu, list(js.mu) + list(js.nu)):
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=RTOL,
                                   atol=1e-9)


# --------------------------------------------------------------------------
# Config, schedules, loss scaling
# --------------------------------------------------------------------------

CONFIGS = [
    ({"train_batch_size": 32}, 4),
    ({"train_batch_size": 32, "gradient_accumulation_steps": 2}, 4),
    ({"train_micro_batch_size_per_gpu": 3, "gradient_accumulation_steps": 5},
     2),
    ({"train_batch_size": 48, "train_micro_batch_size_per_gpu": 2}, 8),
    ({"train_micro_batch_size_per_gpu": 8}, 1),
    ({}, 2),
    ({"train_batch_size": 16, "bf16": {"enabled": True},
      "zero_optimization": {"stage": 1, "stage3_prefetch_bucket_size": 10},
      "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
      "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 5}},
      "# comment": "ignored"}, 1),
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_config_batch_triple_matches_jax(i):
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch import DeepSpeedConfig
    raw, dp = CONFIGS[i]
    j, p = JaxConfig(raw, dp_world_size=dp), DeepSpeedConfig(raw,
                                                              dp_world_size=dp)
    triple = lambda c: (c.train_batch_size,                  # noqa: E731
                        c.train_micro_batch_size_per_gpu,
                        c.gradient_accumulation_steps, c.zero_optimization_stage,
                        c.zero_config.prefetch_bucket_size)
    assert triple(p) == triple(j)
    assert p.compute_dtype == {jnp.bfloat16: torch.bfloat16,
                               jnp.float32: torch.float32}[j.compute_dtype]


BAD = [
    {"train_batch_sise": 8},
    {"train_batch_size": 8, "zero_optimization": {"stagee": 1}},
    {"train_batch_size": 8, "fp16": {"enabled": True, "loss_scal": 0}},
    {"train_batch_size": 8, "fp16": {"enabled": True},
     "bf16": {"enabled": True}},
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 3,
     "gradient_accumulation_steps": 2},
    {"train_batch_size": 8, "zero_optimization": {"stage": 4}},
    {"train_batch_size": 8, "zero_optimization": {
        "prefetch_bucket_size": 1, "stage3_prefetch_bucket_size": 2}},
    {"train_batch_size": 8, "optimizer": 3},
]


@pytest.mark.parametrize("i", range(len(BAD)))
def test_config_errors_match_jax(i):
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JaxError
    from deepspeed_tpu_torch import DeepSpeedConfig, DeepSpeedConfigError
    with pytest.raises(JaxError) as jerr:
        JaxConfig(BAD[i], dp_world_size=1)
    with pytest.raises(DeepSpeedConfigError) as perr:
        DeepSpeedConfig(BAD[i], dp_world_size=1)
    assert str(perr.value) == str(jerr.value)


SCHEDULES = [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 20}),
    ("WarmupLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 20,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 40, "warmup_num_steps": 10,
                       "warmup_max_lr": 2e-3}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_step_rate": 0.5,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 10, "cycle_second_step_size": 15,
                  "cycle_first_stair_count": 3, "decay_lr_rate": 0.1,
                  "decay_step_size": 4}),
]


@pytest.mark.parametrize("i", range(len(SCHEDULES)))
def test_schedules_match_jax(i):
    from deepspeed_tpu.runtime.config import SchedulerConfig as JaxSched
    from deepspeed_tpu.runtime.lr_schedules import build_lr_scheduler as jb
    from deepspeed_tpu_torch.runtime.config import SchedulerConfig
    from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_scheduler
    name, params = SCHEDULES[i]
    js = jb(JaxSched(type=name, params=dict(params)))
    ps = build_lr_scheduler(SchedulerConfig(type=name, params=dict(params)))
    for step in range(50):
        np.testing.assert_allclose(
            ps.lr_at(step), float(js.lr_at(jnp.asarray(step, jnp.float32))),
            rtol=1e-6, err_msg=f"{name} step {step}")
        ps.step()
        js.step()
    assert ps.get_last_lr() == pytest.approx(js.get_last_lr(), rel=1e-6)
    assert ps.state_dict() == js.state_dict()


def test_loss_scale_trajectory_matches_jax():
    from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
    from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as pls
    seq = [True] * 3 + [False] + [True] * 2 + [False] * 3 + [True] * 9 \
        + [False, True, False, False] + [True] * 8
    kw = dict(scale_window=4, min_scale=2.0, hysteresis=2)
    for dynamic in (True, False):
        js = jls.make_loss_scale_state(initial_scale_power=6, hysteresis=2)
        ps = pls.make_loss_scale_state(initial_scale_power=6, hysteresis=2)
        for finite in seq:
            js = jls.update_scale(js, jnp.asarray(finite), dynamic=dynamic,
                                  **kw)
            ps = pls.update_scale(ps, finite, dynamic=dynamic, **kw)
            assert tuple(ps) == tuple(float(x) if i == 0 else int(x)
                                      for i, x in enumerate(js))
    g = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert not bool(pls.grads_finite(g))
    assert bool(pls.grads_finite(g[:1]))


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

ENGINE_CONFIG = {
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "steps_per_print": 100,
    "zero_optimization": {"stage": 1},
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_max_lr": 1e-3, "warmup_num_steps": 4}},
}
GLOBAL_MICRO = 8          # the JAX test mesh runs dp=8: 1 row per device


def _micros(n, seed=12):
    return [{"input_ids": _ids(seed + i, rows=GLOBAL_MICRO)}
            for i in range(n)]


def _port_engine(pmodel, **overrides):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    cfg = dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=GLOBAL_MICRO,
               **overrides)
    return dst.initialize(model=pmodel, model_parameters=pmodel.parameters(),
                          loss_fn=lm_loss_fn, config=cfg, device="cpu")


def test_engine_matches_jax_engine():
    import deepspeed_tpu as ds
    from deepspeed_tpu.models.gpt import lm_loss_fn as jax_loss
    jmodel, params, pmodel = model_pair(seed=13, attention_impl="pallas")
    jeng, *_ = ds.initialize(
        model=jmodel, model_parameters=params, loss_fn=jax_loss,
        config=dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=1))
    assert jeng.dp_world_size * 1 == GLOBAL_MICRO
    peng, opt, loader, sched = _port_engine(pmodel)
    assert opt is peng.optimizer and sched is peng.lr_scheduler
    assert loader is None
    micros = _micros(6)
    for step in range(3):
        batch = micros[2 * step:2 * step + 2]
        jl = float(jeng.train_batch(iter(batch)))
        pl = float(peng.train_batch(iter(batch)))
        np.testing.assert_allclose(pl, jl, rtol=RTOL)
        np.testing.assert_allclose(peng.get_global_grad_norm(),
                                   float(jeng.get_global_grad_norm()),
                                   rtol=RTOL)
        np.testing.assert_allclose(peng.get_lr(), jeng.get_lr(), rtol=1e-6)
    assert peng.global_steps == 3 and peng.micro_steps == 6
    assert peng.global_samples == jeng.global_samples == 48
    # Adam moments: the JAX moment trees map like the params
    jopt = jeng.state["opt"]
    for tree, mine in ((jopt.mu, opt.mu), (jopt.nu, opt.nu)):
        want = _state_dict_np(tree, pmodel.cfg)
        for (name, _), m in zip(pmodel.named_parameters(), mine):
            scale = np.abs(want[name]).max()
            np.testing.assert_allclose(m.numpy(), want[name], rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=name)


def test_sparse_engine_matches_jax_engine():
    """3 x train_batch of a sparse GPT (BigBird layout, remat on) against
    the JAX engine: losses and grad norms."""
    import deepspeed_tpu as ds
    from deepspeed_tpu.models.gpt import lm_loss_fn as jax_loss
    jmodel, params, pmodel = model_pair(seed=24, sparse=SPARSE, remat=True)
    jeng, *_ = ds.initialize(
        model=jmodel, model_parameters=params, loss_fn=jax_loss,
        config=dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=1))
    peng, *_ = _port_engine(pmodel)
    micros = [{"input_ids": _ids(40 + i, rows=GLOBAL_MICRO, seq=SPARSE_SEQ)}
              for i in range(6)]
    for step in range(3):
        batch = micros[2 * step:2 * step + 2]
        jl = float(jeng.train_batch(iter(batch)))
        pl = float(peng.train_batch(iter(batch)))
        np.testing.assert_allclose(pl, jl, rtol=RTOL)
        np.testing.assert_allclose(peng.get_global_grad_norm(),
                                   float(jeng.get_global_grad_norm()),
                                   rtol=1e-4)


def test_three_call_api_equals_train_batch():
    _, _, a = model_pair(seed=14)
    _, _, b = model_pair(seed=14)
    ea, *_ = _port_engine(a)
    eb, *_ = _port_engine(b)
    micros = _micros(4, seed=30)
    for step in range(2):
        batch = micros[2 * step:2 * step + 2]
        want = ea.train_batch(iter(batch))
        losses = []
        for micro in batch:
            loss = eb(micro)
            eb.backward(loss)
            assert eb.is_gradient_accumulation_boundary() == (
                micro is batch[-1])
            eb.step()
            losses.append(float(loss.detach()))
        np.testing.assert_allclose(np.mean(losses), float(want), rtol=1e-6)
        assert eb.get_global_grad_norm() == pytest.approx(
            ea.get_global_grad_norm(), rel=1e-6)
    assert eb.global_steps == ea.global_steps == 2
    for p, q in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)
    # eval on the trained params; no grads, no state change
    before = [p.clone() for p in b.parameters()]
    ev = eb.eval_batch(micros[0])
    assert ev.dim() == 0 and torch.isfinite(ev)
    assert all(torch.equal(p, q) for p, q in zip(before, b.parameters()))


def test_bf16_engine_trains_and_keeps_fp32_masters():
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    model = GPT(GPTConfig(**TINY, dtype=torch.bfloat16, remat=True))
    model.init_weights(torch.Generator().manual_seed(0))
    eng, *_ = _port_engine(model, bf16={"enabled": True})
    assert eng.compute_dtype == torch.bfloat16
    assert eng.compute_module is not eng.module
    micros = _micros(2)
    losses = [float(eng.train_batch(iter(micros))) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in eng.module.parameters())
    assert all(p.dtype == torch.bfloat16
               for p in eng.compute_module.parameters())


def test_training_data_and_dataloader():
    from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                        RepeatingLoader)
    data = [{"input_ids": row} for row in _ids(40, rows=20)]
    loader = DeepSpeedDataLoader(data, batch_size=8, drop_last=False)
    assert len(loader) == 3
    batches = list(loader)
    assert batches[0]["input_ids"].shape == (8, SEQ)
    assert batches[-1]["input_ids"].shape == (4, SEQ)
    rep = RepeatingLoader(loader)
    assert [next(rep)["input_ids"].shape[0] for _ in range(4)] == [8, 8, 4, 8]
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    _, _, pmodel = model_pair(seed=15)
    eng, _, dl, _ = dst.initialize(
        model=pmodel, training_data=data, loss_fn=lm_loss_fn, device="cpu",
        config=dict(ENGINE_CONFIG, train_micro_batch_size_per_gpu=4,
                    dataloader_drop_last=True))
    assert isinstance(dl, DeepSpeedDataLoader) and len(dl) == 5
    assert np.isfinite(float(eng.train_batch()))
    assert eng.global_samples == 8


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def test_initialize_on_cuda_without_cuda_raises(monkeypatch):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, pmodel = model_pair(seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dst.initialize(model=pmodel, loss_fn=lm_loss_fn,
                       config={"train_batch_size": 8})
    assert next(pmodel.parameters()).device.type == "cpu"


UNPORTED = {
    "zero2": {"zero_optimization": {"stage": 2}},
    "zero3": {"zero_optimization": {"stage": 3}},
    "offload_optimizer": {"zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu"}}},
    "offload_param": {"zero_optimization": {
        "stage": 1, "offload_param": {"device": "cpu"}}},
    "lamb": {"optimizer": {"type": "Lamb", "params": {}}},
    "adagrad": {"optimizer": {"type": "Adagrad", "params": {}}},
    "sgd": {"optimizer": {"type": "SGD", "params": {}}},
    "onebitadam": {"optimizer": {"type": "OneBitAdam", "params": {}}},
    "pld": {"progressive_layer_drop": {"enabled": True}},
    "curriculum": {"curriculum_learning": {"enabled": True}},
    "eigenvalue": {"eigenvalue": {"enabled": True}},
    "moq": {"quantize_training": {"enabled": True}},
    "flops_profiler": {"flops_profiler": {"enabled": True}},
    "tensorboard": {"tensorboard": {"enabled": True}},
    "csv_monitor": {"csv_monitor": {"enabled": True}},
    "stochastic_rounding": {"bf16": {"enabled": True,
                                     "stochastic_rounding": True}},
    "tp_mesh": {"mesh": {"tp": 2}},
    "pipeline": {"pipeline": {"stages": 2}},
    "cpu_checkpointing": {"activation_checkpointing": {
        "cpu_checkpointing": True}},
    "elasticity": {"elasticity": {"enabled": True}},
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_knob_raises(name):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    _, _, pmodel = model_pair(seed=0)
    cfg = {"train_micro_batch_size_per_gpu": 2, **UNPORTED[name]}
    if name == "elasticity":
        cfg.pop("train_micro_batch_size_per_gpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dst.initialize(model=pmodel, loss_fn=lm_loss_fn, config=cfg,
                       device="cpu")


def test_unported_calls_raise(monkeypatch):
    import torch.distributed as dist
    _, _, pmodel = model_pair(seed=0)
    eng, *_ = _port_engine(pmodel)
    for call in (eng.save_checkpoint, eng.load_checkpoint):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call("somewhere")
    import deepspeed_tpu_torch as dst
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dst.initialize(model=pmodel, mpu=object(), device="cpu")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="dp > 1"):
        _port_engine(pmodel)


def test_bad_arguments_raise():
    import deepspeed_tpu_torch as dst
    _, _, pmodel = model_pair(seed=0)
    base = {"train_batch_size": 2}
    with pytest.raises(TypeError):
        dst.initialize(model=object(), config=base, device="cpu")
    with pytest.raises(ValueError, match="own parameters"):
        dst.initialize(model=pmodel, config=base, device="cpu",
                       model_parameters=[torch.zeros(3)])
    with pytest.raises(ValueError, match="untested"):
        dst.initialize(model=pmodel, device="cpu",
                       optimizer=torch.optim.SGD(pmodel.parameters(), 0.1),
                       config=dict(base, zero_optimization={"stage": 1}))
    with pytest.raises(ValueError, match="not Adam params"):
        dst.initialize(model=pmodel, device="cpu", config=dict(
            base, optimizer={"type": "Adam", "params": {"amsgrad": True}}))
    with pytest.raises(ValueError, match="amp"):
        dst.initialize(model=pmodel, device="cpu",
                       config=dict(base, amp={"enabled": True}))
