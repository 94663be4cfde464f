"""The port's function-style checkpointing API and ``cpu_checkpointing``
(deepspeed_tpu_torch/runtime/activation_checkpointing.py, the GPT model's
and the engine's switch) on the CPU, f32, tiny sizes, inputs from numpy
seeds:

  * ``configure`` / ``is_configured`` / ``reset`` and the ``ValueError`` of
    each knob with no mapping, as in the TPU package;
  * ``checkpoint`` and ``checkpoint_in_cpu`` against the function run
    without a checkpoint: outputs and grads bitwise (the recomputation runs
    the same f32 ops on the same inputs), the parameter grads with a frozen
    input too (fault C6), and a forward without its backward freeing its
    host copies;
  * GPT with ``cpu_checkpointing=True``: loss and grads bitwise the port's
    remat (both recompute each block from its input) and, within 1e-5 /
    1e-4 relative (summation order), the JAX GPT with ``cpu_checkpointing``
    on the CPU; ``cpu_checkpointing`` without remat raises ``ValueError``
    in both packages;
  * the engine's ``activation_checkpointing.cpu_checkpointing``: the
    model's config flipped, losses bitwise a remat engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_training import RTOL, _ids, _state_dict_np
from torch_port_helpers import TINY, model_pair
from torch_test_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def ckpt():
    from deepspeed_tpu_torch import checkpointing
    checkpointing.reset()
    yield checkpointing
    checkpointing.reset()


def test_configure_surface(ckpt):
    from deepspeed_tpu.runtime import activation_checkpointing as jckpt
    assert not ckpt.is_configured()
    ckpt.configure(None, partition_activations=True, num_checkpoints=3,
                   checkpoint_in_cpu=True)
    assert ckpt.is_configured()
    assert ckpt._config["checkpoint_in_cpu"]
    assert ckpt._config["partition_activations"]
    ckpt.reset()
    assert not ckpt.is_configured()
    for mod in (ckpt, jckpt):
        mod.configure(None, checkpoint_in_cpu=True)
        assert mod.is_configured()
        mod.reset()
        assert not mod.is_configured()


@pytest.mark.parametrize("knob", ["contiguous_checkpointing", "synchronize",
                                  "profile"])
def test_configure_refuses_like_jax(ckpt, knob):
    from deepspeed_tpu.runtime import activation_checkpointing as jckpt
    with pytest.raises(ValueError, match=knob):
        ckpt.configure(None, **{knob: True})
    with pytest.raises(ValueError, match=knob):
        jckpt.configure(None, **{knob: True})
    assert not ckpt.is_configured()


def _block():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(),
                               torch.nn.Linear(32, 16))


@pytest.mark.parametrize("in_cpu", [False, True])
def test_checkpoint_grads_equal_the_unchecked_function(ckpt, in_cpu):
    ckpt.configure(None, checkpoint_in_cpu=in_cpu)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((4, 16)).astype(np.float32)
    s0 = rng.standard_normal((4, 16)).astype(np.float32)
    results = []
    for checked in (False, True):
        block = _block()
        x = torch.from_numpy(x0).requires_grad_()
        s = torch.from_numpy(s0).requires_grad_()

        def fn(a, b, scale):
            return block(a * scale + b)
        y = ckpt.checkpoint(fn, x, s, 0.5) if checked else fn(x, s, 0.5)
        (y * y).sum().backward()
        results.append([y.detach(), x.grad, s.grad]
                       + [p.grad for p in block.parameters()])
    for got, want in zip(results[1], results[0]):
        assert torch.equal(got, want)
    if in_cpu:
        store = ckpt._store(torch.device("cpu"))
        assert store._live == 0 and store.host == [None, None]


@pytest.mark.parametrize("input_grad", [False, True])
def test_both_modes_give_the_parameter_grads(ckpt, input_grad):
    """Fault C6: a checkpoint reaches the parameters its function closes
    over whether or not its tensor input needs grad, under the default
    (non-reentrant) mode and under checkpoint_in_cpu alike, as
    jax.checkpoint does: every parameter grad bitwise the unchecked
    function's, a frozen input's grad None."""
    x0 = np.random.default_rng(2).standard_normal((4, 16)).astype(np.float32)
    grads = {}
    for mode in ("plain", "default", "in_cpu"):
        ckpt.configure(None, checkpoint_in_cpu=mode == "in_cpu")
        block = _block()
        x = torch.from_numpy(x0).requires_grad_(input_grad)
        y = block(x) if mode == "plain" else ckpt.checkpoint(block, x)
        assert y.requires_grad
        (y * y).sum().backward()
        assert (x.grad is not None) == input_grad
        grads[mode] = [p.grad for p in block.parameters()]
    for mode in ("default", "in_cpu"):
        for got, want in zip(grads[mode], grads["plain"]):
            assert got is not None and torch.equal(got, want), mode


def test_a_forward_without_its_backward_frees_the_store(ckpt):
    """The host copies of a checkpoint_in_cpu forward belong to its graph:
    dropping the output without a backward frees them (the store keeps no
    copy for the life of the configuration), and the next forward and
    backward run as usual."""
    import gc
    import weakref
    ckpt.configure(None, checkpoint_in_cpu=True)
    block = _block()
    x = torch.ones(4, 16, requires_grad=True)
    y = ckpt.checkpoint(block, ckpt.checkpoint(block, x))
    store = ckpt._store(torch.device("cpu"))
    assert store._live == 2
    copies = [r() for r in store.host]
    assert all(isinstance(c, torch.Tensor) for c in copies)
    held = [weakref.ref(c) for c in copies]
    del y, copies
    gc.collect()
    assert store._live == 0 and store.host == [None, None]
    assert all(r() is None for r in held)
    y = ckpt.checkpoint(block, x)
    assert len(store.host) == 1          # a fresh forward starts over
    y.sum().backward()
    assert store._live == 0 and x.grad is not None


def test_gpt_cpu_checkpointing_matches_remat_and_jax():
    from deepspeed_tpu.models.gpt import lm_loss_fn as jax_loss
    from deepspeed_tpu_torch.models.gpt import GPT, lm_loss_fn
    jmodel, params, remat = model_pair(seed=21, attention_impl="pallas",
                                       remat=True)
    jmodel = jmodel.clone(cfg=dataclasses.replace(jmodel.cfg,
                                                  cpu_checkpointing=True))
    offload = GPT(dataclasses.replace(remat.cfg, cpu_checkpointing=True))
    offload.load_state_dict(remat.state_dict())
    ids = _ids(22)
    t = torch.from_numpy(ids).long()
    losses = []
    for model in (remat, offload):
        loss = lm_loss_fn(model(t), {"input_ids": t})
        loss.backward()
        losses.append(loss.detach())
    assert torch.equal(losses[0], losses[1])
    for (name, a), b in zip(remat.named_parameters(), offload.parameters()):
        assert torch.equal(a.grad, b.grad), name
    jl, jg = jax.value_and_grad(lambda p: jax_loss(
        jmodel.apply({"params": p}, jnp.asarray(ids)),
        {"input_ids": jnp.asarray(ids)}))(params)
    np.testing.assert_allclose(losses[1].item(), float(jl), rtol=RTOL)
    want = _state_dict_np(jg, offload.cfg)
    for name, p in offload.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_cpu_checkpointing_without_remat_raises_like_jax():
    from deepspeed_tpu.models.gpt import GPTConfig as JaxConfig
    from deepspeed_tpu_torch.models.gpt import GPTConfig
    with pytest.raises(ValueError, match="requires remat"):
        GPTConfig(cpu_checkpointing=True, remat=False, **TINY)
    with pytest.raises(ValueError, match="requires remat"):
        JaxConfig(cpu_checkpointing=True, remat=False, **TINY)


def test_engine_cpu_checkpointing_matches_remat():
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig, lm_loss_fn
    cfg = GPTConfig(dtype=torch.float32, remat=True, **TINY)
    base = GPT(cfg)
    base.init_weights(torch.Generator().manual_seed(4))
    config = {"train_micro_batch_size_per_gpu": 4,
              "gradient_accumulation_steps": 2,
              "zero_optimization": {"stage": 1},
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    runs = []
    for extra in ({}, {"activation_checkpointing": {
            "cpu_checkpointing": True}}):
        model = GPT(cfg)
        model.load_state_dict(base.state_dict())
        engine, *_ = dst.initialize(model=model, loss_fn=lm_loss_fn,
                                    config=dict(config, **extra),
                                    device="cpu")
        assert engine.module.cfg.cpu_checkpointing == bool(extra)
        assert all(b.cfg is engine.module.cfg for b in engine.module.blocks)
        runs.append([float(engine.train_batch(iter(
            [{"input_ids": _ids(30 + s)}] * 2))) for s in range(3)])
    assert runs[0] == runs[1]


def test_engine_cpu_checkpointing_needs_a_model_config():
    import deepspeed_tpu_torch as dst

    class Plain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Linear(4, 4)

        def forward(self, x):
            return self.w(x.float()).sum()
    with pytest.raises(ValueError, match="cpu_checkpointing"):
        dst.initialize(model=Plain(), device="cpu", config={
            "train_micro_batch_size_per_gpu": 1,
            "activation_checkpointing": {"cpu_checkpointing": True},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
