"""The port's DeepSpeedTransformerLayer against the TPU package's, on the
CPU: the same f32 weights (``convert.transformer_layer_params_to_state_dict``
of the flax tree, every leaf perturbed so that biases and LayerNorm scales
matter), the same inputs and key-padding mask, hidden 64, 4 heads, S 16.

Outputs and the gradients of every parameter and of the input under the
JAX layer test's L2 objective (mean of the squared output) agree within
1e-4 (absolute and relative): the TPU layer's LayerNorm is flax's, which
takes the variance as E[x^2] - E[x]^2, while the port's B6 takes it in a
second pass over x - mean, as the TPU kernel does; the rest is summation
order. Dropout and stochastic rounding draw other random bits than JAX,
so they are held to the TPU package's properties. On the CPU the flash,
LayerNorm and softmax wrappers run their plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_test_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
HIDDEN, HEADS, SEQ, BATCH = 64, 4, 16, 2
LENGTHS = (12, 9)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BATCH, SEQ, HIDDEN)).astype(np.float32)
    mask = (np.arange(SEQ)[None, :] < np.array(LENGTHS)[:, None]
            ).astype(np.int32)
    return x, mask


def _jax_layer(**kw):
    """(config, layer, params): the flax layer's init, every leaf
    perturbed by numpy noise."""
    from deepspeed_tpu.ops.transformer import (DeepSpeedTransformerConfig,
                                               DeepSpeedTransformerLayer)
    kw.setdefault("bf16", False)
    cfg = DeepSpeedTransformerConfig(hidden_size=HIDDEN, heads=HEADS,
                                     num_hidden_layers=12, **kw)
    layer = DeepSpeedTransformerLayer(cfg)
    x, mask = _inputs()
    params = layer.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                        jnp.asarray(mask), deterministic=True)["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(0.0, 0.05, a.shape),
                                  jnp.float32), params)
    return cfg, layer, params


def _port_layer(params, **kw):
    from deepspeed_tpu_torch.convert import \
        transformer_layer_params_to_state_dict
    from deepspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
    kw.setdefault("bf16", False)
    cfg = DeepSpeedTransformerConfig(hidden_size=HIDDEN, heads=HEADS,
                                     num_hidden_layers=12, **kw)
    layer = DeepSpeedTransformerLayer(cfg)
    layer.load_state_dict(transformer_layer_params_to_state_dict(
        jax.tree.map(np.asarray, params)))
    return layer


def _port_loss_and_grads(layer, x, mask, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    mt = None if mask is None else torch.from_numpy(mask)
    out = layer(xt, mt, **kw)
    loss = out.float().square().mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in layer.named_parameters()}
    layer.zero_grad()
    return out.detach(), loss.item(), grads, xt.grad


def _jax_loss_and_grads(layer, params, x, mask):
    jm = None if mask is None else jnp.asarray(mask)

    def loss_fn(p, xx):
        y = layer.apply({"params": p}, xx, jm, deterministic=True)
        return jnp.mean(jnp.square(y)), y
    (loss, out), (gp, gx) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return np.asarray(out), float(loss), gp, np.asarray(gx)


def _assert_grads_match(port_grads, jax_grads):
    from deepspeed_tpu_torch.convert import \
        transformer_layer_params_to_state_dict
    ref = transformer_layer_params_to_state_dict(
        jax.tree.map(np.asarray, jax_grads))
    assert sorted(ref) == sorted(port_grads)
    for name, g in port_grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_layer_matches_jax(pre_ln, masked):
    _, jlayer, params = _jax_layer(pre_layer_norm=pre_ln)
    layer = _port_layer(params, pre_layer_norm=pre_ln)
    x, mask = _inputs()
    mask = mask if masked else None
    out, loss, grads, gx = _port_loss_and_grads(layer, x, mask,
                                                deterministic=True)
    jout, jloss, jgp, jgx = _jax_loss_and_grads(jlayer, params, x, mask)
    np.testing.assert_allclose(out.numpy(), jout, rtol=TOL, atol=TOL)
    assert abs(loss - jloss) <= TOL * abs(jloss)
    np.testing.assert_allclose(gx.numpy(), jgx, rtol=TOL, atol=TOL)
    _assert_grads_match(grads, jgp)


@pytest.mark.parametrize("toggle", ["normalize_invertible", "gelu_checkpoint",
                                    "attn_dropout_checkpoint"])
def test_remat_matches_plain_and_jax(toggle):
    """Any memory toggle checkpoints the body: the same values and grads
    as without it, and as the TPU layer under the same toggle."""
    _, jlayer, params = _jax_layer(**{toggle: True})
    layer = _port_layer(params, **{toggle: True})
    plain = _port_layer(params)
    assert layer.config.remat and not plain.config.remat
    x, mask = _inputs()
    out, loss, grads, gx = _port_loss_and_grads(layer, x, mask,
                                                deterministic=True)
    pout, ploss, pgrads, pgx = _port_loss_and_grads(plain, x, mask,
                                                    deterministic=True)
    np.testing.assert_allclose(out.numpy(), pout.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), pgx.numpy(), rtol=0, atol=1e-6)
    for name in grads:
        np.testing.assert_allclose(grads[name].numpy(), pgrads[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    jout, _, jgp, _ = _jax_loss_and_grads(jlayer, params, x, mask)
    np.testing.assert_allclose(out.numpy(), jout, rtol=TOL, atol=TOL)
    _assert_grads_match(grads, jgp)


def _dropout_run(layer, seed, x, mask):
    g = torch.Generator().manual_seed(seed)
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt, torch.from_numpy(mask), generator=g)
    out.float().square().mean().backward()
    grads = {n: p.grad.clone() for n, p in layer.named_parameters()}
    layer.zero_grad()
    return out.detach(), grads


def test_remat_with_dropout_replays_the_same_masks():
    """The dropout masks are drawn from the generator before the
    checkpointed body, so the recomputed body applies the same masks: a
    remat'd layer gives the plain layer's values and grads for the same
    generator seed."""
    _, _, params = _jax_layer()
    kw = dict(hidden_dropout_ratio=0.2, attn_dropout_ratio=0.1)
    layer = _port_layer(params, attn_dropout_checkpoint=True, **kw)
    plain = _port_layer(params, **kw)
    x, mask = _inputs()
    out, grads = _dropout_run(layer, 5, x, mask)
    pout, pgrads = _dropout_run(plain, 5, x, mask)
    assert torch.equal(out, pout)
    for name in grads:
        torch.testing.assert_close(grads[name], pgrads[name], rtol=0,
                                   atol=1e-6)


def test_dropout_draws_differ_per_generator_and_eval_is_deterministic():
    _, _, params = _jax_layer()
    layer = _port_layer(params, hidden_dropout_ratio=0.2,
                        attn_dropout_ratio=0.1, training=True)
    plain = _port_layer(params)
    x, mask = _inputs()
    d1, _ = _dropout_run(layer, 1, x, mask)
    d1b, _ = _dropout_run(layer, 1, x, mask)
    d2, _ = _dropout_run(layer, 2, x, mask)
    assert d1.shape == x.shape
    assert torch.equal(d1, d1b)
    assert not torch.allclose(d1, d2)
    with torch.no_grad():
        ev = layer(torch.from_numpy(x), torch.from_numpy(mask),
                   deterministic=True)
        ref = plain(torch.from_numpy(x), torch.from_numpy(mask))
    assert torch.equal(ev, ref)


def test_stochastic_mode_draws_differ_and_stay_near_eval():
    """bf16 stochastic mode: an f32 body whose output rounds
    stochastically in training (draws differ per generator, both near the
    eval output, as the TPU test holds them) and to nearest in eval; the
    gradient passes the rounding straight through."""
    _, _, params = _jax_layer()
    layer = _port_layer(params, stochastic_mode=True, bf16=True,
                        training=True)
    x, mask = _inputs()
    s1, grads = _dropout_run(layer, 1, x, mask)
    s2, _ = _dropout_run(layer, 2, x, mask)
    assert s1.dtype == torch.bfloat16
    assert not torch.equal(s1, s2)
    with torch.no_grad():
        ev = layer(torch.from_numpy(x), torch.from_numpy(mask),
                   deterministic=True)
        ev2 = layer(torch.from_numpy(x), torch.from_numpy(mask),
                    deterministic=True)
        f32 = _port_layer(params)(torch.from_numpy(x),
                                  torch.from_numpy(mask))
    assert torch.equal(ev, ev2) and ev.dtype == torch.bfloat16
    torch.testing.assert_close(s1.float(), ev.float(), rtol=0, atol=0.05)
    torch.testing.assert_close(ev, f32.bfloat16(), rtol=0, atol=0)
    assert all(bool(g.abs().sum() > 0) for g in grads.values())


def test_config_validation_and_defaults():
    from deepspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
    cfg = DeepSpeedTransformerConfig(hidden_size=HIDDEN, heads=HEADS)
    assert cfg.intermediate_size == 4 * HIDDEN
    assert cfg.compute_dtype == torch.bfloat16 and not cfg.remat
    fp16 = DeepSpeedTransformerConfig(hidden_size=HIDDEN, heads=HEADS,
                                      fp16=True)
    assert not fp16.bf16 and fp16.compute_dtype == torch.float16
    assert DeepSpeedTransformerConfig(hidden_size=HIDDEN, heads=HEADS,
                                      bf16=False).compute_dtype \
        == torch.float32
    with pytest.raises(ValueError, match="divisible"):
        DeepSpeedTransformerConfig(hidden_size=65, heads=4)
    with pytest.raises(ValueError, match="required"):
        DeepSpeedTransformerConfig()
    with pytest.raises(ValueError, match="stochastic_mode"):
        DeepSpeedTransformerConfig(hidden_size=HIDDEN, heads=HEADS,
                                   bf16=False, stochastic_mode=True)
    layer = DeepSpeedTransformerLayer(dataclasses.replace(cfg, bf16=False))
    x = torch.zeros(BATCH, SEQ, HIDDEN)
    with pytest.raises(ValueError, match="binary key-padding"):
        layer(x, torch.zeros(BATCH, 1, 1, SEQ))
    tup = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(
        hidden_size=HIDDEN, heads=HEADS, bf16=False, return_tuple=True))
    out = tup(x, deterministic=True)
    assert isinstance(out, tuple) and len(out) == 1
    assert out[0].shape == x.shape


def test_init_follows_the_reference_ranges():
    from deepspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
    cfg = DeepSpeedTransformerConfig(hidden_size=256, heads=4,
                                     num_hidden_layers=8)
    layer = DeepSpeedTransformerLayer(cfg, generator=torch.Generator()
                                      .manual_seed(0))
    assert abs(layer.attn_qkv.weight.std().item() - 0.02) < 2e-3
    assert abs(layer.output.weight.std().item() - 0.02 / 4.0) < 5e-4
    assert layer.attn_ln.weight.eq(1).all() and layer.inter.bias.eq(0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_layer_goes_through_the_fused_op_wrappers(monkeypatch, masked):
    """Both LayerNorms run the B6 wrappers; the masked path runs B8 on the
    f32 logits and no flash, the unmasked path runs flash and no B8."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import layer_norm as ln
    from deepspeed_tpu_torch.ops.cuda import softmax as sm
    calls = {}

    def counted(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            if name == "softmax_forward":
                assert a[0].dtype == torch.float32
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapper)
    for module, names in ((ln, ("layer_norm_forward", "layer_norm_dx")),
                          (sm, ("softmax_forward", "softmax_backward")),
                          (fa, ("flash_attention_forward",
                                "flash_attention_backward"))):
        for name in names:
            counted(module, name)
    _, _, params = _jax_layer()
    x, mask = _inputs()
    _port_loss_and_grads(_port_layer(params), x, mask if masked else None,
                         deterministic=True)
    attn = (("softmax_forward", "softmax_backward") if masked else
            ("flash_attention_forward", "flash_attention_backward"))
    assert calls == {"layer_norm_forward": 2, "layer_norm_dx": 2,
                     **{name: 1 for name in attn}}


def test_layer_stack_trains_through_the_engine():
    """A small stack of layers with a fixed key-padding mask buffer trains
    through initialize -> train_batch (bf16 over f32 masters, AdamW,
    ZeRO-1) on the L2 objective: the loss falls."""
    import deepspeed_tpu_torch as dst
    from torch import nn

    class Stack(nn.Module):
        def __init__(self, cfg, n_layers, mask):
            super().__init__()
            self.layers = nn.ModuleList(
                dst.DeepSpeedTransformerLayer(cfg) for _ in range(n_layers))
            self.register_buffer("mask", mask)

        def forward(self, x):
            for layer in self.layers:
                x = layer(x, self.mask, deterministic=True)
            return x

    cfg = dst.DeepSpeedTransformerConfig(hidden_size=HIDDEN, heads=HEADS,
                                         num_hidden_layers=2)
    x, mask = _inputs()
    engine, *_ = dst.initialize(
        model=Stack(cfg, 2, torch.from_numpy(mask)), device="cpu",
        loss_fn=lambda out, batch: out.float().square().mean(),
        config={"train_micro_batch_size_per_gpu": BATCH,
                "bf16": {"enabled": True},
                "zero_optimization": {"stage": 1},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
    losses = [float(engine.train_batch(iter([{"inputs": x}])))
              for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
