"""The port's layer-streamed capacity tier (deepspeed_tpu_torch/runtime/zero/
layer_stream.py, ``offload_param.layer_streaming``) on the CPU, f32, tiny
models, inputs from numpy seeds.

Against the port's plain offload engine (stage 1, offload_optimizer cpu) on
the same weights, bitwise: 4 steps at micro 2 x gas 2 (the streamed path
sums the second micro-batch's block grads on the host, the plain one on the
device: the same f32 adds), for tied GPT and rotary / untied GPT, with and
without clipping (the global norm is taken leaf by leaf in the same order
from the same sums; the loss scale times gas is a power of two, so
dividing before or after the norm is exact), the NVMe param tier against
the DRAM mirrors, BERT MLM, and a checkpoint resumed mid-run. Also: the
fetch and emit counts of tests/layer_stream_worker.py:101-102, nothing of
the model left on the device between steps, the streamed eval and
``get_params``, the fp16 skip-and-halve check of the JAX package's
``test_streamed_fp16_loss_scale``, the JAX engine's three refusals, and the
streamed losses and masters against the JAX streamed engine (run in a
one-device child process, ``torch_layer_stream_jax.py``): losses and grad
norms within 1e-5 relative, masters through ``close_masters`` (f32 sums in
XLA's order and torch's).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as helpers
from test_torch_training import RTOL, _state_dict_np
from torch_test_threads import one_torch_thread  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
L, GAS, STEPS, MICRO, VOCAB, SEQ = 3, 2, 4, 2, 128, 32
SMALL = dict(vocab_size=VOCAB, max_seq_len=SEQ, num_layers=L, num_heads=2,
             d_model=32, d_ff=64)


def _gpt(seed=0, **kw):
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    model = GPT(GPTConfig(**{**SMALL, "dtype": torch.float32,
                             "remat": False, **kw}))
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def _config(stream=True, clip=0.0, nvme=None, gas=GAS, **extra):
    zero = {"stage": 1, "offload_optimizer": {"device": "cpu"}}
    if nvme:
        zero = {"stage": 3, "offload_optimizer": {
            "device": "nvme", "nvme_path": nvme}}
    if stream:
        zero["offload_param"] = {"layer_streaming": True}
        if nvme:
            zero["offload_param"].update(device="nvme", nvme_path=os.path.join(
                nvme, "params"))
    config = {"train_micro_batch_size_per_gpu": MICRO,
              "gradient_accumulation_steps": gas, "zero_optimization": zero,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "steps_per_print": 10000, **extra}
    if clip:
        config["gradient_clipping"] = clip
    return config


def _engine(model, config, loss_fn=None):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    engine, *_ = dst.initialize(model=model, loss_fn=loss_fn or lm_loss_fn,
                                config=config, device="cpu")
    return engine


def _micros(seed, n=GAS):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, VOCAB, (MICRO, SEQ))}
            for _ in range(n)]


def _train(engine, steps=STEPS, first=0):
    return [float(engine.train_batch(iter(_micros(first + s))))
            for s in range(steps)]


def _pair(config_a, config_b, **model_kw):
    return (_engine(_gpt(**model_kw), config_a),
            _engine(_gpt(**model_kw), config_b))


def _no_model_on_device(engine):
    st = engine._layer_streamer
    assert engine.device_state_bytes() == {"params": 0, "grad_acc": 0}
    assert st._sets == [] and st._pending == []
    assert all(p.is_meta for p in engine.module.parameters())


@pytest.mark.parametrize("rotary_untied", [False, True])
def test_streamed_matches_plain_offload(rotary_untied):
    kw = dict(rotary=True, tie_embeddings=False) if rotary_untied else {}
    plain, streamed = _pair(_config(stream=False), _config(), **kw)
    st = streamed._layer_streamer
    assert (st.fetches, st.emits) == (0, 0)
    _no_model_on_device(streamed)
    for s in range(STEPS):
        a = float(plain.train_batch(iter(_micros(s))))
        b = float(streamed.train_batch(iter(_micros(s))))
        assert a == b, (s, a, b)
        assert plain.get_global_grad_norm() == streamed.get_global_grad_norm()
        _no_model_on_device(streamed)
    # tests/layer_stream_worker.py:101-102: L fetches a scan, forward and
    # backward each micro-batch; L emits a micro-batch
    assert st.fetches == 2 * L * GAS * STEPS
    assert st.emits == L * GAS * STEPS
    batch = {"input_ids": np.random.default_rng(99).integers(0, VOCAB,
                                                              (MICRO, SEQ))}
    assert float(plain.eval_batch(batch)) == float(streamed.eval_batch(batch))
    assert st.fetches == 2 * L * GAS * STEPS + L
    _no_model_on_device(streamed)
    got, want = streamed.get_params(), plain.get_params()
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    assert got["wte.weight"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="never materializes"):
        streamed(batch)


@pytest.mark.parametrize("gas", [1, GAS])
def test_streamed_clipping_matches_plain_offload(gas):
    """gas 1 runs only the emits that write the host sums in place (the
    capacity config), gas 2 the adds too."""
    plain, streamed = _pair(_config(stream=False, clip=0.01, gas=gas),
                            _config(clip=0.01, gas=gas))
    runs = [[float(e.train_batch(iter(_micros(s, gas))))
             for s in range(STEPS)] for e in (plain, streamed)]
    assert runs[0] == runs[1]
    assert plain.get_global_grad_norm() == streamed.get_global_grad_norm()
    assert streamed._layer_streamer.emits == L * gas * STEPS


def test_streamed_nvme_param_tier_equals_dram_mirrors(tmp_path):
    dram, nvme = _pair(_config(), _config(nvme=str(tmp_path)))
    assert nvme.host_optimizer.mirror_store is not None
    assert _train(dram, 3) == _train(nvme, 3)
    aio = nvme._layer_streamer._aio
    assert sum(h.bytes_read for h in aio) > 0
    nvme._layer_streamer.close_io()
    nvme.host_optimizer.close()


def test_streamed_fp16_skips_and_halves_the_scale():
    """The JAX package's test_streamed_fp16_loss_scale: a sane scale trains;
    2^40 overflows fp16, skips the step, and (hysteresis 2) the second
    overflow halves the scale."""
    def engine(power):
        return _engine(_gpt(num_layers=2, dtype=torch.float16),
                       _config(gas=1, fp16={"enabled": True,
                                            "initial_scale_power": power}))
    ok = engine(8)
    loss = float(ok.train_batch(iter(_micros(0, 1))))
    assert np.isfinite(loss) and ok.host_optimizer.step_count == 1
    bad = engine(40)
    before = bad.loss_scale
    bad.train_batch(iter(_micros(0, 1)))
    bad.train_batch(iter(_micros(0, 1)))
    assert bad.host_optimizer.step_count == 0 and bad.skipped_steps == 2
    assert bad.loss_scale == before / 2.0


def _mlm_loss(logits, batch):
    labels = batch.get("labels", batch["input_ids"])
    lse = torch.logsumexp(logits.float(), dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - ll.float()).mean()


def test_streamed_bert_mlm_matches_plain_offload():
    from deepspeed_tpu_torch.models.bert import BertConfig, BertForMaskedLM

    def bert():
        model = BertForMaskedLM(BertConfig(
            vocab_size=VOCAB, max_seq_len=SEQ, num_layers=L, num_heads=2,
            d_model=32, d_ff=64, hidden_dropout=0.0))
        model.init_weights(torch.Generator().manual_seed(3))
        return model
    plain = _engine(bert(), _config(stream=False), _mlm_loss)
    streamed = _engine(bert(), _config(), _mlm_loss)
    assert streamed._layer_streamer.spec.blocks_key == "bert.blocks"
    assert _train(plain, 3) == _train(streamed, 3)


def test_streamed_checkpoint_resumes_bitwise(tmp_path):
    engine = _engine(_gpt(), _config())
    first = _train(engine, 2)
    engine.save_checkpoint(str(tmp_path), tag="two")
    cont = _train(engine, 2, first=2)
    fresh = _engine(_gpt(seed=5), _config())
    fresh.load_checkpoint(str(tmp_path))
    assert fresh.global_steps == 2
    _no_model_on_device(fresh)
    assert _train(fresh, 2, first=2) == cont
    assert all(np.isfinite(first))


def test_layer_streaming_needs_offload_optimizer():
    with pytest.raises(ValueError, match="layer_streaming"):
        _engine(_gpt(), {"train_micro_batch_size_per_gpu": 1,
                         "zero_optimization": {
                             "offload_param": {"layer_streaming": True}},
                         "optimizer": {"type": "Adam",
                                       "params": {"lr": 1e-3}}})


def test_layer_streaming_needs_a_stacked_spec():
    class Plain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Linear(4, 4)

        def forward(self, x):
            return self.w(x.float()).sum()
    with pytest.raises(ValueError, match="stacked_spec"):
        _engine(Plain(), _config())


def test_layer_streaming_refuses_more_than_one_rank():
    config = dict(_config(), train_micro_batch_size_per_gpu=1)
    got = helpers.run_ranks("torch_dist_helpers:streamed_init", 2,
                            config=config)
    for kind, msg in got:
        assert kind == "ValueError" and "SINGLE-chip" in msg, (kind, msg)


def test_stacked_spec_tree_helpers_and_refusals():
    from deepspeed_tpu_torch.runtime.pipe import spmd
    params = {"wte.weight": 1, "blocks.0.a": 2, "blocks.1.a": 3,
              "blocks.10.b": 4}
    assert spmd.tree_get(params, "blocks.1") == {"a": 3}
    assert spmd.tree_without(params, "blocks.1") == {
        "wte.weight": 1, "blocks.0.a": 2, "blocks.10.b": 4}
    assert spmd.tree_with(params, "blocks.1", {"c": 5})["blocks.1.c"] == 5
    assert spmd.layer_of("blocks.10.b", "blocks") == (10, "b")
    assert spmd.layer_of("wte.weight", "blocks") is None
    spec = _gpt().stacked_spec()
    assert (spec.blocks_key, spec.num_layers) == ("blocks", L)
    with pytest.raises(ValueError, match="dropout"):
        _gpt(dropout=0.1).stacked_spec()


def test_stacked_spec_equals_the_module_forward():
    """prefix -> blocks -> suffix_loss with the module's own tensors gives
    the module's loss bitwise."""
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    from deepspeed_tpu_torch.runtime.pipe.spmd import tree_get, tree_without
    model = _gpt(rotary=True, tie_embeddings=False)
    spec = model.stacked_spec(lm_loss_fn)
    params = dict(model.named_parameters())
    batch = {"input_ids": torch.from_numpy(_micros(7, 1)[0]["input_ids"])}
    with torch.no_grad():
        x, aux = spec.prefix(tree_without(params, "blocks"), batch)
        for i in range(L):
            x = spec.block(tree_get(params, f"blocks.{i}"), x, aux)
        got = spec.suffix_loss(params, x, batch)
        want = lm_loss_fn(model(batch["input_ids"]), batch)
    assert torch.equal(got, want)


def test_streamed_matches_the_jax_streamed_engine(tmp_path):
    from deepspeed_tpu.models.gpt import GPT as JaxGPT
    from deepspeed_tpu.models.gpt import GPTConfig as JaxConfig
    from deepspeed_tpu_torch.convert import jax_params_to_state_dict
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    kw = dict(SMALL, remat=False)
    params = jax.tree.map(np.asarray, JaxGPT(JaxConfig(
        dtype=jnp.float32, param_dtype=jnp.float32, **kw)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    micros = [m for s in range(STEPS) for m in _micros(s)]
    micros = [{"input_ids": m["input_ids"].astype(np.int32)} for m in micros]
    config = _config()
    src, dst = tmp_path / "in.pkl", tmp_path / "out.pkl"
    with open(src, "wb") as fh:
        pickle.dump({"model": kw, "params": params, "config": config,
                     "micros": micros}, fh)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="",
               PYTHONPATH=os.pathsep.join([os.path.dirname(TESTS),
                                           os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, os.path.join(
        TESTS, "torch_layer_stream_jax.py"), str(src), str(dst)],
        capture_output=True, text=True, timeout=500, env=env)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    with open(dst, "rb") as fh:
        want = pickle.load(fh)
    pcfg = GPTConfig(dtype=torch.float32, **kw)
    model = GPT(pcfg)
    model.load_state_dict(jax_params_to_state_dict(params, pcfg))
    engine = _engine(model, config)
    losses, norms = [], []
    for s in range(STEPS):
        losses.append(float(engine.train_batch(iter(
            micros[GAS * s:GAS * (s + 1)]))))
        norms.append(engine.get_global_grad_norm())
    np.testing.assert_allclose(losses, want["losses"], rtol=RTOL)
    np.testing.assert_allclose(norms, want["norms"], rtol=RTOL)
    helpers.close_masters(engine.consolidated_fp32_state_dict(),
                          _state_dict_np(want["master"], pcfg))
