"""The port's InferenceEngine / init_inference and initialize against the TPU
package's signatures: every TPU keyword is taken; ``config``,
``max_tokens`` and ``replace_with_kernel_inject`` at any value;
``quantize_mode`` keeps the TPU engine's ``ValueError``s; ``checkpoint``,
``injection_policy``, ``quantize_bits``, ``replace_method``, ``ep_size``
and ``mp_size`` are ported (tests/test_torch_inference_checkpoint.py,
test_torch_weight_quant.py, test_torch_moe_ep.py, test_torch_tp.py);
``mp_size`` away from its default on a one-rank world raises a
``ValueError`` naming the world (a tp mesh needs that many ranks), never a
``TypeError``; with the
defaults passed explicitly the engine builds from TPU weights converted by
``convert.py`` and its greedy tokens equal the TPU engine's.
``initialize(dist_init_required=True)`` builds at one rank and over two
gloo ranks. On the CPU, f32, a tiny GPT."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import model_pair

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig, lm_loss_fn
from torch_test_threads import one_torch_thread  # noqa: F401

# a value away from each mesh knob's default, and its default: on a
# one-rank world each asks for a mesh the world cannot hold
NON_DEFAULT = {"mp_size": 2}
MESH_DEFAULTS = {"mp_size": 1}
# ported knobs, taken away from their defaults
PORTED = ("checkpoint", "injection_policy", "quantize_bits", "replace_method",
          "ep_size", "mp_size")
# read by neither engine: taken at any value
INERT = {"config": {"tensor_parallel": {"tp_size": 1}}, "max_tokens": 512,
         "replace_with_kernel_inject": True}
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": 2,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=5)


def _model():
    cfg = GPTConfig(vocab_size=128, max_seq_len=32, num_layers=1,
                    num_heads=2, d_model=64, d_ff=128, dtype=torch.float32)
    model = GPT(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def test_every_tpu_inference_keyword_is_taken():
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    jax_params = inspect.signature(JaxEngine.__init__).parameters
    port_params = inspect.signature(InferenceEngine.__init__).parameters
    assert set(jax_params) <= set(port_params)
    assert set(port_params) - set(jax_params) == {"device"}
    assert set(NON_DEFAULT) == set(MESH_DEFAULTS)
    assert set(INERT) | set(PORTED) | {
        "self", "model", "dtype", "model_parameters",
        "quantize_mode"} == set(jax_params)
    for name, param in jax_params.items():
        assert param.kind == port_params[name].kind, name
        if name in MESH_DEFAULTS:
            assert param.default == MESH_DEFAULTS[name], name
        if name not in ("self", "model", "dtype"):
            assert param.default == port_params[name].default, name


def test_every_tpu_initialize_keyword_is_taken():
    import deepspeed_tpu
    jax_params = inspect.signature(deepspeed_tpu.initialize).parameters
    port_params = inspect.signature(dst.initialize).parameters
    assert set(jax_params) <= set(port_params)
    assert set(port_params) - set(jax_params) == {"device"}
    for name, param in jax_params.items():
        assert param.default == port_params[name].default, name


@pytest.mark.parametrize("entry", ["engine", "init_inference"])
@pytest.mark.parametrize("name", sorted(NON_DEFAULT))
def test_an_inference_knob_away_from_its_default_raises(name, entry):
    """mp_size 2 on a one-rank world: the tp mesh cannot be laid out."""
    build = InferenceEngine if entry == "engine" else dst.init_inference
    kw = {name: NON_DEFAULT[name]}
    with pytest.raises(ValueError, match="1 devices not divisible"):
        build(_model(), device="cpu", dtype=torch.float32, **kw)


def test_quantize_mode_keeps_the_tpu_value_errors():
    with pytest.raises(ValueError, match="quantize_mode"):
        InferenceEngine(_model(), device="cpu", quantize_mode="int4")
    with pytest.raises(ValueError, match="quantize_bits=8"):
        InferenceEngine(_model(), device="cpu", quantize_mode="asymmetric")
    # asymmetric with quantize_bits=8 builds (the weights at rest in int8)
    assert InferenceEngine(_model(), device="cpu", quantize_mode="asymmetric",
                           quantize_bits=8).quantized
    with pytest.raises(ValueError, match="ep_size > 1"):
        InferenceEngine(_model(), device="cpu", ep_size=2,
                        replace_method="auto")


def test_init_inference_with_tpu_keywords_matches_jax(pair):
    """The port's counterpart of tests/test_bert_and_autotp.py's
    ``init_inference(model, mp_size=1, dtype=..., model_parameters=...)``:
    TPU weights through convert.py, greedy tokens equal to the TPU
    engine's."""
    import jax
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    from deepspeed_tpu_torch.convert import jax_params_to_state_dict
    jmodel, params, pmodel = pair
    sd = jax_params_to_state_dict(jax.tree.map(np.asarray, params),
                                  pmodel.cfg)
    model = GPT(pmodel.cfg)              # fresh weights, replaced by sd
    ids = np.random.default_rng(6).integers(
        0, pmodel.cfg.vocab_size, (2, 8)).astype(np.int32)
    ref = JaxEngine(jmodel, mp_size=1, dtype=jnp.float32,
                    model_parameters=params).generate(
        ids, max_new_tokens=6, temperature=0.0)
    engine = dst.init_inference(model, mp_size=1, dtype=torch.float32,
                                model_parameters=sd, device="cpu")
    out = engine.generate(ids, max_new_tokens=6, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # every knob at its default, passed explicitly, and the inert ones at
    # other values, build the same engine
    defaults = dict(MESH_DEFAULTS)
    again = dst.init_inference(GPT(pmodel.cfg), dtype=torch.float32,
                               model_parameters=sd, device="cpu",
                               quantize_mode="symmetric", **defaults,
                               **INERT)
    np.testing.assert_array_equal(
        again.generate(ids, max_new_tokens=6, temperature=0.0).numpy(),
        np.asarray(ref))


def _train_model():
    return GPT(GPTConfig(vocab_size=128, max_seq_len=32, num_layers=1,
                         num_heads=2, d_model=64, d_ff=128))


def test_initialize_dist_init_required_builds_at_one_rank():
    ids = np.random.default_rng(0).integers(0, 128, (2, 32))
    engine, *_ = dst.initialize(model=_train_model(), loss_fn=lm_loss_fn,
                                config=TRAIN_CONFIG, dist_init_required=True,
                                device="cpu")
    loss = engine.train_batch(iter([{"input_ids": ids}]))
    assert np.isfinite(float(loss))


def test_initialize_dist_init_required_in_a_one_rank_group():
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        engine, *_ = dst.initialize(model=_train_model(),
                                    loss_fn=lm_loss_fn, config=TRAIN_CONFIG,
                                    dist_init_required=True, device="cpu")
        assert engine.dp_world_size == 1
    finally:
        dist.destroy_process_group()


def test_initialize_refuses_more_ranks_and_rng():
    """``rng`` still raises (the engine keeps no random stream);
    ``dist_init_required=True`` over two ranks, which raised naming A5
    until data parallelism was ported, builds a dp-2 engine that trains
    (its ranks agree on the loss)."""
    import torch_dist_helpers
    with pytest.raises(NotImplementedError, match="ROADMAP A13\\b"):
        dst.initialize(model=_train_model(), loss_fn=lm_loss_fn,
                       config=TRAIN_CONFIG, rng=0, device="cpu")
    ranks = torch_dist_helpers.run_ranks(
        "torch_dist_helpers:initialize_ranks", 2,
        config=TRAIN_CONFIG, rows=4)
    assert [dp for dp, _ in ranks] == [2, 2]
    assert np.isfinite(ranks[0][1]) and ranks[0][1] == ranks[1][1]
