"""The port's ``InferenceEngine`` keywords that take weights from elsewhere,
on the CPU in f32 over the tiny GPT (torch_port_helpers.TINY):

  * ``checkpoint``: the port's training engine trains 2 steps and saves;
    ``InferenceEngine(checkpoint=<dir>)`` (the ``latest`` tag) and
    ``checkpoint=<model_states.npz>`` serve its fp32 masters: logits
    bitwise those of a model loaded with them; a host-sharded checkpoint
    has no ``model_states.npz`` and raises naming ``zero_to_fp32``, whose
    consolidated ``.npz`` then loads;
  * ``injection_policy``: applied to the ``state_dict`` (from
    ``model_parameters``, a checkpoint or the module) before the cast; an
    HF GPT-2 state dict through ``HFGPT2Policy`` gives the JAX engine's
    greedy tokens over the JAX policy's tree;
  * ``replace_method="auto"`` at ``mp_size=1`` changes nothing;
  * ``forward(ids, **kwargs)``: a ``(logits, scalar)`` pair comes back as
    the logits; a BERT injected through ``HFBertPolicy``
    serves its sequence and pooled outputs with ``attention_mask`` and
    ``token_type_ids``, within 1e-5 of the JAX engine's.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as helpers
from test_torch_training import ENGINE_CONFIG
from torch_test_threads import one_torch_thread  # noqa: F401

from deepspeed_tpu_torch import InferenceEngine
from deepspeed_tpu_torch.models.bert import BertModel
from deepspeed_tpu_torch.models.gpt import GPT

GAS = ENGINE_CONFIG["gradient_accumulation_steps"]


def _trained(save_dir, **config):
    model = helpers.port_model(seed=1)
    engine = helpers.port_engine(model, dict(
        ENGINE_CONFIG, train_micro_batch_size_per_gpu=8, **config))
    micros = [{"input_ids": helpers.ids(60 + i, 8)} for i in range(2 * GAS)]
    helpers.train(engine, micros, 2, GAS)
    engine.save_checkpoint(save_dir)
    master = {k: torch.from_numpy(np.asarray(v))
              for k, v in engine.consolidated_fp32_state_dict().items()}
    return model.cfg, master


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("inf_ckpt")
    cfg, master = _trained(str(root / "npz"))
    _, sharded = _trained(str(root / "sharded"), sharded_checkpoint=True)
    return root, cfg, master, sharded


IDS = helpers.ids(5, 2, seq=24)


def _logits(cfg, state):
    model = GPT(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        return model(torch.from_numpy(IDS).long())


def _engine(cfg, **kw):
    return InferenceEngine(GPT(cfg), dtype=torch.float32, device="cpu", **kw)


def test_checkpoint_dir_and_npz_serve_the_trained_weights(saved):
    root, cfg, master, _ = saved
    want = _logits(cfg, master)
    assert not torch.equal(want, _logits(cfg, helpers.port_model(
        seed=1).state_dict()))                    # training moved them
    tag = open(root / "npz" / "latest").read().strip()
    for ckpt in (str(root / "npz"),
                 str(root / "npz" / tag / "model_states.npz")):
        got = _engine(cfg, checkpoint=ckpt).forward(IDS)
        assert torch.equal(got, want), ckpt
    # model_parameters wins over checkpoint, as in the JAX engine
    other = helpers.port_model(seed=3).state_dict()
    got = _engine(cfg, checkpoint=str(root / "npz"),
                  model_parameters=other).forward(IDS)
    assert torch.equal(got, _logits(cfg, other))


def test_host_sharded_checkpoint_raises_then_loads_consolidated(saved):
    root, cfg, _, sharded = saved
    with pytest.raises(FileNotFoundError, match="zero_to_fp32"):
        _engine(cfg, checkpoint=str(root / "sharded"))
    tag = open(root / "sharded" / "latest").read().strip()
    out = str(root / "consolidated.npz")
    subprocess.run([sys.executable,
                    os.path.join(root / "sharded", tag, "zero_to_fp32.py"),
                    str(root / "sharded"), out], check=True,
                   capture_output=True)
    got = _engine(cfg, checkpoint=out).forward(IDS)
    assert torch.equal(got, _logits(cfg, sharded))


def test_injection_policy_is_applied_before_the_cast(saved):
    root, cfg, master, _ = saved
    calls = []

    def policy(sd):
        calls.append(sorted(sd))
        out = dict(sd)
        out["ln_f.bias"] = sd["ln_f.bias"] + 0.25
        return out

    shifted = dict(master, **{"ln_f.bias": master["ln_f.bias"] + 0.25})
    for kw in (dict(checkpoint=str(root / "npz")),
               dict(model_parameters=master)):
        got = _engine(cfg, injection_policy=policy, **kw).forward(IDS)
        assert torch.equal(got, _logits(cfg, shifted))
    # with neither, the module's own state_dict goes through the policy
    model = GPT(cfg)
    model.load_state_dict(master)
    got = InferenceEngine(model, dtype=torch.float32, device="cpu",
                          injection_policy=policy).forward(IDS)
    assert torch.equal(got, _logits(cfg, shifted))
    assert len(calls) == 3 and calls[0] == sorted(master)
    # before the cast: a bf16 engine's policy sees the fp32 weights
    seen = []
    eng = InferenceEngine(GPT(cfg), dtype=torch.bfloat16, device="cpu",
                          model_parameters=master,
                          injection_policy=lambda sd: seen.append(
                              {v.dtype for v in sd.values()}) or sd)
    assert seen == [{torch.float32}]
    assert eng.module.ln_f.bias.dtype == torch.bfloat16


def test_hf_policy_as_injection_policy_matches_jax():
    transformers = pytest.importorskip("transformers")
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    from deepspeed_tpu.models.gpt import GPT as JaxGPT
    from deepspeed_tpu.module_inject.policies import \
        HFGPT2Policy as JaxPolicy
    from deepspeed_tpu_torch.module_inject.policies import HFGPT2Policy
    torch.manual_seed(1)
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=96, n_positions=32, n_embd=48, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)).eval()
    sd = dict(hf.state_dict())
    cfg = HFGPT2Policy.config_from_hf(hf.config)
    ids = np.random.default_rng(0).integers(0, 96, (1, 5)).astype(np.int32)
    jcfg = JaxPolicy.config_from_hf(hf.config)
    ref = JaxEngine(JaxGPT(jcfg), dtype=jnp.float32,
                    model_parameters=sd,
                    injection_policy=lambda p: JaxPolicy.convert(p, 2)
                    ).generate(ids, max_new_tokens=6, temperature=0.0)
    for method in (None, "auto"):
        eng = InferenceEngine(GPT(cfg), dtype=torch.float32, device="cpu",
                              model_parameters=sd, replace_method=method,
                              injection_policy=lambda p: HFGPT2Policy.convert(
                                  p, cfg.num_layers))
        out = eng.generate(ids, max_new_tokens=6, temperature=0.0)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_forward_passes_bert_inputs_through():
    transformers = pytest.importorskip("transformers")
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    from deepspeed_tpu.models.bert import BertModel as JaxBert
    from deepspeed_tpu.module_inject.policies import \
        HFBertPolicy as JaxPolicy
    from deepspeed_tpu_torch.module_inject.policies import HFBertPolicy
    torch.manual_seed(0)
    hf = transformers.BertModel(transformers.BertConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)).eval()
    sd = dict(hf.state_dict())
    cfg = HFBertPolicy.config_from_hf(hf.config)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 10:] = 0
    tt = np.zeros((2, 16), np.int32)
    tt[:, 8:] = 1
    jeng = JaxEngine(JaxBert(JaxPolicy.config_from_hf(hf.config)),
                     dtype=jnp.float32,
                     model_parameters=JaxPolicy.convert(sd, 2))
    ref = jeng.forward(ids, attention_mask=mask, token_type_ids=tt)
    eng = InferenceEngine(BertModel(cfg), dtype=torch.float32, device="cpu",
                          model_parameters=sd,
                          injection_policy=lambda p: HFBertPolicy.convert(
                              p, cfg.num_layers))
    got = eng.forward(ids, attention_mask=mask, token_type_ids=tt,
                      deterministic=None)
    assert isinstance(got, tuple) and len(got) == 2
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    # the mask is read: without it the padded row's outputs differ
    plain = eng.forward(ids, token_type_ids=tt)
    assert (plain[0][1] - got[0][1]).abs().max() > 1e-3


def test_forward_unwraps_a_logits_and_scalar_pair(saved):
    """A ``(logits, scalar)`` output (an MoE model's aux loss) comes back
    as the logits, as from the JAX engine; the GPT's own logits pass."""
    _, cfg, master, _ = saved

    class WithAux(GPT):
        def forward(self, input_ids, positions=None):
            return super().forward(input_ids, positions), torch.tensor(0.5)

    got = InferenceEngine(WithAux(cfg), dtype=torch.float32, device="cpu",
                          model_parameters=master).forward(IDS)
    assert torch.equal(got, _logits(cfg, master))
