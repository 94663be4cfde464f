"""The port's injection policies (``deepspeed_tpu_torch/module_inject``)
against the TPU package's, on the CPU in f32, over random tiny
``transformers`` models (GPT-2, GPT-Neo, GPT-J, BERT, DistilBERT) and a
synthetic Megatron state dict:

  * each policy's ``state_dict`` exactly equal to
    ``convert.jax_params_to_state_dict`` / ``bert_params_to_state_dict`` of
    the JAX policy's tree, from torch tensors and from numpy arrays, and on
    the input's dtype (bf16 in, bf16 out);
  * ``config_from_hf`` equal to the JAX policy's config field for field
    (dtypes by name);
  * the port model's logits (hidden states for the encoders) within 2e-3 of
    the ``transformers`` model's (GPT-J 2e-5, DistilBERT 2e-5);
  * the GPT-2 and BERT exports round-trip to the HF state dict exactly,
    and equal the JAX exports;
  * ``load_hf_model`` over an object that only has ``.config`` and
    ``.state_dict()``; an unknown type raises; GPT-J with a nonzero
    ``lm_head.bias`` raises (the JAX policy drops the bias).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.convert import (bert_params_to_state_dict,
                                         jax_params_to_state_dict)
from deepspeed_tpu_torch.models.bert import BertModel
from deepspeed_tpu_torch.models.gpt import GPT
from deepspeed_tpu_torch.module_inject import policies as pp

from torch_test_threads import one_torch_thread  # noqa: F401

transformers = pytest.importorskip("transformers")


def _gpt2():
    cfg = transformers.GPT2Config(
        vocab_size=96, n_positions=32, n_embd=48, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _gpt_neo():
    cfg = transformers.GPTNeoConfig(
        vocab_size=96, max_position_embeddings=32, hidden_size=48,
        num_layers=2, num_heads=4, attention_types=[[["global", "local"], 1]],
        window_size=8, resid_dropout=0.0, embed_dropout=0.0,
        attention_dropout=0.0)
    torch.manual_seed(2)
    return transformers.GPTNeoForCausalLM(cfg).eval()


def _gptj():
    cfg = transformers.GPTJConfig(
        vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        rotary_dim=16, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.GPTJForCausalLM(cfg).eval()
    with torch.no_grad():
        hf.lm_head.bias.zero_()
    return hf


def _bert():
    cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    return transformers.BertModel(cfg).eval()


def _distilbert():
    cfg = transformers.DistilBertConfig(
        vocab_size=128, dim=64, n_layers=3, n_heads=4, hidden_dim=128,
        max_position_embeddings=64, dropout=0.0, attention_dropout=0.0,
        sinusoidal_pos_embds=False)
    torch.manual_seed(0)
    return transformers.DistilBertModel(cfg).eval()


HF = {"gpt2": _gpt2, "gpt_neo": _gpt_neo, "gptj": _gptj, "bert": _bert,
      "distilbert": _distilbert}
ENCODERS = ("bert", "distilbert")
# logits (hidden states) tolerance against transformers
TOL = {"gpt2": 2e-3, "gpt_neo": 2e-3, "gptj": 2e-5, "bert": 2e-3,
       "distilbert": 2e-5}


@pytest.fixture(scope="module", params=sorted(HF))
def hf(request):
    return request.param, HF[request.param]()


def _jax_policy(model_type):
    from deepspeed_tpu.module_inject.policies import policy_for
    return policy_for(model_type)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _jax_state_dict(model_type, hf_model, cfg):
    jp = _jax_policy(model_type)
    tree = _np_tree(jp.convert(dict(hf_model.state_dict()), cfg.num_layers))
    if model_type in ENCODERS:
        return bert_params_to_state_dict(tree, cfg)
    return jax_params_to_state_dict(tree, cfg)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


def test_state_dict_equals_the_converted_jax_tree(hf):
    model_type, hf_model = hf
    pol = pp.policy_for(model_type)
    cfg = pol.config_from_hf(hf_model.config)
    want = _jax_state_dict(model_type, hf_model, cfg)
    sd = dict(hf_model.state_dict())
    _assert_same(pol.convert(sd, cfg.num_layers), want)
    # numpy arrays in: the same tensors
    _assert_same(pol.convert({k: v.numpy() for k, v in sd.items()},
                             cfg.num_layers), want)
    # bf16 in: bf16 out, the same values
    got = pol.convert({k: v.to(torch.bfloat16) for k, v in sd.items()},
                      cfg.num_layers)
    for k, v in got.items():
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(
            v.float().numpy(), want[k].to(torch.bfloat16).float().numpy(), k)


def test_config_from_hf_matches_jax_field_for_field(hf):
    model_type, hf_model = hf
    jcfg = _jax_policy(model_type).config_from_hf(hf_model.config)
    pcfg = pp.policy_for(model_type).config_from_hf(hf_model.config)
    for f in dataclasses.fields(jcfg):
        a, b = getattr(jcfg, f.name), getattr(pcfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert jnp.dtype(a).name == str(b).removeprefix("torch."), f.name
        elif f.name != "decode_impl":    # the port's "einsum" is JAX's "xla"
            assert a == b, f.name


def _inputs(vocab, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int64)
    mask[-1, s - 6:] = 0
    tt = np.zeros((b, s), np.int64)
    tt[:, s // 2:] = 1
    return ids, mask, tt


def test_logits_match_transformers(hf):
    model_type, hf_model = hf
    cfg, sd = pp.load_hf_model(hf_model)
    ids, mask, tt = _inputs(hf_model.config.vocab_size,
                            s=20 if model_type == "gpt_neo" else 16)
    t = torch.from_numpy
    with torch.no_grad():
        if model_type in ENCODERS:
            model = BertModel(cfg)
            model.load_state_dict(sd)
            kw = {"attention_mask": t(mask)}
            if model_type == "bert":
                kw["token_type_ids"] = t(tt)
            ref = hf_model(input_ids=t(ids), **kw)
            seq, pooled = model(t(ids), kw.get("token_type_ids"),
                                t(mask))
            live = mask.astype(bool)
            err = np.abs(seq.numpy() - ref.last_hidden_state.numpy())[live]
            assert err.max() < TOL[model_type]
            if model_type == "bert":
                np.testing.assert_allclose(pooled.numpy(),
                                           ref.pooler_output.numpy(),
                                           atol=TOL[model_type])
        else:
            model = GPT(cfg)
            model.load_state_dict(sd)
            ref = hf_model(t(ids)).logits.numpy()
            got = model(t(ids)).numpy()
            assert np.abs(got - ref).max() < TOL[model_type]


def test_load_hf_model_takes_any_object_with_config_and_state_dict(hf):
    model_type, hf_model = hf

    class Stub:
        config = hf_model.config

        def state_dict(self):
            return hf_model.state_dict()

    cfg, sd = pp.load_hf_model(Stub())
    assert cfg == pp.policy_for(model_type).config_from_hf(hf_model.config)
    _assert_same(sd, _jax_state_dict(model_type, hf_model, cfg))
    assert model_type in pp._POLICIES


@pytest.mark.parametrize("model_type", ["gpt2", "bert"])
def test_exports_round_trip_and_equal_jax(model_type):
    from deepspeed_tpu.module_inject.policies import \
        export_hf_state_dict as jax_export
    hf_model = HF[model_type]()
    pol = pp.policy_for(model_type)
    cfg = pol.config_from_hf(hf_model.config)
    back = pp.export_hf_state_dict(
        model_type, pol.convert(dict(hf_model.state_dict()), cfg.num_layers))
    sd = {k: v for k, v in hf_model.state_dict().items()
          if "attn.bias" not in k and "masked_bias" not in k
          and "position_ids" not in k}
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), k)
    jtree = _np_tree(_jax_policy(model_type).convert(
        dict(hf_model.state_dict()), cfg.num_layers))
    jback = jax_export(model_type, jtree)
    assert sorted(jback) == sorted(back)
    for k in jback:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]),
                                      k)
    with pytest.raises(ValueError, match="no export path"):
        pp.export_hf_state_dict("gptj", {})
    with pytest.raises(ValueError, match="no injection policy"):
        pp.policy_for("llama")


def test_gptj_nonzero_lm_head_bias_raises():
    hf_model = _gptj()
    with torch.no_grad():
        hf_model.lm_head.bias[3] = 0.5
    with pytest.raises(ValueError, match="lm_head.bias is nonzero"):
        pp.load_hf_model(hf_model)
    # the JAX policy drops it silently: its tree has no bias to serve
    tree = _jax_policy("gptj").convert(dict(hf_model.state_dict()), 2)
    assert set(tree["lm_head"]) == {"kernel"}
