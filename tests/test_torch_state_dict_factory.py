"""The port's state-dict loaders (``deepspeed_tpu_torch/checkpoint/
state_dict_factory.py``) and Megatron policy against the TPU package's, on
the CPU, over a synthetic Megatron GPT state dict (2 layers, hidden 32,
4 heads) made from a seed with numpy:

  * ``merge_qkv`` / ``split_qkv``, ``classify`` and the reshard functions
    equal to JAX's on the same arrays, at checkpoint versions 0 and 2;
  * ``MegatronSDLoader`` over shard files written with ``torch.save``
    (bare and under ``"model"``), 2 -> 1, 1 -> 2 and 2 -> 2, equal to
    JAX's loader;
  * ``MegatronGPTPolicy``: its ``state_dict`` exactly the converted JAX
    tree, and the port GPT's logits within 1e-5 of the JAX GPT's, at both
    versions, from the merged shards too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.checkpoint import state_dict_factory as psf
from deepspeed_tpu_torch.convert import jax_params_to_state_dict
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
from deepspeed_tpu_torch.module_inject.policies import MegatronGPTPolicy

from torch_test_threads import one_torch_thread  # noqa: F401

H, HEADS, LAYERS, VOCAB, POS = 32, 4, 2, 64, 16
VERSIONS = (0, 2.0)


def _megatron_sd(seed=0, prefix=""):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.1):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    sd = {"word_embeddings.weight": w(VOCAB, H, scale=0.5),
          "position_embeddings.weight": w(POS, H, scale=0.5),
          "transformer.final_layernorm.weight": 1 + w(H),
          "transformer.final_layernorm.bias": w(H)}
    for i in range(LAYERS):
        pre = f"transformer.layers.{i}."
        for ln in ("input_layernorm", "post_attention_layernorm"):
            sd[pre + ln + ".weight"] = 1 + w(H)
            sd[pre + ln + ".bias"] = w(H)
        for name, (o, n) in (("attention.query_key_value", (3 * H, H)),
                             ("attention.dense", (H, H)),
                             ("mlp.dense_h_to_4h", (4 * H, H)),
                             ("mlp.dense_4h_to_h", (H, 4 * H))):
            sd[pre + name + ".weight"] = w(o, n)
            sd[pre + name + ".bias"] = w(o)
    return {prefix + k: v for k, v in sd.items()}


def _eq(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      k)


def test_classify_matches_jax():
    from deepspeed_tpu.checkpoint.state_dict_factory import classify
    keys = list(_megatron_sd()) + [
        "h.0.attn.c_attn.weight", "h.0.attn.c_proj.weight",
        "h.0.attn.c_proj.bias", "lm_head.weight", "h.0.mlp.fc_out.weight",
        "encoder.layer.0.output.dense.weight", "h.0.mlp.fc_in.bias"]
    assert [psf.classify(k) for k in keys] == [classify(k) for k in keys]


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("n", [2, 4])
def test_qkv_merge_split_match_jax(version, n):
    from deepspeed_tpu.checkpoint import state_dict_factory as jsf
    rng = np.random.default_rng(1)
    for shape in ((3 * 8 * n, 5), (3 * 8 * n,)):
        full = rng.normal(size=shape).astype(np.float32)
        shards = [psf.split_qkv(full, n, r, version) for r in range(n)]
        want = [jsf.split_qkv(full, n, r, version) for r in range(n)]
        for a, b in zip(shards, want):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(
            psf.merge_qkv(shards, version).numpy(),
            jsf.merge_qkv(want, version))
        np.testing.assert_array_equal(
            psf.merge_qkv(shards, version).numpy(), full)
    with pytest.raises(ValueError, match="equal"):
        psf.split_qkv(np.zeros((3 * 5, 2)), 2, 0, version)


@pytest.mark.parametrize("version", VERSIONS)
def test_reshard_matches_jax(version):
    from deepspeed_tpu.checkpoint import state_dict_factory as jsf
    sd = _megatron_sd()
    for n in (2, 4):
        shards = [psf.split_state_dict(sd, n, r, version) for r in range(n)]
        want = [jsf.split_state_dict(sd, n, r, version) for r in range(n)]
        for a, b in zip(shards, want):
            _eq(a, b)
        _eq(psf.merge_state_dicts(shards, version),
            jsf.merge_state_dicts(want, version))
        _eq(psf.merge_state_dicts(shards, version), sd)


def _write_shards(tmp_path, sds, wrap):
    tmp_path.mkdir(exist_ok=True)
    paths = []
    for r, sd in enumerate(sds):
        p = tmp_path / f"mp_rank_{r:02d}_model_states.pt"
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
        torch.save({"model": t} if wrap else t, p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("version", VERSIONS)
def test_megatron_loader_matches_jax(tmp_path, version, wrap):
    from deepspeed_tpu.checkpoint.state_dict_factory import \
        SDLoaderFactory as JaxFactory
    sd = _megatron_sd(prefix="language_model.")
    two = _write_shards(tmp_path / "two",
                        [psf.split_state_dict(sd, 2, r, version)
                         for r in range(2)], wrap)
    one = _write_shards(tmp_path / "one", [sd], wrap)
    for paths, world, rank in ((two, 1, 0), (one, 2, 0), (one, 2, 1),
                               (two, 2, 1)):
        got = psf.SDLoaderFactory.get_sd_loader(paths, version).load(
            world, rank)
        want = JaxFactory.get_sd_loader(paths, version).load(world, rank)
        _eq(got, want)
    _eq(psf.MegatronSDLoader(two, version).load(1, 0), sd)


def _jax_cfg_model():
    from deepspeed_tpu.models.gpt import GPT as JaxGPT
    from deepspeed_tpu.models.gpt import GPTConfig as JaxConfig
    kw = dict(vocab_size=VOCAB, max_seq_len=POS, num_layers=LAYERS,
              num_heads=HEADS, d_model=H, d_ff=4 * H, rotary=False,
              tie_embeddings=True, scan_layers=True, remat=False)
    return (JaxGPT(JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                             **kw)),
            GPTConfig(dtype=torch.float32, param_dtype=torch.float32, **kw))


@pytest.mark.parametrize("version", VERSIONS)
def test_megatron_policy_matches_jax(tmp_path, version):
    from deepspeed_tpu.module_inject.policies import \
        MegatronGPTPolicy as JaxPolicy
    jmodel, cfg = _jax_cfg_model()
    sd = _megatron_sd(seed=2, prefix="model.language_model.")
    tree = JaxPolicy.convert(sd, LAYERS, num_heads=HEADS, version=version)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, tree), cfg)
    got = MegatronGPTPolicy.convert(sd, LAYERS, num_heads=HEADS,
                                    version=version)
    _eq(got, {k: v.numpy() for k, v in want.items()})
    # the same weights through a 2-way shard set and the loader
    shards = _write_shards(tmp_path, [psf.split_state_dict(
        sd, 2, r, version) for r in range(2)], True)
    merged = psf.MegatronSDLoader(shards, version).load(1, 0)
    _eq(MegatronGPTPolicy.convert(merged, LAYERS, num_heads=HEADS,
                                  version=version),
        {k: v.numpy() for k, v in want.items()})
    model = GPT(cfg)
    model.load_state_dict(got)
    ids = np.random.default_rng(3).integers(0, VOCAB, (2, 12))
    ref = jmodel.apply({"params": jax.tree.map(jnp.asarray, tree)},
                       jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        logits = model(torch.from_numpy(ids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    # version 2 regroups the per-head interleave: the two orders differ
    other = MegatronGPTPolicy.convert(sd, LAYERS, num_heads=HEADS,
                                      version=2.0 - version)
    assert not torch.equal(other["blocks.0.attn.qkv.weight"],
                           got["blocks.0.attn.qkv.weight"])
