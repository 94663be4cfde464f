"""TPU-package GPT weights through deepspeed_tpu_torch.convert: the port's
logits must equal ``GPT.apply``'s within 1e-5 (f32, CPU; the matmul
summation order differs), for a GPT-2-style config, a rotary +
parallel-residual config with an untied head and a block-sparse config (the
same tree as the dense one), from stacked (scanned) and per-layer param
trees. The port's own prefill + decode path must agree with
its full forward."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY, model_pair

ATOL = 1e-5

CONFIGS = {
    "gpt2": {},
    "neox_untied": dict(rotary=True, rotary_pct=0.5, parallel_residual=True,
                        tie_embeddings=False),
    "gpt2_unscanned": dict(scan_layers=False),
    "gpt2_sparse": dict(sparse=("BSLongformerSparsityConfig", dict(
        num_heads=TINY["num_heads"], block=8,
        attention="unidirectional"))),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_jax(name):
    jmodel, params, pmodel = model_pair(seed=1, **CONFIGS[name])
    ids = np.random.default_rng(2).integers(
        0, TINY["vocab_size"], (2, 24)).astype(np.int32)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        out = pmodel(torch.from_numpy(ids).long()).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("decode_impl", ["auto", "einsum"])
def test_prefill_then_decode_matches_full_forward(decode_impl):
    _, _, pmodel = model_pair(seed=3, rotary=True, parallel_residual=True)
    cfg = pmodel.cfg
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12))).long()
    with torch.no_grad():
        full = pmodel(ids)
        _, keys, values = pmodel.prefill(ids[:, :8])
        shape = (cfg.num_layers, 2, cfg.max_seq_len, keys.shape[-1])
        ck, cv = torch.zeros(shape), torch.zeros(shape)
        ck[:, :, :8], cv[:, :, :8] = keys, values
        for t in range(8, 12):
            pos = torch.full((2,), t)
            step = pmodel.decode(ids[:, t:t + 1], pos[:, None], ck, cv, pos,
                                 decode_impl=decode_impl)
            np.testing.assert_allclose(step[:, 0].numpy(),
                                       full[:, t].numpy(), rtol=0, atol=ATOL)
        # a write at the sentinel (max_seq_len) is dropped
        before = ck.clone()
        sentinel = torch.full((2,), cfg.max_seq_len)
        pmodel.decode(ids[:, :1], pos[:, None], ck, cv, sentinel)
        assert torch.equal(ck, before)


def test_unported_features_raise():
    from deepspeed_tpu_torch.models.gpt import GPTConfig
    for kw in (dict(moe=True), dict(sequence_parallel=True),
               dict(kv_cache_dtype="int8"), dict(cpu_checkpointing=True)):
        with pytest.raises(NotImplementedError):
            GPTConfig(**kw)
    # "sparse" is ported; without a layout it is refused (the TPU model
    # would compute dense attention)
    with pytest.raises(ValueError, match="SparsityConfig"):
        GPTConfig(attention_impl="sparse")
    with pytest.raises(ValueError):
        GPTConfig(decode_impl="xla")
    with pytest.raises(ValueError):
        GPTConfig(attention_impl="flash")
    with pytest.raises(ValueError):
        GPTConfig(remat_policy="everything")
    assert GPTConfig(attention_impl="pallas").attention_impl == "pallas"
