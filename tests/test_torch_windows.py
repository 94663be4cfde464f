"""GPT-Neo's local attention windows (``GPTConfig.attn_windows``) in the
port against the TPU package, on the CPU in f32, over a GPT-Neo-shaped tiny
GPT: a global layer then a local one (window 5, shorter than the prompts),
unscaled scores (``qk_scale=1.0``), ``scan_layers=False``:

  * ``masked_cache_attention`` with a window equal to the JAX one;
  * ``forward`` logits, ``generate`` (prefill + decode, einsum and kernel
    decode routes) and its greedy tokens, and the forward's gradients;
  * the dense, fused-prefill and speculative ``ServingEngine``'s greedy
    tokens equal to the JAX ``ServingEngine``'s;
  * the paged engine, ``scan_layers=True`` with windows and windows under
    ``attention_impl="sparse"`` raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import InferenceEngine, ServingEngine
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig, lm_loss_fn

from torch_port_helpers import TINY, model_pair, prompts
from torch_test_threads import one_torch_thread  # noqa: F401

WINDOW = 5
NEO = dict(attn_windows=(None, WINDOW), scan_layers=False, qk_scale=1.0)
SERVE = dict(max_batch=3, max_prompt_len=32, max_queue=16, decode_chunk=4)
NEW = 8


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=3, **NEO)


@pytest.fixture(scope="module")
def reqs():
    return prompts(n=6, seed=4, lo=6, hi=30)


@pytest.mark.parametrize("per_row", [False, True])
def test_masked_cache_attention_window_matches_jax(per_row):
    from deepspeed_tpu.ops.pallas.decode_attention import \
        masked_cache_attention as jax_mca
    from deepspeed_tpu_torch.ops.cuda.decode_attention import \
        masked_cache_attention
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 3, 2, 8), (2, 16, 2, 8), (2, 16, 2, 8)))
    first = np.array([4, 11]) if per_row else 9
    for window in (None, 1, 4):
        ref = jax_mca(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(first), 0.5, window=window)
        got = masked_cache_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.as_tensor(first), 0.5,
                                     window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)


def test_forward_matches_jax(pair):
    jmodel, params, pmodel = pair
    ids = np.random.default_rng(1).integers(0, 256, (2, 24)).astype(np.int32)
    ref = jmodel.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got = pmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)
    # the window matters: the same weights without it differ
    plain = GPT(dataclasses.replace(pmodel.cfg, attn_windows=None))
    plain.load_state_dict(pmodel.state_dict())
    with torch.no_grad():
        assert (plain(torch.from_numpy(ids).long()) - got).abs().max() > 1e-3


def test_forward_grads_match_jax(pair):
    from deepspeed_tpu.models.gpt import lm_loss_fn as jax_loss
    from deepspeed_tpu_torch.convert import jax_params_to_state_dict
    jmodel, params, pmodel = pair
    ids = np.random.default_rng(2).integers(0, 256, (2, 20)).astype(np.int32)

    def loss(p):
        return jax_loss(jmodel.apply({"params": p}, jnp.asarray(ids)),
                        {"input_ids": jnp.asarray(ids)})

    ref_loss, ref_grads = jax.value_and_grad(loss)(params)
    ref = jax_params_to_state_dict(jax.tree.map(np.asarray, ref_grads),
                                   pmodel.cfg)
    pmodel.zero_grad()
    got_loss = lm_loss_fn(pmodel(torch.from_numpy(ids).long()),
                          {"input_ids": torch.from_numpy(ids).long()})
    got_loss.backward()
    assert abs(got_loss.item() - float(ref_loss)) < 1e-5
    for name, p in pmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=2e-5, rtol=1e-3, err_msg=name)
    pmodel.zero_grad()


@pytest.mark.parametrize("decode_impl", ["einsum", "auto"])
def test_generate_matches_jax(pair, decode_impl):
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    jmodel, params, pmodel = pair
    ids = np.random.default_rng(3).integers(1, 256, (2, 9)).astype(np.int32)
    ref = JaxEngine(jmodel, dtype=jnp.float32,
                    model_parameters=params).generate(
        ids, max_new_tokens=12, temperature=0.0)
    model = GPT(dataclasses.replace(pmodel.cfg, decode_impl=decode_impl))
    eng = InferenceEngine(model, model_parameters=pmodel.state_dict(),
                          dtype=torch.float32, device="cpu")
    out = eng.generate(ids, max_new_tokens=12, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # prefill + decode logits against the cacheless forward: the window
    # reaches past the prompt into the decoded tokens
    with torch.no_grad():
        full = eng.forward(out.numpy())
        hidden, keys, values = model.prefill(out[:, :9])
        shape = (2, 2, 64, keys.shape[-1])
        ck, cv = torch.zeros(shape), torch.zeros(shape)
        ck[:, :, :9], cv[:, :, :9] = keys, values
        pos = torch.full((2,), 9)
        step = model.decode(out[:, 9:16], pos[:, None] + torch.arange(7),
                            ck, cv, pos)
    np.testing.assert_allclose(step.numpy(), full[:, 9:16].numpy(),
                               atol=2e-5, rtol=2e-5)


def _jax_serving(pair, **kw):
    from deepspeed_tpu.serving import ServingEngine as JaxServing
    jmodel, params, _ = pair
    return JaxServing(jmodel, model_parameters=params, dtype=jnp.float32,
                      **{**SERVE, **kw})


def _ids(out):
    assert all(r.status == "done" for r in out), [r.status for r in out]
    return [r.output_ids.tolist() for r in out]


SERVING = {"dense": {},
           "fused": dict(fused_prefill=True, prefill_chunk=4),
           "speculative": dict(speculative=True, spec_k=3)}


@pytest.mark.parametrize("name", sorted(SERVING))
def test_serving_matches_jax(pair, reqs, name):
    kw = SERVING[name]
    ref = _ids(_jax_serving(pair, **kw).run([p.copy() for p in reqs],
                                            max_new_tokens=NEW))
    for megakernel in (True, False):
        eng = ServingEngine(pair[2], device="cpu", dtype=torch.float32,
                            megakernel=megakernel, **SERVE, **kw)
        assert _ids(eng.run([p.copy() for p in reqs],
                            max_new_tokens=NEW)) == ref, megakernel


def test_paged_raises_as_jax_does(pair, reqs):
    with pytest.raises(NotImplementedError, match="local-window"):
        ServingEngine(pair[2], device="cpu", dtype=torch.float32,
                      paged=True, **SERVE)
    with pytest.raises(NotImplementedError, match="local-window"):
        _jax_serving(pair, paged=True).run([reqs[0].copy()],
                                           max_new_tokens=2)
    # the model's own paged decode refuses a windowed layer too
    model = pair[2]
    pool = torch.zeros(2, 3, 8, 128)
    with pytest.raises(NotImplementedError, match="local-window"):
        model.decode(torch.ones(1, 1, dtype=torch.long),
                     torch.zeros(1, 1, dtype=torch.long), pool, pool.clone(),
                     torch.zeros(1, dtype=torch.long),
                     block_tables=torch.zeros(1, 1, dtype=torch.int32))


def test_windows_refuse_scanned_and_sparse_configs():
    from deepspeed_tpu.models.gpt import GPT as JaxGPT
    from deepspeed_tpu.models.gpt import GPTConfig as JaxConfig
    kw = dict(TINY, attn_windows=(None, WINDOW))
    with pytest.raises(ValueError, match="scan_layers=False"):
        GPTConfig(**kw)
    with pytest.raises(ValueError, match="scan_layers=False"):
        JaxGPT(JaxConfig(**kw)).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 4), jnp.int32))
    with pytest.raises(ValueError, match="entries"):
        GPTConfig(**dict(kw, attn_windows=(None,), scan_layers=False))
    # the JAX model's sparse path drops the window; the port refuses
    from deepspeed_tpu_torch.ops.sparse_attention import \
        BigBirdSparsityConfig
    with pytest.raises(ValueError, match="sparse"):
        GPTConfig(**dict(kw, scan_layers=False, attention_impl="sparse",
                         sparse_attention=BigBirdSparsityConfig(
                             num_heads=2, block=16)))
