"""The int8 KV cache in the port (deepspeed_tpu_torch/ops/quantizer.py, the
int8 branches of the dense and paged decode ops, the int8 arenas and
``ServingEngine(kv_dtype="int8")``) against the TPU package.

The quantizer is bitwise the TPU package's. The int8 decode plain versions
are held to the TPU package's decode kernels with ``k_scale`` (Pallas in
interpret mode; f32, atol 2e-5 as tests/test_paged_kv.py holds the paged
kernel). Greedy serving tokens equal the TPU int8 engine's, dense and paged,
and each other. CPU tensors, so no kernel launches; the CUDA int8 branches
are held to the same plain versions in tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu.ops.pallas import decode_attention as jda
from deepspeed_tpu_torch.ops import quantizer as pq
from deepspeed_tpu_torch.ops.cuda import decode_attention as pda

from torch_port_helpers import model_pair, prompts
from torch_test_threads import one_torch_thread  # noqa: F401

ATOL = 2e-5


@pytest.mark.parametrize("scale", [1e-3, 1.0, 40.0])
def test_quantize_and_dequantize_bitwise_equal_to_jax(scale):
    rng = np.random.default_rng(int(scale * 1000))
    x = (rng.standard_normal((3, 7, 128)) * scale).astype(np.float32)
    x[0, 0] = 0.0                               # an all-zero group
    x[1, 2, :4] = [0.5, -0.5, 1.5, 2.5]         # round half to even
    jqv, jsv = jq.quantize_kv(jnp.asarray(x))
    qv, sv = pq.quantize_kv(torch.from_numpy(x))
    assert qv.dtype == torch.int8 and sv.dtype == torch.float32
    assert sv.shape == (3, 7, 1)
    np.testing.assert_array_equal(qv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jsv))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jq.dequantize_kv(jqv, jsv, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(
            pq.dequantize_kv(qv, sv, tdt).float().numpy(), ref)


def _int8(rng, shape):
    """Random f32 values quantized by the TPU package: (int8, scales [...])."""
    q, s = jq.quantize_kv(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32)))
    return np.array(q), np.array(s)[..., 0]


@pytest.mark.parametrize("s_q", [1, 4, 8])
def test_dense_int8_plain_matches_pallas_kernel_interpret(s_q):
    rng = np.random.default_rng(s_q)
    b, S, h, d = 3, 64, 2, 64
    q = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    (k, ks), (v, vs) = _int8(rng, (b, S, h * d)), _int8(rng, (b, S, h * d))
    fills = np.array([s_q, 37, S + s_q], np.int32)
    assert jda.pallas_decode_supported(b, S, h, d, jnp.int8, s_q)
    ref = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(fills),
        scale=0.125, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    t = torch.from_numpy
    out = pda.decode_attention(t(q), t(k), t(v), t(fills), scale=0.125,
                               k_scale=t(ks), v_scale=t(vs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("s_q", [1, 3, 8])
def test_paged_int8_plain_matches_tpu_paged_attention(impl, s_q):
    rng = np.random.default_rng(10 + s_q)
    b, h, d, bs, T = 4, 2, 64, 8, 6
    nb = b * T + 3
    q = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    (kp, ks), (vp, vs) = (_int8(rng, (nb, bs, h * d)),
                          _int8(rng, (nb, bs, h * d)))
    tables = rng.permutation(nb)[:b * T].reshape(b, T).astype(np.int32)
    fills = np.array([s_q, 13, T * bs, T * bs + s_q], np.int32)
    live = (np.minimum(fills, T * bs) + bs - 1) // bs
    tables = np.where(np.arange(T)[None, :] >= live[:, None], nb,
                      tables).astype(np.int32)
    ref = np.asarray(jda.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, fills)), scale=0.125,
        impl=impl, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    t = torch.from_numpy
    out = pda.paged_decode_attention(
        t(q), t(kp), t(vp), t(tables), t(fills), scale=0.125, k_scale=t(ks),
        v_scale=t(vs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_int8_config_is_ported():
    from deepspeed_tpu_torch.models.gpt import GPTConfig
    assert GPTConfig(kv_cache_dtype="int8").kv_cache_dtype == "int8"
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        GPTConfig(kv_cache_dtype="fp8")


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=0)


def test_int8_prefill_returns_the_quantized_cache_and_decode_needs_it(pair):
    """Under int8, prefill returns the TPU quantizer's payload and scales of
    its K/V (layer 0's inputs are the fp model's; later layers see attention
    over the dequantized cache), and decode refuses a cache without
    scales."""
    import dataclasses
    from deepspeed_tpu_torch.models.gpt import GPT
    pm = pair[2]
    m8 = GPT(dataclasses.replace(pm.cfg, kv_cache_dtype="int8"))
    m8.load_state_dict(pm.state_dict())
    ids = torch.from_numpy(prompts(n=1)[0][None].astype(np.int64))
    with torch.no_grad():
        _, keys, values = pm.prefill(ids)
        _, k8, v8, ks, vs = m8.prefill(ids)
    for fp, q8, sc in ((keys, k8, ks), (values, v8, vs)):
        jqv, jsv = jq.quantize_kv(jnp.asarray(fp[0].numpy()))
        np.testing.assert_array_equal(q8[0].numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(sc[0].numpy(), np.asarray(jsv)[..., 0])
        assert q8.dtype == torch.int8 and sc.shape == q8.shape[:3]
    cache = torch.zeros(2, 1, 64, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 cache needs its scales"):
        m8.decode(ids[:, :1], ids[:, :1] * 0, cache, cache,
                  torch.zeros(1, dtype=torch.long))


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_int8_serving_greedy_identical_to_jax_dense_and_paged(pair,
                                                              decode_chunk):
    from deepspeed_tpu.serving import ServingEngine as JaxServing
    from deepspeed_tpu_torch import ServingEngine
    jmodel, params, pmodel = pair
    ps = prompts(n=5, seed=8)
    kw = dict(max_batch=3, max_prompt_len=32, max_queue=8,
              decode_chunk=decode_chunk, megakernel=True, kv_dtype="int8")
    outs = {}
    for name, extra in (("dense", {}),
                        ("paged", dict(paged=True, kv_block_size=8))):
        ref = JaxServing(jmodel, model_parameters=params, dtype=jnp.float32,
                         **kw, **extra).run([p.copy() for p in ps],
                                            max_new_tokens=9)
        eng = ServingEngine(pmodel, device="cpu", dtype=torch.float32, **kw,
                            **extra)
        out = eng.run([p.copy() for p in ps], max_new_tokens=9)
        for r, o in zip(ref, out):
            assert o.status == "done" and len(o.tokens) == 9
            np.testing.assert_array_equal(o.output_ids, r.output_ids)
        outs[name] = [o.tokens for o in out]
        assert eng.module is not pmodel and pmodel.cfg.kv_cache_dtype == "auto"
        assert eng.module.wte.weight.data_ptr() == \
            pmodel.wte.weight.data_ptr()         # no copy of the weights
    assert outs["dense"] == outs["paged"]


def test_int8_arena_report_halves_the_payload(pair):
    """int8 is one quantization decision with two layouts: the payload is at
    most half the compute dtype's bytes (a quarter here: f32), the saved
    delta is reported, and the dense arena's bytes equal the TPU arena's."""
    from deepspeed_tpu.serving import ServingEngine as JaxServing
    from deepspeed_tpu_torch import ServingEngine
    jmodel, params, pmodel = pair
    kw = dict(max_batch=4, max_prompt_len=16, max_queue=8, decode_chunk=4)
    reps = {}
    for name, extra in (("dense", {}), ("paged", dict(paged=True))):
        eng = ServingEngine(pmodel, device="cpu", dtype=torch.float32,
                            kv_dtype="int8", **kw, **extra)
        eng.run([p.copy() for p in prompts(n=4, hi=16)], max_new_tokens=5)
        rep = reps[name] = eng.kv.arena_report()
        assert rep["int8_payload_bytes"] > 0 and rep["scale_bytes"] > 0
        assert rep["kv_bytes"] <= 0.5 * rep["kv_bytes_fp_equiv"]
        assert rep["kv_bytes_saved"] == \
            rep["kv_bytes_fp_equiv"] - rep["kv_bytes"]
    jrep = JaxServing(jmodel, model_parameters=params, dtype=jnp.float32,
                      kv_dtype="int8", **kw).kv.arena_report()
    for key in ("kv_bytes", "int8_payload_bytes", "scale_bytes",
                "kv_bytes_fp_equiv", "bytes_per_slot"):
        assert reps["dense"][key] == jrep[key], key
    fp = ServingEngine(pmodel, device="cpu", dtype=torch.float32, **kw)
    assert fp.kv.arena_report()["kv_bytes_saved"] == 0
    assert fp.kv.k_scale is None


def test_int8_generate_greedy_identical_to_jax(pair):
    import dataclasses
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    from deepspeed_tpu.models.gpt import GPT as JaxGPT
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.gpt import GPT
    jmodel, params, pmodel = pair
    j8 = JaxGPT(dataclasses.replace(jmodel.cfg, kv_cache_dtype="int8"))
    p8 = GPT(dataclasses.replace(pmodel.cfg, kv_cache_dtype="int8"))
    p8.load_state_dict(pmodel.state_dict())
    ids = np.stack([p[:7] for p in prompts(n=2, lo=8)])
    ref = JaxEngine(j8, model_parameters=params, dtype=jnp.float32).generate(
        ids, max_new_tokens=8, temperature=0.0)
    out = init_inference(p8, device="cpu", dtype=torch.float32).generate(
        ids, max_new_tokens=8, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
