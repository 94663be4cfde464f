"""int8 weight quantization (``deepspeed_tpu_torch/ops/quantizer.py``,
``InferenceEngine(quantize_bits=8)``) against the TPU package's, on the CPU:

  * ``quantize`` / ``dequantize``, ``quantize_asym`` / ``dequantize_asym``
    and the deterministic ``ds_quantize`` variants bitwise equal to JAX's;
  * the stochastic ``ds_quantize`` variants land on the grid next to the
    value, are unbiased (mean error over 4000 draws within 4 standard
    errors of 0) and saturate at the group extremes;
  * ``quantize_module``'s codes, scales and dequantized weights bitwise
    equal to ``quantize_tree`` / ``dequantize_tree`` of the JAX tree, for a
    scanned config (a column's group spans every layer) and an unscanned
    one (per-layer groups), in f32 and after the bf16 cast;
  * ``InferenceEngine(quantize_bits=8)`` symmetric and asymmetric: logits
    within 1e-4 of the JAX engine's, greedy tokens equal, also through
    ``ServingEngine(engine=ie)`` (dense and int8 KV) against the JAX
    ServingEngine over the quantized JAX engine;
  * the scales stay f32 through ``.to(torch.bfloat16)``; only GEMM weights
    are quantized.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import InferenceEngine, ServingEngine
from deepspeed_tpu_torch.convert import jax_params_to_state_dict
from deepspeed_tpu_torch.models.gpt import GPT
from deepspeed_tpu_torch.ops import quantizer as pq

from torch_port_helpers import model_pair, prompts
from torch_test_threads import one_torch_thread  # noqa: F401

MODES = ("symmetric", "asymmetric")
SERVE = dict(max_batch=3, max_prompt_len=32, max_queue=16, decode_chunk=4)


def _x(shape=(6, 96), seed=0, scale=3.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale
         ).astype(np.float32)
    x[1] = 0.0                                  # an all-zero group
    x[2, 5] = 40.0                              # an outlier
    return x


@pytest.mark.parametrize("groups", [1, 3, 6])
def test_quantize_dequantize_bitwise_jax(groups):
    from deepspeed_tpu.ops import quantizer as jq
    x = _x()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    q, s = jq.quantize(jx, groups)
    tq, ts = pq.quantize(tx, groups)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            pq.dequantize(tq, ts, tdt).float().numpy(),
            np.asarray(jq.dequantize(q, s, dt).astype(jnp.float32)))
    q, s, m = jq.quantize_asym(jx, groups)
    tq, ts, tm = pq.quantize_asym(tx, groups)
    for a, b in ((tq, q), (ts, s), (tm, m)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        pq.dequantize_asym(tq, ts, tm, torch.float32).numpy(),
        np.asarray(jq.dequantize_asym(q, s, m, jnp.float32)))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("asymmetric", [False, True])
@pytest.mark.parametrize("groups", [1, 6])
def test_ds_quantize_deterministic_bitwise_jax(groups, asymmetric, bits):
    from deepspeed_tpu.ops.quantizer import ds_quantize
    x = _x()
    ref = ds_quantize(jnp.asarray(x), groups, bits, asymmetric=asymmetric)
    got = pq.ds_quantize(torch.from_numpy(x), groups, bits,
                         asymmetric=asymmetric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("asymmetric", [False, True])
def test_ds_quantize_stochastic(asymmetric):
    groups, bits, n = 4, 8, 4000
    x = _x((4, 64), seed=1)
    tx = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([pq.ds_quantize(tx, groups, bits,
                                        asymmetric=asymmetric,
                                        stochastic=True, generator=gen)
                         for _ in range(n)]).numpy()
    flat = x.reshape(groups, -1)
    if asymmetric:
        mn = flat.min(1, keepdims=True)
        step = (flat.max(1, keepdims=True) - mn + 1e-5) / 256.0
        codes = (draws.reshape(n, groups, -1) - mn) / step
        lo, hi = 0, 255
    else:
        amax = np.abs(flat).max(1, keepdims=True)
        step = 1.0 / (256.0 / (2.0 * amax + 1e-5))
        codes = draws.reshape(n, groups, -1) / step
        lo, hi = -128, 127
    # on the grid, next to the value, inside the code range
    np.testing.assert_allclose(codes, np.round(codes), atol=1e-3)
    ideal = ((flat - mn) if asymmetric else flat) / step
    assert np.all(np.abs(np.round(codes) - ideal) < 1.0 + 1e-3)
    assert np.round(codes).min() >= lo and np.round(codes).max() <= hi
    # unbiased: away from the clamps, the mean error over the draws is
    # within 4 standard errors of zero (a draw rounds up with probability
    # p, the fractional part: the error's deviation is step sqrt(p(1-p)))
    err = draws.reshape(n, groups, -1) - flat
    inside = (np.abs(ideal - np.clip(ideal, lo + 1, hi - 1)) == 0)
    p = np.abs(ideal - np.trunc(ideal))
    se = step * np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(err.mean(0))[inside] <= 4 * se[inside] + 1e-6)
    # saturation: a group's extreme keeps its value (never wraps)
    ext = np.argmax(np.abs(flat), 1)
    for g in range(groups):
        vals = draws.reshape(n, groups, -1)[:, g, ext[g]]
        assert np.all(np.abs(vals - flat[g, ext[g]]) <= step[g, 0] + 1e-5)
    # a generator is required, as the JAX version requires a key
    with pytest.raises(ValueError, match="Generator"):
        pq.ds_quantize(tx, groups, stochastic=True)


@pytest.fixture(scope="module", params=["scanned", "unscanned"])
def pair(request):
    return model_pair(seed=7, scan_layers=request.param == "scanned",
                      tie_embeddings=False)


def _jax_cast(params, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_module_bitwise_jax_trees(pair, mode, dtype):
    from deepspeed_tpu.ops.quantizer import dequantize_tree, quantize_tree
    jmodel, params, pmodel = pair
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    qtree = quantize_tree(_jax_cast(params, jdt), mode=mode)
    deq = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                       dequantize_tree(qtree, jdt))
    ref = jax_params_to_state_dict(deq, pmodel.cfg)
    model = GPT(pmodel.cfg)
    model.load_state_dict(pmodel.state_dict())
    pq.quantize_module(model, mode=mode, dtype=tdt,
                       scan_layers=pmodel.cfg.scan_layers)
    lin = {n: m for n, m in model.named_modules()
           if isinstance(m, pq.Int8Linear)}
    assert sorted(lin) == sorted(
        n for n, m in pmodel.named_modules() if isinstance(m, torch.nn.Linear))
    assert "lm_head" in lin                       # untied: quantized
    for name, m in lin.items():
        np.testing.assert_array_equal(m.weight.float().numpy(),
                                      ref[name + ".weight"].numpy(), name)
        assert m.scale.dtype == torch.float32
    # codes and scales: a scanned kernel's groups span all layers
    leaf = (qtree["blocks"]["attn"]["qkv"]["kernel"]
            if pmodel.cfg.scan_layers
            else qtree["block_1"]["attn"]["qkv"]["kernel"])
    q8 = np.asarray(leaf["q8"])
    m = lin["blocks.1.attn.qkv"]
    np.testing.assert_array_equal(
        m.q8.numpy(), q8[:, 1] if pmodel.cfg.scan_layers else q8)
    np.testing.assert_array_equal(m.scale.numpy(), np.asarray(leaf["scale"]))
    if pmodel.cfg.scan_layers:
        assert torch.equal(lin["blocks.0.attn.qkv"].scale, m.scale)
    else:
        assert not torch.equal(lin["blocks.0.attn.qkv"].scale, m.scale)


def test_scales_stay_f32_and_only_gemm_weights_are_int8(pair):
    _, _, pmodel = pair
    model = GPT(pmodel.cfg)
    model.load_state_dict(pmodel.state_dict())
    pq.quantize_module(model, mode="asymmetric", dtype=torch.bfloat16)
    model.to(torch.bfloat16)
    for name, m in model.named_modules():
        if isinstance(m, pq.Int8Linear):
            assert m.q8.dtype == torch.int8
            assert m.scale.dtype == m.zmin.dtype == torch.float32, name
            assert m.bias is None or m.bias.dtype == torch.bfloat16
            assert m.weight.dtype == torch.bfloat16
    for name in ("wte.weight", "wpe", "ln_f.weight",
                 "blocks.0.ln_1.weight"):
        assert model.state_dict()[name].dtype == torch.bfloat16, name
    int8 = pq.weight_bytes(model)
    full = sum(t.numel() * 2 for t in pmodel.state_dict().values())
    assert int8 < 0.6 * full


@pytest.mark.parametrize("mode", MODES)
def test_quantized_engine_matches_jax(pair, mode):
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    from deepspeed_tpu.serving import ServingEngine as JaxServing
    jmodel, params, pmodel = pair
    jeng = JaxEngine(jmodel, dtype=jnp.float32, model_parameters=params,
                     quantize_bits=8, quantize_mode=mode)
    eng = InferenceEngine(GPT(pmodel.cfg), dtype=torch.float32,
                          model_parameters=pmodel.state_dict(),
                          quantize_bits=8, quantize_mode=mode, device="cpu")
    assert eng.quantized
    ids = np.random.default_rng(8).integers(1, 256, (2, 12)).astype(np.int32)
    ref = np.asarray(jeng.forward(ids))
    got = eng.forward(ids).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    # the quantization is felt: the unquantized logits differ
    assert np.abs(got - pmodel(torch.from_numpy(ids).long()).detach()
                  .numpy()).max() > 1e-4
    np.testing.assert_array_equal(
        eng.generate(ids, max_new_tokens=8, temperature=0.0).numpy(),
        np.asarray(jeng.generate(ids, max_new_tokens=8, temperature=0.0)))
    # served: the JAX ServingEngine cannot take a quantized engine (its
    # arena is shaped over the unmaterialized int8 tree), so each request's
    # tokens are held to the JAX engine's greedy generate
    reqs = prompts(n=3, seed=9, lo=4, hi=24)
    want = [np.asarray(jeng.generate(p[None], max_new_tokens=6,
                                     temperature=0.0))[0, len(p):].tolist()
            for p in reqs]
    for kv_dtype in ("auto", "int8"):
        serving = ServingEngine(engine=eng, megakernel=True,
                                kv_dtype=kv_dtype, **SERVE)
        out = serving.run([p.copy() for p in reqs], max_new_tokens=6)
        assert all(isinstance(m, pq.Int8Linear) for n, m in
                   serving.module.named_modules() if n.endswith("qkv"))
        assert all(r.status == "done" for r in out)
        if kv_dtype == "auto":
            assert [list(r.tokens) for r in out] == want
    with pytest.raises(Exception, match="kernel"):
        JaxServing(engine=jeng, **SERVE)


def test_quantized_engine_rejects_other_widths(pair):
    with pytest.raises(ValueError, match="8 bits"):
        InferenceEngine(GPT(pair[2].cfg), device="cpu", quantize_bits=4)
    with pytest.raises(ValueError, match="quantize mode"):
        pq.quantize_module(GPT(pair[2].cfg), mode="int4")
