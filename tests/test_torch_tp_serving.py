"""``ServingEngine(tp=2)`` in the port against the TPU package's tp-2
engine, on the CPU, f32, tiny GPT-2 and GPT-NeoX configs, the port's two
ranks gloo processes (``torch_dist_helpers.run_ranks``):

  * greedy tokens equal the TPU ``ServingEngine(tp=2)``'s on the dense and
    the paged arena (the TPU engine's tp 2 tokens are its tp 1 tokens,
    tests/test_serving.py), bitwise equal on both ranks; each rank's arena
    holds half the heads (``kv_spec``);
  * int8 weights split over tp serve the tokens of their own greedy
    ``generate``, and those equal the TPU int8 engine's ``generate`` at
    tp 2;
  * a tp-2 request over a tp-1 engine is the TPU engine's ``ValueError``,
    and so is a mismatched degree at two ranks.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_helpers as helpers
from torch_port_helpers import TINY, model_pair, prompts
from torch_test_threads import one_torch_thread  # noqa: F401

MODELS = {"gpt2": {}, "neox": dict(num_heads=4, rotary=True,
                                    parallel_residual=True,
                                    tie_embeddings=False)}
N_NEW = 6
SERVE = dict(max_batch=2, decode_chunk=4)


@functools.lru_cache(None)
def _pair(name):
    jmodel, params, pmodel = model_pair(seed=53, **MODELS[name])
    state = {k: v.detach().numpy().copy()
             for k, v in pmodel.state_dict().items()}
    return jmodel, params, state


def _prompts():
    return prompts(n=4, seed=13, lo=3, hi=20)


@pytest.fixture(scope="module")
def port():
    calls = {name: ("serving", dict(
        cfg=dict(TINY, remat=False, **MODELS[name]), state=_pair(name)[2],
        prompts=_prompts(), n_new=N_NEW, int8_prompts=_prompts()[:2]))
        for name in MODELS}
    return helpers.run_ranks("torch_tp_helpers:cases", 2, timeout=300.0,
                             calls=calls)


@functools.lru_cache(None)
def _jax(name, paged):
    from deepspeed_tpu.parallel import mesh as mesh_lib
    from deepspeed_tpu.serving import ServingEngine as JaxServing
    jmodel, params, _ = _pair(name)
    try:
        eng = JaxServing(jmodel, model_parameters=params, dtype=jnp.float32,
                         tp=2, paged=paged, **SERVE)
        assert eng.tp == 2
        return [r.output_ids.tolist()
                for r in eng.run([p.copy() for p in _prompts()],
                                 max_new_tokens=N_NEW)]
    finally:
        mesh_lib.reset_global_mesh()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_tp2_serving_matches_jax_tp2(port, name, paged):
    want = _jax(name, paged)
    key = "paged" if paged else "dense"
    for got in port:
        assert got[name][key] == want
    # half the heads a position: d_model / 2 channels
    assert port[0][name]["arena_width"] == TINY["d_model"] // 2


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tp2_int8_serving_matches_jax_int8_generate(port, name):
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    from deepspeed_tpu.parallel import mesh as mesh_lib
    jmodel, params, _ = _pair(name)
    try:
        jeng = JaxEngine(jmodel, mp_size=2, dtype=jnp.float32,
                         model_parameters=params, quantize_bits=8)
        want = [np.asarray(jeng.generate(p[None], max_new_tokens=N_NEW,
                                         temperature=0.0))[0].tolist()
                for p in _prompts()[:2]]
    finally:
        mesh_lib.reset_global_mesh()
    for got in port:
        assert got[name]["int8_generate"] == want
        assert got[name]["int8"] == want
    assert port[0][name]["int8"] == port[1][name]["int8"]


def test_tp_mismatch_raises(port):
    for got in port:
        for name in MODELS:
            assert "requested but the engine's mesh has tp=2" in \
                got[name]["mismatch"]
