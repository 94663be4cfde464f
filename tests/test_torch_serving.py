"""The slice as a whole: the port's ServingEngine(megakernel=True) and
InferenceEngine.generate on the CPU against the TPU package's on the CPU,
greedy, same weights. Output token ids must be identical. Also: the port
imports neither JAX nor deepspeed_tpu, and its entry points refuse a CUDA
device on a host without CUDA instead of running on the CPU."""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import model_pair, prompts
from torch_test_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deepspeed_tpu_torch")


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=0)


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_serving_greedy_identical_to_jax(pair, decode_chunk):
    from deepspeed_tpu.serving import ServingEngine as JaxServing
    from deepspeed_tpu_torch import ServingEngine
    jmodel, params, pmodel = pair
    ps = prompts()
    kw = dict(max_batch=4, max_prompt_len=32, decode_chunk=decode_chunk,
              megakernel=True)
    ref = JaxServing(jmodel, model_parameters=params, dtype=jnp.float32,
                     **kw).run([p.copy() for p in ps], max_new_tokens=10)
    eng = ServingEngine(pmodel, device="cpu", dtype=torch.float32, **kw)
    out = eng.run([p.copy() for p in ps], max_new_tokens=10)
    for r, o in zip(ref, out):
        assert o.status == "done" and len(o.tokens) == 10
        np.testing.assert_array_equal(o.output_ids, r.output_ids)
    assert eng.metrics.requests_done == len(ps)
    assert eng.metrics.tokens_out == 10 * len(ps)


def test_generate_greedy_identical_to_jax(pair):
    from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
    from deepspeed_tpu_torch import init_inference
    jmodel, params, pmodel = pair
    ids = np.stack([p[:7] for p in prompts(n=2, lo=8)])
    ref = JaxEngine(jmodel, model_parameters=params,
                    dtype=jnp.float32).generate(ids, max_new_tokens=9,
                                                temperature=0.0)
    out = init_inference(pmodel, device="cpu", dtype=torch.float32).generate(
        ids, max_new_tokens=9, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_eos_and_budget_stop_lanes(pair):
    from deepspeed_tpu_torch import ServingEngine
    _, _, pmodel = pair
    eng = ServingEngine(pmodel, device="cpu", dtype=torch.float32,
                        max_batch=2, max_prompt_len=32, decode_chunk=4,
                        megakernel=True)
    ps = prompts(n=3)
    free = eng.run([p.copy() for p in ps], max_new_tokens=6)
    eos = free[0].tokens[2]
    eng2 = ServingEngine(pmodel, device="cpu", dtype=torch.float32,
                         max_batch=2, max_prompt_len=32, decode_chunk=4,
                         megakernel=True)
    out = eng2.run([p.copy() for p in ps], max_new_tokens=6,
                   eos_token_id=eos)
    cut = free[0].tokens.index(eos) + 1
    assert out[0].tokens == free[0].tokens[:cut]
    long = eng2.submit(np.arange(1, 40, dtype=np.int32), max_new_tokens=30)
    assert long.status == "rejected"


def test_sampled_decode_deterministic_under_seed(pair):
    """temperature > 0 through the fused Gumbel-max epilogue: the engine's
    torch.Generator makes a stream reproducible under its seed."""
    from deepspeed_tpu_torch import ServingEngine
    _, _, pmodel = pair
    ps = prompts(n=3)

    def run(seed):
        eng = ServingEngine(pmodel, device="cpu", dtype=torch.float32,
                            max_batch=2, max_prompt_len=32, decode_chunk=4,
                            megakernel=True, temperature=1.0, top_k=8,
                            top_p=0.9, seed=seed)
        return [r.tokens for r in eng.run([p.copy() for p in ps],
                                          max_new_tokens=8)]

    assert run(0) == run(0)
    assert run(0) != run(1)


def _imported_modules(source):
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_deepspeed_tpu():
    banned = ("jax", "jaxlib", "flax", "optax", "deepspeed_tpu")
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    for mod in _imported_modules(fh.read()):
                        top = mod.split(".")[0]
                        assert top not in banned, (f, mod)
    # every module of the package, imported in a fresh interpreter, pulls
    # in no banned module
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import deepspeed_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'deepspeed_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(n for n in new if n.split('.')[0] in "
        f"{banned!r})\n"
        "assert not bad, bad\n"
        "print(len([n for n in new if n.startswith('deepspeed_tpu_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 15


def test_cuda_device_without_cuda_raises(pair, monkeypatch):
    from deepspeed_tpu_torch import (InferenceEngine, ServingEngine,
                                     init_inference)
    from deepspeed_tpu_torch.models.gpt import GPT
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GPT(pair[2].cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_inference(model, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model, megakernel=True)
    assert next(model.parameters()).device.type == "cpu"
