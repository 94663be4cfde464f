"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Builds the same tiny GPT in both packages: the JAX model is initialized from
a seed, its params are handed to the port as numpy arrays through
``deepspeed_tpu_torch.convert``. Both run in f32 on the CPU. A sparse model
gets the same SparsityConfig built in each package (``sparsity_pair``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

# 2 layers, d_model 128, 2 heads x 64, vocab 256, max_seq 64
TINY = dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=2,
            d_model=128, d_ff=512)


def sparsity_pair(name, **kw):
    """(jax_config, port_config): the SparsityConfig class ``name`` built
    with the same arguments in both packages."""
    import deepspeed_tpu.ops.sparse_attention.sparsity_config as jsc
    import deepspeed_tpu_torch.ops.sparse_attention.sparsity_config as psc
    return getattr(jsc, name)(**kw), getattr(psc, name)(**kw)


def model_pair(seed=0, sparse=None, **overrides):
    """(jax_model, jax_params, port_model) with identical f32 weights.
    ``sparse=(class name, kwargs)``: attention_impl="sparse" over that
    SparsityConfig (the JAX params come from the dense twin, whose tree is
    the same)."""
    from deepspeed_tpu.models.gpt import GPT as JaxGPT
    from deepspeed_tpu.models.gpt import GPTConfig as JaxConfig
    from deepspeed_tpu_torch.convert import jax_params_to_state_dict
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    kw = {"remat": False, **TINY, **overrides}
    jcfg = JaxConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw)
    params = JaxGPT(jcfg).init(jax.random.PRNGKey(seed),
                               jnp.zeros((1, 4), jnp.int32))["params"]
    psparse = {}
    if sparse is not None:
        jsp, psp = sparsity_pair(sparse[0], **sparse[1])
        jcfg = dataclasses.replace(jcfg, attention_impl="sparse",
                                   sparse_attention=jsp)
        psparse = dict(attention_impl="sparse", sparse_attention=psp)
    jmodel = JaxGPT(jcfg)
    kw.pop("scan_layers", None)
    kw.update(psparse)
    pcfg = GPTConfig(dtype=torch.float32, param_dtype=torch.float32, **kw)
    pmodel = GPT(pcfg)
    pmodel.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, params), pcfg))
    return jmodel, params, pmodel


def prompts(n=6, vocab=256, seed=11, lo=3, hi=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]
