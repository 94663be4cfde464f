"""The zero.Init analogue of the port (deepspeed_tpu_torch/runtime/zero/
partition_params.py) against the JAX package's, on the CPU.

The counter-based shard fill is defined over the *flax* leaf: each element
is a function of (seed, flax path, index in the flattened flax leaf). The
port maps its parameters onto those leaves through
``convert.gpt_flax_leaves`` (checked here against ``jax_params_to_state_dict``
on index-valued trees) and generates a rank's slice at the flax indices of
its elements. Both packages run the same numpy float64 Box-Muller, so the
values are compared bitwise: a kernel, a bias, a LayerNorm scale and the
embeddings, sliced over dp 2 and 3, against the JAX fill of the whole leaf;
the port's host masters (HostOffloadOptimizer from a meta-device GPT) at dp
1 and 2 against each other and, converted, against the JAX
HostOffloadOptimizer built from the JAX model's abstract tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt import GPT as JaxGPT
from deepspeed_tpu.models.gpt import GPTConfig as JaxConfig
from deepspeed_tpu.runtime.sharding import path_str
from deepspeed_tpu.runtime.zero import partition_params as jpp
from deepspeed_tpu_torch.convert import gpt_flax_leaves, \
    jax_params_to_state_dict
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig, count_params, \
    gpt2_1_3b
from deepspeed_tpu_torch.runtime.zero import partition_params as pp

from torch_port_helpers import TINY
from torch_test_threads import one_torch_thread  # noqa: F401

SEED = 11


def _jax_tree(scan_layers=True, **kw):
    cfg = JaxConfig(scan_layers=scan_layers, **{**TINY, **kw})
    return jax.eval_shape(lambda: JaxGPT(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))["params"]


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("kw", [{}, {"tie_embeddings": False},
                                {"rotary": True}])
def test_flax_leaf_map_follows_the_conversion(scan_layers, kw):
    """An index-valued flax tree through jax_params_to_state_dict: every
    port element holds the flax index ``jax_index`` names."""
    tree = _jax_tree(scan_layers, **kw)
    index_tree = jax.tree_util.tree_map_with_path(
        lambda p, l: np.arange(np.prod(l.shape), dtype=np.float64
                               ).reshape(l.shape), tree)
    paths = {path_str(p): l.shape for p, l in
             jax.tree_util.tree_flatten_with_path(tree)[0]}
    cfg = GPTConfig(**{**TINY, **kw})
    sd = jax_params_to_state_dict(index_tree, cfg)
    leaves = gpt_flax_leaves(cfg, scan_layers=scan_layers)
    assert list(leaves) == [n for n, _ in GPT(cfg).named_parameters()]
    assert sorted(sd) == sorted(leaves)
    for name, leaf in leaves.items():
        assert paths[leaf.path] == leaf.shape, name
        got = sd[name].reshape(-1).numpy()
        want = leaf.jax_index(np.arange(got.size)).astype(np.float64)
        np.testing.assert_array_equal(got, want, err_msg=name)


FILL_PARAMS = ("blocks.1.attn.qkv.weight", "blocks.0.mlp.down_proj.weight",
               "blocks.0.mlp.up_proj.bias", "blocks.1.ln_2.weight",
               "wte.weight", "wpe")


@pytest.mark.parametrize("name", FILL_PARAMS)
@pytest.mark.parametrize("dp", [2, 3])
def test_fill_slices_equal_the_jax_fill_bitwise(name, dp):
    cfg = GPTConfig(**TINY)
    leaf = gpt_flax_leaves(cfg)[name]
    shape = tuple(GPT(cfg).get_parameter(name).shape)
    total = int(np.prod(shape))
    per = -(-total // dp)
    parts = []
    for r in range(dp):
        lo, hi = r * per, min((r + 1) * per, total)
        out = torch.empty(hi - lo)
        pp.fill_param_slice(leaf, lo, hi, out, seed=SEED)
        parts.append(out)
    port = torch.cat(parts).numpy()
    jax_leaf = jpp.fill_abstract_shard(
        leaf.path, leaf.shape, 0, int(np.prod(leaf.shape)), seed=SEED)
    np.testing.assert_array_equal(port, jax_leaf[leaf.jax_index(
        np.arange(total))])
    kind = jpp._fill_kind(leaf.path, leaf.shape, jpp.DEFAULT_INIT_RULES)
    assert kind == {"qkv": "fan_in_normal", "down_proj": "fan_in_normal",
                    "bias": "zeros", "ln_2": "ones", "wte": "embed_normal",
                    "wpe": "embed_normal"}[next(
                        k for k in ("qkv", "down_proj", "bias", "ln_2", "wte",
                                    "wpe") if k in name)]


def _port_masters(dp, **kw):
    """The port's host masters of a meta-device GPT, whole leaves, merged
    from every rank's slices at ``dp``."""
    from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
    model = pp.abstract_init(GPT, GPTConfig(**{**TINY, **kw}))
    named = list(model.named_parameters())
    slices = [HostOffloadOptimizer(
        named, lr=1e-3, mirror_dtype=torch.float32, dp_shard=(r, 1, dp),
        init_seed=SEED, flax_leaves=pp.flax_leaves(model))
        for r in range(dp)]
    out = {}
    for i, (name, p) in enumerate(named):
        flat = torch.cat([s.leaves[i].master for s in slices])
        out[name] = flat[:p.numel()].view(p.shape).numpy()
        assert all(s.leaves[i].numel == -(-p.numel() // dp) for s in slices)
    return out


def test_host_master_at_dp2_equals_dp1_and_the_jax_host_master():
    from deepspeed_tpu.runtime.zero.offload import \
        HostOffloadOptimizer as JaxHost
    one, two = _port_masters(1), _port_masters(2)
    for name in one:
        np.testing.assert_array_equal(two[name], one[name], err_msg=name)
    jax_host = JaxHost(_jax_tree(), lr=1e-3, mirror_dtype="float32",
                       dp_shard=(0, 1, 1), init_seed=SEED)
    want = jax_params_to_state_dict(jax_host.master_tree(),
                                    GPTConfig(**TINY))
    assert sorted(want) == sorted(one)
    for name, w in want.items():
        np.testing.assert_array_equal(one[name], w.numpy(), err_msg=name)


def test_abstract_init_allocates_nothing_at_any_size():
    model = pp.abstract_init(GPT, gpt2_1_3b())
    assert pp.is_abstract_tree(model)
    n = pp.num_params(model)
    assert 1.30e9 < n < 1.33e9, n
    assert not pp.is_abstract_tree(GPT(GPTConfig(**TINY)))
    tiny = pp.abstract_init(GPT, GPTConfig(**TINY))
    assert pp.num_params(tiny) == count_params(GPT(GPTConfig(**TINY)))


@pytest.mark.parametrize("dp", [1, 2])
def test_sharded_init_gives_each_rank_its_fill_slice(dp):
    cfg = GPTConfig(**TINY)
    model = pp.abstract_init(GPT, cfg)
    whole = _port_masters(1)
    leaves = gpt_flax_leaves(cfg)
    for rank in range(dp):
        got = pp.sharded_init(model, seed=SEED, dp=dp, rank=rank,
                              param_persistence_threshold=1000,
                              device="cpu")
        assert list(got) == list(leaves)
        for name, t in got.items():
            full = whole[name]
            if dp > 1 and full.size > 1000:
                per = -(-full.size // dp)
                want = np.zeros(per, np.float32)
                part = full.reshape(-1)[rank * per:(rank + 1) * per]
                want[:part.size] = part
                assert t.shape == (per,)
            else:
                want = full
            np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
