"""Large-model construction without materialization: the ``zero.Init``
analogue.

Counterpart of ``deepspeed_tpu/runtime/zero/partition_params.py``
(reference ``deepspeed/runtime/zero/partition_parameters.py:529``, a
context manager under which every parameter is partitioned over the dp
ranks, or pushed to cpu / nvme, as it is created).

  * :func:`abstract_init` builds the module on ``torch.device("meta")``:
    shapes and dtypes, no storage, at any size (the TPU package traces
    ``model.init`` with ``jax.eval_shape``). The offload engine takes such a
    module and fills only its own rank's host shards.
  * :func:`fill_abstract_shard` generates elements of one leaf without the
    rest of it. Each element is a pure function of (seed, the flax path of
    the leaf, the element's index in the flattened *flax* leaf): counter
    based SplitMix64 uniforms through Box-Muller, in numpy, as the TPU
    package computes them. A port parameter maps onto its flax leaf through
    the model's own map (``GPT.flax_leaves``, from
    ``convert.gpt_flax_leaves``: a Dense kernel is ``[in, out]`` there and
    ``[out, in]`` here, block leaves are stacked ``[L, ...]``), so a port
    rank's slice is generated at the flax indices of its elements
    (:func:`flax_leaves`, :func:`fill_param_slice`), and a host master filled
    here and converted back equals the TPU package's fill, at any dp.
  * :func:`sharded_init` materializes each rank's stage-3 slices from that
    fill. The TPU package's ``sharded_init`` replays flax's PRNGKey init
    into the shards; the port cannot run flax, so its slices are the
    counter fill's values instead (the same distribution family, not the
    same numbers; ROADMAP C).
"""

from __future__ import annotations

import concurrent.futures
import os
import re
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...convert import FlaxLeaf

FILL_CHUNK = 1 << 20          # elements generated per numpy call


def abstract_init(build: Callable[..., nn.Module], *args, **kwargs
                  ) -> nn.Module:
    """``build(*args, **kwargs)`` (a module class or factory) on the meta
    device: shapes only, zero bytes, any model size."""
    with torch.device("meta"):
        return build(*args, **kwargs)


def is_abstract_tree(module: nn.Module) -> bool:
    """True when every parameter of ``module`` is on the meta device."""
    params = list(module.parameters())
    return bool(params) and all(p.is_meta for p in params)


def num_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


# -- streamed host-shard fills ------------------------------------------------

# (path regex, fill kind): first match wins. The TPU package's rules,
# which mirror flax's defaults: Dense / attention kernels lecun_normal
# family, embeddings normal(0.02), biases zeros, LayerNorm scale ones.
DEFAULT_INIT_RULES: Tuple[Tuple[str, str], ...] = (
    (r"(^|/)(wte|wpe|embed|embedding)(/|$)", "embed_normal"),
    (r"(/|^)(bias|b)$", "zeros"),
    (r"(/|^)(scale|gamma)$", "ones"),
    (r"(/|^)beta$", "zeros"),
    (r"kernel$|w$|weight$|proj$", "fan_in_normal"),
)


def _fill_kind(path: str, shape, rules) -> str:
    for pat, kind in rules:
        if re.search(pat, path):
            return kind
    # no rule matched: matrices get the fan-in normal (a silently
    # zero-initialized weight would train dead), vectors get zeros
    return "fan_in_normal" if len(shape) >= 2 else "zeros"


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Counter-based 64-bit mix (SplitMix64): uint64[n] -> uint64[n], in
    place (the TPU package's operations, without its temporaries)."""
    t = np.empty_like(x)
    with np.errstate(over="ignore"):
        x += np.uint64(0x9E3779B97F4A7C15)
        np.right_shift(x, np.uint64(30), out=t)
        x ^= t
        x *= np.uint64(0xBF58476D1CE4E5B9)
        np.right_shift(x, np.uint64(27), out=t)
        x ^= t
        x *= np.uint64(0x94D049BB133111EB)
        np.right_shift(x, np.uint64(31), out=t)
        x ^= t
    return x


def _path_seed(path: str, seed: int) -> np.uint64:
    h = np.uint64(2166136261)
    with np.errstate(over="ignore"):
        for ch in path.encode():  # FNV-1a: stable across processes
            h = (h ^ np.uint64(ch)) * np.uint64(16777619)
        return _splitmix64(np.asarray([h ^ np.uint64(seed)]))[0]


def _uniform(index: np.ndarray, offset: int, base: np.uint64) -> np.ndarray:
    """The 53-bit mantissa of ``splitmix64(2 index + offset + base)`` as
    float64 in [0, 1) (the TPU package's u1 / u2 before the scale)."""
    with np.errstate(over="ignore"):
        u = index * np.uint64(2)
        u += np.uint64(offset)
        u += base
    u = _splitmix64(u)
    u >>= np.uint64(11)
    return u.astype(np.float64)


def _normal(index: np.ndarray, base: np.uint64, std: float) -> np.ndarray:
    """Box-Muller over the counter stream, operation for operation the TPU
    package's ``fill_abstract_shard`` (so bitwise its values), in place."""
    idx = index.astype(np.uint64)
    # uniforms in (0, 1]; u1 flipped away from 0 for the log
    f1 = _uniform(idx, 0, base)
    f1 += 1.0
    f1 /= 2.0 ** 53
    f2 = _uniform(idx, 1, base)
    f2 /= 2.0 ** 53
    np.log(f1, out=f1)
    f1 *= -2.0
    np.sqrt(f1, out=f1)
    f2 *= 2.0 * np.pi
    np.cos(f2, out=f2)
    f1 *= f2
    f1 *= std
    return f1.astype(np.float32)


def fill_abstract_shard(path: str, shape, index, *, seed: int,
                        rules=DEFAULT_INIT_RULES,
                        init_std: float = 0.02) -> np.ndarray:
    """The values of the flattened leaf ``path`` (flax path, leaf
    ``shape``) at the element indices ``index`` (int array, any order),
    generated without the rest of the leaf: f32 [len(index)]. Equal, index
    for index, to the TPU package's ``fill_abstract_shard(path, shape, lo,
    hi)`` over ``arange(lo, hi)``."""
    index = np.asarray(index, np.int64).reshape(-1)
    n = index.size
    kind = _fill_kind(path, shape, rules)
    if kind == "zeros":
        return np.zeros(n, np.float32)
    if kind == "ones":
        return np.ones(n, np.float32)
    if kind == "embed_normal":
        std = init_std
    else:  # fan_in_normal: flax lecun_normal family, fan_in = prod(shape[:-1])
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else int(shape[0])
        std = float(np.sqrt(1.0 / max(fan_in, 1)))
    return _normal(index, _path_seed(path, seed), std)


def flax_leaves(module: nn.Module) -> Dict[str, FlaxLeaf]:
    """Port parameter name -> the flax leaf its fill is defined over: the
    module's own map where it has one (``GPT.flax_leaves``), else the
    parameter itself under its "/"-joined name."""
    own = getattr(module, "flax_leaves", None)
    if own is not None:
        return own()
    return {n: FlaxLeaf(n.replace(".", "/"), tuple(p.shape))
            for n, p in module.named_parameters()}


def fill_param_slice(leaf: FlaxLeaf, lo: int, hi: int, out: torch.Tensor, *,
                     seed: int, rules=DEFAULT_INIT_RULES,
                     init_std: float = 0.02,
                     pool: Optional[concurrent.futures.Executor] = None
                     ) -> None:
    """Write elements ``[lo, hi)`` of the flattened port parameter of
    ``leaf`` into the f32 CPU tensor ``out`` (``hi - lo`` elements), in
    chunks of FILL_CHUNK, over ``pool``'s threads when given (numpy's
    ufuncs release the GIL)."""
    dst = out.numpy()

    def chunk(a: int) -> None:
        b = min(a + FILL_CHUNK, hi)
        dst[a - lo:b - lo] = fill_abstract_shard(
            leaf.path, leaf.shape, leaf.jax_index(np.arange(a, b)),
            seed=seed, rules=rules, init_std=init_std)
    starts = range(lo, hi, FILL_CHUNK)
    if pool is None:
        for a in starts:
            chunk(a)
    else:
        for f in [pool.submit(chunk, a) for a in starts]:
            f.result()


def fill_pool() -> concurrent.futures.ThreadPoolExecutor:
    """Threads for :func:`fill_param_slice`: one per usable core."""
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=max(1, len(os.sched_getaffinity(0))))


def sharded_init(model: nn.Module, *, seed: int = 0, dp: int = 1,
                 rank: int = 0, param_persistence_threshold: int = 0,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 rules=DEFAULT_INIT_RULES) -> Dict[str, torch.Tensor]:
    """This rank's ZeRO-3 parameters of ``model`` (an abstract module or
    any module of that shape), generated by the counter fill: name -> the
    rank's flat ``ceil(numel / dp)`` slice (zero-padded past the leaf) for
    a parameter above ``param_persistence_threshold`` elements, the whole
    parameter otherwise. Only this rank's elements are ever generated."""
    from ..sharding import ShardingRules
    from ...utils.device import resolve_device
    dev = resolve_device(device)
    rules_ = ShardingRules(dp, 3, rank,
                           param_persistence_threshold=param_persistence_threshold)
    out = {}
    with fill_pool() as pool:
        for name, leaf in flax_leaves(model).items():
            shape = tuple(model.get_parameter(name).shape)
            spec = rules_.param_spec(name, shape)
            hi = min(spec.offset + spec.numel, spec.global_numel)
            host = torch.zeros(spec.numel, dtype=torch.float32)
            if hi > spec.offset:
                fill_param_slice(leaf, spec.offset, hi,
                                 host[:hi - spec.offset], seed=seed,
                                 rules=rules, pool=pool)
            t = host if spec.partitioned else host.view(shape)
            out[name] = t.to(device=dev, dtype=dtype or torch.float32)
    return out
