"""Policy-free automatic tensor parallelism.

Counterpart of ``deepspeed_tpu/module_inject/auto_tp.py`` (reference
``replace_wo_policy``, ``module_inject/replace_module.py:502``): for a model
without a hand-written policy, every Linear is split column-wise
(``LinearLayer``) except the ones that write the residual stream, which
become ``LinearAllreduce`` (row-split, reduced, bias added once). The TPU
package only assigns PartitionSpecs (:func:`infer_tp_specs`) and lets GSPMD
insert the collectives; here :func:`auto_tp` also walks the module and
swaps each classified layer for its shard (``module_inject/layers.py``).

The classification is the TPU package's, name first then shape
(:func:`classify`, on flax paths and flax kernel shapes ``[in, out]``):

  * name patterns (the sharding-rule vocabulary and common HF spellings);
  * an expanding kernel ``[d, k d]`` is column-parallel, a contracting one
    ``[k d, d]`` row-parallel; a square one with no name signal stays
    whole;
  * embeddings split their feature axis (the lookup is gathered).

A fused ``qkv`` Linear is split by heads, a third at a time
(``runtime.sharding.TpSplit`` with ``blocks=3``), so each rank holds its
heads of q, of k and of v; the TPU spec cuts its columns contiguously and
GSPMD reshards the product, which explicit collectives cannot do. A dim that
tp does not divide stays whole (logged), as do bare parameters (a learned
position table) whatever :func:`infer_tp_specs` says of them.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

from torch import nn

from ..utils.logging import logger
from .layers import shard_embedding, shard_linear, _set_submodule

COLUMN_PAT = re.compile(
    r"(qkv|query|key|value|q_proj|k_proj|v_proj|up_proj|gate_proj|fc_in|"
    r"wi|w1|w3|lm_head|intermediate)")
ROW_PAT = re.compile(r"(out_proj|o_proj|down_proj|dense_4h_to_h|fc_out|"
                     r"wo|w2|output)")
EMBED_PAT = re.compile(r"(wte|wpe|wtt|embed|embedding)")
_FUSED_QKV_PAT = re.compile(r"(^|[./\]'\[])qkv([./\]'\[]|$)")


def classify(path: str, shape: Tuple[int, ...]) -> Optional[str]:
    """-> 'column' | 'row' | 'embed' | None (replicate), for the leaf at
    ``path`` of flax ``shape`` (a kernel's ``[..., in, out]``)."""
    if EMBED_PAT.search(path):
        return "embed"
    if len(shape) < 2:
        return None
    if COLUMN_PAT.search(path):
        return "column"
    if ROW_PAT.search(path):
        return "row"
    d_in, d_out = shape[-2], shape[-1]
    if d_out >= 2 * d_in:
        return "column"
    if d_in >= 2 * d_out:
        return "row"
    return None


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    """(key, leaf) pairs of a nested mapping, keys in
    ``jax.tree_util.keystr``'s form (``['a']['b']``)."""
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, Mapping):
            yield from _flatten(v, key)
        else:
            yield key, v


def infer_tp_specs(params: Mapping[str, Any], report: bool = False
                   ) -> Dict[str, Tuple[Optional[str], ...]]:
    """The TPU package's PartitionSpec of every leaf of a flax params tree
    (a nested mapping of arrays), as tuples keyed like ``keystr``: column
    kernels split their last dim, row kernels the one before, embeddings
    their last (feature) dim; a bias is split only when its sibling kernel
    is column-split."""
    flat = list(_flatten(params))
    kinds = {key: classify(key, tuple(getattr(leaf, "shape", ())))
             for key, leaf in flat}
    specs = {}
    for key, leaf in flat:
        shape = tuple(getattr(leaf, "shape", ()))
        nd = len(shape)
        kind = kinds[key]
        spec = [None] * nd
        if kind in ("embed", "column") and nd >= 2:
            spec[-1] = "tp"
        elif kind == "row" and nd >= 2:
            spec[-2] = "tp"
        elif nd >= 1 and key.endswith("['bias']"):
            parent = key[:-len("['bias']")] + "['kernel']"
            if kinds.get(parent) == "column":
                spec[-1] = "tp"
        specs[key] = tuple(spec)
        if report:
            logger.info(f"auto-TP: {key} {shape} -> {kind or 'replicate'} "
                        f"{specs[key]}")
    return specs


def _linear_shape(module: nn.Module) -> Tuple[int, int]:
    """The flax kernel shape ``[in, out]`` of a Linear (``nn.Linear`` or an
    int8 ``Int8Linear``)."""
    return (module.in_features, module.out_features)


def auto_tp(model: nn.Module, group, report: bool = False) -> nn.Module:
    """Split the whole ``model`` over the tp ``group`` by :func:`classify`,
    in place: column Linears keep their output features (a fused ``qkv``
    its heads of each third), row Linears their input features, embeddings
    (``nn.Embedding``) their feature columns. Linears are ``nn.Linear`` or
    int8 ``Int8Linear`` (quantized whole before this). Returns ``model``."""
    if group is None or group.size == 1:
        return model
    n = group.size
    for name, module in list(model.named_modules()):
        if getattr(module, "tp", None) is not None:
            continue
        if isinstance(module, nn.Embedding):
            kind = classify(name, tuple(module.weight.shape))
            if kind != "embed":
                continue
            if module.embedding_dim % n:
                logger.info(f"auto-TP: {name} keeps its {module.embedding_dim}"
                            f" features whole (tp={n} does not divide them)")
                continue
            _set_submodule(model, name, shard_embedding(module, "feature",
                                                        group))
        elif isinstance(module, nn.Linear) or hasattr(module, "q8"):
            kind = classify(name, _linear_shape(module))
            if kind is None:
                continue
            kind = "row" if kind == "row" else "column"
            blocks = 3 if (kind == "column"
                           and _FUSED_QKV_PAT.search(name)) else 1
            dim = module.out_features if kind == "column" \
                else module.in_features
            if dim % (blocks * n):
                if blocks == 3:
                    raise ValueError(
                        f"auto-TP: the fused q|k|v {name} has {dim} output "
                        f"features, which do not split into 3 x tp={n}")
                logger.info(f"auto-TP: {name} stays whole (tp={n} does not "
                            f"divide its {kind} dim {dim})")
                continue
            new = shard_linear(module, kind, group, blocks)
            if new is not module:
                _set_submodule(model, name, new)
        else:
            continue
        if report:
            logger.info(f"auto-TP: {name} -> {kind}")
    return model
