"""MoE parameter utilities over the port's ``state_dict`` names.

Counterpart of ``deepspeed_tpu/moe/utils.py`` (reference
``deepspeed/moe/utils.py``: ``is_moe_param``:18,
``split_params_into_different_moe_groups_for_optimizer``:62). As in the
TPU package, MoE-ness is a property of the parameter's name: the expert
bank's stacked parameters live under an ``experts`` segment
(``blocks.3.moe.deepspeed_moe.experts.up_proj.weight``); the gate's ``wg``,
a residual MoE's ``mlp`` and ``coefficient`` are shared parameters. Names
may be ``.``- or ``/``-separated (the TPU package's flax paths).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple, Union

import torch
from torch import nn

_SEP = re.compile(r"[./]")


def is_moe_param_path(path: str) -> bool:
    return "experts" in _SEP.split(path)


def is_moe_param(path) -> bool:
    """``path``: a parameter name, or a ``(name, tensor)`` pair as
    ``named_parameters()`` yields it."""
    if not isinstance(path, str):
        path = path[0]
    return is_moe_param_path(path)


def _named(params: Union[nn.Module, Mapping[str, torch.Tensor]]):
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    return list(params.items())


def moe_param_mask(params) -> Dict[str, bool]:
    """Name -> True for expert parameters, over a module or a state dict
    (a mask keyed as the optimizer's leaves are)."""
    return {n: is_moe_param(n) for n, _ in _named(params)}


def split_params_into_shared_and_expert(params
                                        ) -> Tuple[Dict[str, torch.Tensor],
                                                   Dict[str, torch.Tensor]]:
    """Two ``{name: tensor}`` dicts: the shared parameters and the expert
    parameters, in order."""
    shared, expert = {}, {}
    for n, p in _named(params):
        (expert if is_moe_param(n) else shared)[n] = p
    return shared, expert


def count_moe_params(params) -> Tuple[int, int]:
    """(shared_count, expert_count) elements."""
    shared, expert = split_params_into_shared_and_expert(params)
    return (sum(p.numel() for p in shared.values()),
            sum(p.numel() for p in expert.values()))
