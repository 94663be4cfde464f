"""State-dict loaders with model-parallel resharding: load a checkpoint
written at one mp degree at another.

Counterpart of ``deepspeed_tpu/checkpoint/state_dict_factory.py``
(reference ``runtime/state_dict_factory.py``: ``SDLoaderFactory``,
``MegatronSDLoader``). Per-mp-rank shard files of a foreign (Megatron,
torch) checkpoint are merged (N -> 1) or split (1 -> N) by category: a
fused QKV interleaves per rank, column-parallel weights concatenate or split
on the output axis, row-parallel weights on the input axis, everything
else (row-parallel biases included: they are added once, after the
reduction) is replicated. The result feeds the injection policies
(``module_inject/policies.py``). Tensors stay torch tensors on the CPU.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..utils.logging import logger

# category patterns over foreign (torch / Megatron / HF) key names
QKV_PAT = re.compile(r"(query_key_value|qkv|c_attn)\.(weight|bias)$")
COLUMN_PAT = re.compile(
    r"(dense_h_to_4h|fc_in|up_proj|gate_proj|intermediate\.dense|"
    r"lm_head|word_embeddings|wte|embed_tokens)\.(weight|bias)$")
ROW_PAT = re.compile(
    r"(dense_4h_to_h|fc_out|down_proj|attention\.dense|out_proj|"
    r"output\.dense|c_proj)\.weight$")


def _t(x) -> torch.Tensor:
    """A tensor or an array -> a tensor (a numpy array shares its memory)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.asarray(x))


def _split(t: torch.Tensor, n: int, dim: int) -> List[torch.Tensor]:
    """``n`` equal parts along ``dim``; raises unless n divides it, as
    ``np.split`` does."""
    if t.shape[dim] % n:
        raise ValueError(f"cannot split {tuple(t.shape)} into {n} equal "
                         f"parts along dim {dim}")
    return list(t.tensor_split(n, dim))


def classify(key: str) -> str:
    """-> "qkv" | "column" | "row" | "replicate". Row-parallel biases
    replicate, which the row pattern encodes by matching ``.weight``
    only."""
    if QKV_PAT.search(key):
        return "qkv"
    if COLUMN_PAT.search(key):
        return "column"
    if ROW_PAT.search(key):
        return "row"
    return "replicate"


def merge_qkv(params: Sequence[Any], ckpt_ver: float = 2.0) -> torch.Tensor:
    """Merge per-rank fused-QKV shards. Version 0 stores each rank's
    [3 np hn, h] as q | k | v blocks of its heads: merging regroups all q,
    then all k, then all v. Versions 1.0 / 2.0 interleave per head, so the
    shards concatenate."""
    params = [_t(p) for p in params]
    if ckpt_ver == 0:
        thirds = [_split(p, 3, 0) for p in params]
        return torch.cat([torch.cat([t[i] for t in thirds], 0)
                          for i in range(3)], 0)
    return torch.cat(params, 0)


def split_qkv(param, num_to_split: int, offset: int,
              ckpt_ver: float = 2.0) -> torch.Tensor:
    """Rank ``offset``'s shard of a fused QKV (inverse of
    :func:`merge_qkv`)."""
    param = _t(param)
    if ckpt_ver == 0:
        return torch.cat([_split(t, num_to_split, 0)[offset]
                          for t in _split(param, 3, 0)], 0)
    return _split(param, num_to_split, 0)[offset]


def merge_state_dicts(state_dicts: Sequence[Dict[str, Any]],
                      ckpt_ver: float = 2.0) -> Dict[str, torch.Tensor]:
    """N per-mp-rank state dicts -> one whole state dict."""
    out: Dict[str, torch.Tensor] = {}
    for key in state_dicts[0]:
        parts = [_t(sd[key]) for sd in state_dicts]
        kind = classify(key)
        if kind == "qkv":
            out[key] = merge_qkv(parts, ckpt_ver)
        elif kind == "column":
            out[key] = torch.cat(parts, 0)
        elif kind == "row":
            out[key] = torch.cat(parts, 1)
        else:
            out[key] = parts[0]
    return out


def split_state_dict(state_dict: Dict[str, Any], mp_world: int, rank: int,
                     ckpt_ver: float = 2.0) -> Dict[str, torch.Tensor]:
    """One whole state dict -> ``rank``'s shard at mp degree
    ``mp_world``."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        kind = classify(key)
        v = _t(value)
        if kind == "qkv":
            out[key] = split_qkv(v, mp_world, rank, ckpt_ver)
        elif kind == "column":
            out[key] = _split(v, mp_world, 0)[rank]
        elif kind == "row":
            out[key] = _split(v, mp_world, 1)[rank]
        else:
            out[key] = v
    return out


class SDLoaderFactory:
    """Resolve a checkpoint list to a loader that produces the state dict
    at the requested mp degree."""

    @staticmethod
    def get_sd_loader(ckpt_list: List[str], version: float = 2.0):
        return MegatronSDLoader(ckpt_list, version)


class MegatronSDLoader:
    """Per-mp-rank shard files (``torch.save``d state dicts, bare or under
    ``"model"``), read with ``torch.load(map_location="cpu")``."""

    def __init__(self, ckpt_list: List[str], version: float = 2.0):
        self.ckpt_list = list(ckpt_list)
        self.version = version

    def _load_all(self):
        return [torch.load(p, map_location="cpu") for p in self.ckpt_list]

    def load(self, mp_world_size: int, mp_rank: int
             ) -> Dict[str, torch.Tensor]:
        """``mp_rank``'s state dict at degree ``mp_world_size``, merging or
        splitting the source shards as needed."""
        sds = [sd.get("model", sd) if isinstance(sd, dict) else sd
               for sd in self._load_all()]
        src = len(sds)
        if src == mp_world_size:
            return {k: _t(v) for k, v in sds[mp_rank].items()}
        full = merge_state_dicts(sds, self.version)
        if mp_world_size == 1:
            return full
        logger.info(f"resharding checkpoint: mp {src} -> {mp_world_size}")
        return split_state_dict(full, mp_world_size, mp_rank, self.version)
