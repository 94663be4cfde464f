"""TPU-package GPT and BERT weights -> the port's ``state_dict``.

``jax_params_to_state_dict`` takes the flax ``params`` tree of
``deepspeed_tpu.models.gpt.GPT`` with every leaf already a numpy array (the
caller converts; this module imports no JAX) and returns a ``state_dict``
for ``deepspeed_tpu_torch.models.gpt.GPT`` with the same config:

  * ``blocks`` leaves stacked ``[L, ...]`` (``scan_layers=True``) are split
    per layer; ``block_{i}`` subtrees (``scan_layers=False``) map directly;
  * a Dense ``kernel [in, out]`` becomes ``Linear.weight [out, in]``; the
    fused ``qkv`` kernel keeps its q|k|v order along the output dim, which
    the port splits the same way;
  * LayerNorm ``scale`` becomes ``weight``; ``wte.embedding`` becomes
    ``wte.weight``; ``wpe`` stays; a tied head has no ``lm_head``.

``jax_params_to_state_dict`` serves every ``attention_impl`` ("sparse"
adds no parameter). ``bert_params_to_state_dict`` maps the trees of
``deepspeed_tpu.models.bert.BertModel`` and ``BertForMaskedLM`` the same
way onto ``deepspeed_tpu_torch.models.bert``.

Any tree with the params' structure maps the same way: a JAX gradient tree
(``jax.grad`` of the loss) or an Adam moment tree (``AdamState.mu`` /
``.nu``) becomes a name -> tensor dict that lines up with the port model's
``named_parameters()``; the training parity tests compare grads and moments
through it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .models.bert import BertConfig
from .models.gpt import GPTConfig


def _dense(prefix: str, tree: Mapping[str, Any], out: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = np.asarray(tree["kernel"]).T
    if "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _norm(prefix: str, tree: Mapping[str, Any], out: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = np.asarray(tree["scale"])
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _block(prefix: str, tree: Mapping[str, Any], out: Dict[str, Any]) -> None:
    _norm(f"{prefix}.ln_1", tree["ln_1"], out)
    _norm(f"{prefix}.ln_2", tree["ln_2"], out)
    _dense(f"{prefix}.attn.qkv", tree["attn"]["qkv"], out)
    _dense(f"{prefix}.attn.out_proj", tree["attn"]["out_proj"], out)
    _dense(f"{prefix}.mlp.up_proj", tree["mlp"]["up_proj"], out)
    _dense(f"{prefix}.mlp.down_proj", tree["mlp"]["down_proj"], out)


def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def jax_params_to_state_dict(params_np: Mapping[str, Any],
                             cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    out: Dict[str, Any] = {"wte.weight": np.asarray(
        params_np["wte"]["embedding"])}
    if not cfg.rotary:
        out["wpe"] = np.asarray(params_np["wpe"])
    for i in range(cfg.num_layers):
        if "blocks" in params_np:
            blk = _layer(params_np["blocks"], i)
        else:
            blk = params_np[f"block_{i}"]
        _block(f"blocks.{i}", blk, out)
    _norm("ln_f", params_np["ln_f"], out)
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = np.asarray(
            params_np["lm_head"]["kernel"]).T
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def _bert_layer(prefix: str, tree: Mapping[str, Any],
                out: Dict[str, Any]) -> None:
    _dense(f"{prefix}.attn.qkv", tree["attn"]["qkv"], out)
    _dense(f"{prefix}.attn.out_proj", tree["attn"]["out_proj"], out)
    _norm(f"{prefix}.ln_attn", tree["ln_attn"], out)
    _dense(f"{prefix}.up_proj", tree["up_proj"], out)
    _dense(f"{prefix}.down_proj", tree["down_proj"], out)
    _norm(f"{prefix}.ln_ffn", tree["ln_ffn"], out)


def _bert_encoder(prefix: str, tree: Mapping[str, Any], cfg: BertConfig,
                  out: Dict[str, Any]) -> None:
    out[f"{prefix}wte.weight"] = np.asarray(tree["wte"]["embedding"])
    out[f"{prefix}wpe"] = np.asarray(tree["wpe"])
    if cfg.type_vocab_size:
        out[f"{prefix}wtt.weight"] = np.asarray(tree["wtt"]["embedding"])
    _norm(f"{prefix}ln_emb", tree["ln_emb"], out)
    for i in range(cfg.num_layers):
        blk = (_layer(tree["blocks"], i) if "blocks" in tree
               else tree[f"block_{i}"])
        _bert_layer(f"{prefix}blocks.{i}", blk, out)
    if cfg.use_pooler:
        _dense(f"{prefix}pooler", tree["pooler"], out)


def bert_params_to_state_dict(params_np: Mapping[str, Any],
                              cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """A ``BertModel`` or ``BertForMaskedLM`` params tree (numpy leaves,
    ``blocks`` stacked or ``block_{i}``) -> the port model's state_dict."""
    out: Dict[str, Any] = {}
    if "bert" in params_np:                      # BertForMaskedLM
        _bert_encoder("bert.", params_np["bert"], cfg, out)
        _dense("transform", params_np["transform"], out)
        _norm("ln_head", params_np["ln_head"], out)
        _dense("decoder", params_np["decoder"], out)
    else:
        _bert_encoder("", params_np, cfg, out)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}
