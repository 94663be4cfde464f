"""A model factored into prefix / a trunk of identical blocks / suffix.

Counterpart of the interface half of ``deepspeed_tpu/runtime/pipe/spmd.py``
(``StackedPipeSpec``, its tree helpers, ``gpt_pipe_spec`` and
``bert_mlm_pipe_spec``). The TPU package drives it from two runtimes: the
SPMD pipeline (``GPipeSpmdEngine``, not ported yet: ROADMAP A9) and the
layer-streamed capacity tier (``runtime/zero/layer_stream.py``), which the
port has.

The TPU trunk is one stacked ``[L, ...]`` leaf per block parameter; here the
blocks are an ``nn.ModuleList`` and the parameters are flat dicts keyed by
the model's own ``named_parameters`` names, so "layer i" is the set of names
under ``f"{blocks_key}.{i}."``. A block runs through
``torch.func.functional_call`` on a template block (any block of the model,
its own storage unused, on the meta device or not) with the layer's
tensors, so one layer's parameters can be fetched into any device buffer and
differentiated there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
from torch.func import functional_call

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StackedPipeSpec:
    """A model, factored into prefix / identical blocks / suffix.

    prefix(resident, batch) -> (x, aux)   embedding and preamble. ``x`` is
                                          the trunk carry [B, T, D]; ``aux``
                                          the per-block side input (GPT:
                                          positions; BERT: the attention
                                          mask or None). It must not depend
                                          on the parameters: the streamed
                                          backward differentiates the prefix
                                          only through ``x``, so the
                                          streamer detaches it.
    block(block_params, x, aux) -> x      one layer, given that layer's
                                          tensors by their names inside a
                                          block ("attn.qkv.weight", ...)
    suffix_loss(resident, x, batch)       final norm, head and loss
    blocks_key                            the blocks' name prefix
                                          ("blocks", "bert.blocks")
    num_layers                            L
    dtype                                 the trunk's compute dtype (the
                                          carry keeps one dtype)

    ``resident`` is the dict of every parameter outside the blocks, by its
    full name.
    """
    prefix: Callable[[Params, Dict], Any]
    block: Callable[[Params, torch.Tensor, Any], torch.Tensor]
    suffix_loss: Callable[[Params, torch.Tensor, Dict], torch.Tensor]
    blocks_key: str
    num_layers: int
    dtype: Any = None


def tree_get(params: Params, path: str) -> Params:
    """The entries under ``path`` (a dotted name prefix), by their names
    below it."""
    pre = path + "."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def tree_without(params: Params, path: str) -> Params:
    """``params`` without the entries under ``path``."""
    pre = path + "."
    return {k: v for k, v in params.items() if not k.startswith(pre)}


def tree_with(params: Params, path: str, value: Params) -> Params:
    """``params`` with the entries under ``path`` replaced by ``value``'s
    (named below ``path``)."""
    out = tree_without(params, path)
    out.update({f"{path}.{k}": v for k, v in value.items()})
    return out


def layer_of(name: str, blocks_key: str):
    """(layer index, name inside the block) of a block parameter's full
    name, or None for a parameter outside the blocks."""
    pre = blocks_key + "."
    if not name.startswith(pre):
        return None
    idx, _, rest = name[len(pre):].partition(".")
    return int(idx), rest


def gpt_pipe_spec(model, loss_fn=None) -> StackedPipeSpec:
    """``models/gpt.py``'s GPT as a stacked trunk. The prefix, block and
    suffix are the functions ``GPT.forward`` itself runs
    (``embed_tokens``, ``Block``, ``final_logits``), so a streamed step
    computes what the module computes. Refuses what the TPU adapter refuses
    (``partition_activations``, ``sequence_parallel``, dropout, MoE)."""
    from ...models.gpt import embed_tokens, final_logits, lm_loss_fn
    cfg = model.cfg
    if cfg.partition_activations or cfg.sequence_parallel:
        raise ValueError("tp/sp sharding constraints inside the stacked "
                         "trunk are not supported; disable "
                         "partition_activations/sequence_parallel")
    if cfg.dropout:
        raise ValueError("the stacked trunk runs deterministic; train with "
                         "dropout=0.0 (silently disabling dropout would "
                         "change training semantics)")
    if cfg.moe:
        raise ValueError("MoE blocks return a load-balancing aux loss the "
                         "stacked trunk does not carry; a streamed step "
                         "that dropped it would collapse the router")
    loss_fn = loss_fn or lm_loss_fn
    template = model.blocks[0]

    def prefix(res, batch):
        ids = batch["input_ids"]
        b, s = ids.shape
        positions = torch.arange(s, device=ids.device)[None, :].expand(b, s)
        return embed_tokens(cfg, res["wte.weight"], res.get("wpe"), ids,
                            positions), positions

    def block(p, x, positions):
        return functional_call(template, p, (x, positions),
                               {"attention_impl": cfg.attention_impl})[0]

    def suffix_loss(res, x, batch):
        head = res["wte.weight" if cfg.tie_embeddings else "lm_head.weight"]
        return loss_fn(final_logits(cfg, x, res["ln_f.weight"],
                                    res["ln_f.bias"], head), batch)

    return StackedPipeSpec(prefix=prefix, block=block,
                           suffix_loss=suffix_loss, blocks_key="blocks",
                           num_layers=cfg.num_layers, dtype=cfg.dtype)


def bert_mlm_pipe_spec(model, loss_fn) -> StackedPipeSpec:
    """``models/bert.py``'s BertForMaskedLM as a stacked trunk: the
    embeddings prefix, the ``bert.blocks`` trunk with the attention mask
    (or None) as its side input, the MLM head. Refuses hidden dropout, as
    the TPU adapter does."""
    from ...models.bert import bert_embed, mlm_head
    cfg = model.cfg
    if cfg.hidden_dropout:
        raise ValueError("the stacked trunk runs deterministic; set "
                         "hidden_dropout=0.0 (silently disabling dropout "
                         "would change training semantics)")
    template = model.bert.blocks[0]

    def prefix(res, batch):
        mask = batch.get("attention_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=batch["input_ids"].device
                                   ).bool()
        return bert_embed(cfg, tree_get(res, "bert"), batch["input_ids"],
                          batch.get("token_type_ids")), mask

    def block(p, x, mask):
        return functional_call(template, p, (x, mask, True))

    def suffix_loss(res, x, batch):
        return loss_fn(mlm_head(cfg, res, x), batch)

    return StackedPipeSpec(prefix=prefix, block=block,
                           suffix_loss=suffix_loss, blocks_key="bert.blocks",
                           num_layers=cfg.num_layers, dtype=cfg.dtype)
