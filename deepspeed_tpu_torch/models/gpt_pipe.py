"""GPT as a pipeline layer list.

Counterpart of ``deepspeed_tpu/models/gpt_pipe.py`` (reference analogue:
GPT2ModelPipe in the Megatron-DeepSpeed examples, built from
``LayerSpec`` / ``TiedLayerSpec``, ``runtime/pipe/module.py:25,73``), over
this package's ``models/gpt.py``.

The embedding and the LM head are a tied pair: both are ``PipeGPTEmbed``
under one ``TiedLayerSpec`` key, each stage that owns one holds its own
replica and the pipeline engine sums their grads (``ReduceTiedGrads``).
``PipeGPTEmbed`` embeds integer token ids and projects float hidden states
through the transposed table, so the same module serves both ends.

An MoE configuration carries the pair ``(hidden, aux)`` between layers: each
block adds its gate's load-balancing loss to ``aux`` and the head returns
``(logits, moe_aux_loss_coef * aux)``, which ``lm_loss_fn`` adds to the
loss. Each layer draws its weights as ``models.gpt.init_weights`` does
(matrices and tables N(0, 0.02), biases 0, LayerNorm scales 1). A block
has no remat of its own: the pipeline engine replays a whole stage in its
backward. ``PipeGPTBlock.num_params`` is the TPU package's estimate (``12
d^2 + 2 d d_ff``, no biases), so ``parameters`` partitions agree with it.

Inside a stage the pipeline engine may split the layers over a tp group (the
dense GPT's ``tp_spec`` rules, ``module_inject.layers.shard_by_tp_spec``:
the tied table by vocab rows, whose logits ``vocab_logits`` gathers) or the
sequence over an sp group (:func:`set_pipe_sequence_parallel`: the
embedding takes its rank's positions, a block's attention exchanges over
the group, as the dense GPT's do).
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn

from ..module_inject.layers import embedding
from ..runtime.pipe.module import LayerSpec, PipelineModule, TiedLayerSpec
from .gpt import (Block, GPTConfig, _layer_norm, _sp_size, init_weights,
                  lm_loss_fn, vocab_logits)


def _split_aux(x):
    """MoE pipelines carry ``(hidden, aux_loss)`` between layers so the
    load-balancing loss reaches the last stage."""
    if isinstance(x, tuple) and len(x) == 2:
        return x
    return x, None


def _start(x: torch.Tensor, group) -> int:
    """The first position of ``x``'s columns: 0, or over an sp group the
    rank's chunk of the sequence, ``r * s``."""
    return group.rank * x.shape[1] if _sp_size(group) > 1 else 0


def _positions(x: torch.Tensor, group=None) -> torch.Tensor:
    b, s = x.shape[:2]
    start = _start(x, group)
    return torch.arange(start, start + s, device=x.device)[None, :] \
        .expand(b, s)


class PipeGPTEmbed(nn.Module):
    """Token + position embedding (integer input) / tied LM head (float
    input)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.d_model,
                                            **kw))
        self.sp_group = None
        init_weights(self)

    def forward(self, x):
        cfg = self.cfg
        x, aux = _split_aux(x)
        if not x.is_floating_point():                 # the embedding end
            h = embedding(x, self.wte, cfg.dtype)
            start = _start(x, self.sp_group)
            h = h + self.wpe[start:start + x.shape[1]][None].to(cfg.dtype)
            if cfg.moe:
                return h, torch.zeros((), dtype=torch.float32,
                                      device=h.device)
            return h
        logits = vocab_logits(cfg, self.wte, x)        # the LM-head end
        if aux is not None:
            return logits, cfg.moe_aux_loss_coef * aux
        return logits

    @staticmethod
    def num_params(cfg: GPTConfig) -> int:
        return cfg.vocab_size * cfg.d_model + cfg.max_seq_len * cfg.d_model


class PipeGPTBlock(Block):
    """One transformer block (``models.gpt.Block``, the same parameters),
    attention through ``cfg.attention_impl``. x -> x for dense configs; for
    MoE configs the activation is the ``(hidden, aux)`` pair and the block
    adds its gate's l_aux to the carried aux."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__(cfg, device=device)
        init_weights(self)

    def forward(self, x, deterministic: bool = True):
        x, aux = _split_aux(x)
        out, _, _, l_aux = super().forward(
            x, _positions(x, self.attn.sp_group),
            attention_impl=self.cfg.attention_impl,
            deterministic=deterministic)
        if self.cfg.moe:
            return out, (l_aux if aux is None else aux + l_aux)
        return (out, aux) if aux is not None else out

    @staticmethod
    def num_params(cfg: GPTConfig) -> int:
        n = 12 * cfg.d_model ** 2
        if cfg.moe:
            experts = cfg.num_experts * 2 * cfg.d_model * cfg.d_ff
            if cfg.moe_use_residual:
                experts += 2 * cfg.d_model * cfg.d_ff
            return n + experts + cfg.d_model * cfg.num_experts
        return n + 2 * cfg.d_model * cfg.d_ff


class PipeGPTFinalNorm(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps,
                                 dtype=cfg.param_dtype, device=device)
        init_weights(self)

    def forward(self, x):
        x, aux = _split_aux(x)
        out = _layer_norm(x, self.ln_f, self.cfg.dtype)
        return (out, aux) if aux is not None else out

    @staticmethod
    def num_params(cfg: GPTConfig) -> int:
        return 2 * cfg.d_model


class PipeGPTLMHead(nn.Module):
    """Untied vocabulary projection (NeoX-style tie_embeddings=False)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False,
                                 dtype=cfg.param_dtype, device=device)
        init_weights(self)

    def forward(self, x):
        x, aux = _split_aux(x)
        logits = vocab_logits(self.cfg, self.lm_head, x)
        if aux is not None:
            return logits, self.cfg.moe_aux_loss_coef * aux
        return logits

    @staticmethod
    def num_params(cfg: GPTConfig) -> int:
        return cfg.vocab_size * cfg.d_model


def gpt_pipe_specs(cfg: GPTConfig):
    """LayerSpec list for a GPT; the embedding/LM-head pair is tied (one
    key) when cfg.tie_embeddings, else an untied head."""
    specs = [TiedLayerSpec("embed", PipeGPTEmbed, cfg)
             if cfg.tie_embeddings else LayerSpec(PipeGPTEmbed, cfg)]
    specs += [LayerSpec(PipeGPTBlock, cfg) for _ in range(cfg.num_layers)]
    specs += [LayerSpec(PipeGPTFinalNorm, cfg)]
    specs += [TiedLayerSpec("embed", PipeGPTEmbed, cfg)
              if cfg.tie_embeddings else LayerSpec(PipeGPTLMHead, cfg)]
    return specs


def pipe_lm_loss(logits, labels):
    """The pipeline's loss: next-token cross entropy of ``logits`` (or the
    ``(logits, aux)`` pair) against the shifted ``labels``; or, over an sp
    group, against the batch dict the engine hands the last stage (this
    rank's columns of ``labels``, the next tokens and a ``loss_mask``:
    ``lm_loss_fn`` takes its token mean)."""
    return lm_loss_fn(logits, labels if isinstance(labels, Mapping)
                      else {"input_ids": labels})


def set_pipe_sequence_parallel(layer: nn.Module, group) -> nn.Module:
    """Split ``layer``'s sequence over the sp ``group`` (the pipeline
    counterpart of ``models.gpt.set_sequence_parallel``): the embedding
    takes its rank's positions and a block's attention spans the whole
    sequence over ``group``; the other layers act position by position.
    A GPT layer needs ``cfg.sequence_parallel``. Returns ``layer``."""
    if _sp_size(group) == 1:
        return layer
    cfg = getattr(layer, "cfg", None)
    if isinstance(cfg, GPTConfig) and not cfg.sequence_parallel:
        raise ValueError(
            f"mesh sp={group.size} needs a GPTConfig with "
            f"sequence_parallel=True (and cp_impl 'ulysses' or 'ring')")
    if isinstance(layer, PipeGPTEmbed):
        layer.sp_group = group
    if isinstance(layer, Block):
        layer.attn.sp_group = group
    return layer


def gpt_pipe_module(cfg: GPTConfig, num_stages: int,
                    partition_method: str = "parameters",
                    loss_fn=None) -> PipelineModule:
    return PipelineModule(gpt_pipe_specs(cfg), num_stages=num_stages,
                          loss_fn=loss_fn or pipe_lm_loss,
                          partition_method=partition_method)


def gpt_pipe_state_dict(gpt_state: dict, cfg: GPTConfig) -> dict:
    """A ``models.gpt.GPT`` state dict -> the pipeline state dict of
    ``gpt_pipe_specs(cfg)``'s layers (``"{layer}.{name}"``; both tied
    replicas), so a pipeline and a dense GPT start from one model. A rotary
    GPT has no ``wpe``: the pipe embed's is then zeros (unused weights
    would differ)."""
    L = cfg.num_layers
    out = {"0.wte.weight": gpt_state["wte.weight"],
           "0.wpe": gpt_state.get(
               "wpe", torch.zeros(cfg.max_seq_len, cfg.d_model))}
    for k, v in gpt_state.items():
        if k.startswith("blocks."):
            i, _, rest = k[len("blocks."):].partition(".")
            out[f"{int(i) + 1}.{rest}"] = v
    out[f"{L + 1}.ln_f.weight"] = gpt_state["ln_f.weight"]
    out[f"{L + 1}.ln_f.bias"] = gpt_state["ln_f.bias"]
    if cfg.tie_embeddings:
        out[f"{L + 2}.wte.weight"] = out["0.wte.weight"]
        out[f"{L + 2}.wpe"] = out["0.wpe"]
    else:
        out[f"{L + 2}.lm_head.weight"] = gpt_state["lm_head.weight"]
    return out
