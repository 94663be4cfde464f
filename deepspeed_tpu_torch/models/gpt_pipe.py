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
backward. ``PipeGPTBlock.num_params`` is the TPU package's
estimate (``12 d^2 + 2 d d_ff``, no biases), so ``parameters`` partitions
agree with it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..module_inject.layers import embedding
from ..runtime.pipe.module import LayerSpec, PipelineModule, TiedLayerSpec
from .gpt import (Block, GPTConfig, _layer_norm, _linear, head_logits,
                  init_weights, lm_loss_fn)


def _split_aux(x):
    """MoE pipelines carry ``(hidden, aux_loss)`` between layers so the
    load-balancing loss reaches the last stage."""
    if isinstance(x, tuple) and len(x) == 2:
        return x
    return x, None


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device)[None, :].expand(b, s)


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
        init_weights(self)

    def forward(self, x):
        cfg = self.cfg
        x, aux = _split_aux(x)
        if not x.is_floating_point():                 # the embedding end
            h = embedding(x, self.wte, cfg.dtype)
            h = h + self.wpe[:x.shape[1]][None].to(cfg.dtype)
            if cfg.moe:
                return h, torch.zeros((), dtype=torch.float32,
                                      device=h.device)
            return h
        logits = head_logits(cfg, self.wte.weight, x)  # the LM-head end
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
            x, _positions(x), attention_impl=self.cfg.attention_impl,
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
        logits = _linear(x, self.lm_head, self.cfg.dtype)
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
    ``(logits, aux)`` pair) against the shifted ``labels``."""
    return lm_loss_fn(logits, {"input_ids": labels})


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
