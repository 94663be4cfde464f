"""DeepSpeedTransformerLayer / DeepSpeedTransformerConfig: the user-facing
fused transformer layer.

Counterpart of ``deepspeed_tpu/ops/transformer/transformer.py`` (reference
``deepspeed/ops/transformer/transformer.py:39,460``): the same config
surface and the same BERT-style block. The TPU package leaves the fusion to
XLA; eager PyTorch fuses nothing, so here the layer's LayerNorms run the B6
kernels (:func:`..cuda.layer_norm.layer_norm`), the masked attention's
softmax runs B8 (:func:`..cuda.softmax.fused_softmax`) on the f32 logits,
and attention without a mask or attention dropout runs the flash kernels
(B1, B1b). The GELU is the exact erf GELU (``F.gelu``), as in the TPU layer,
so the tanh-GELU kernel B7 is not on this path. The memory and rounding
toggles map as in the TPU package:

  normalize_invertible / gelu_checkpoint / attn_dropout_checkpoint
      -> any of them checkpoints the layer body
         (``torch.utils.checkpoint``, non-reentrant): recompute instead of
         store
  stochastic_mode
      -> the body runs in f32 and the output's cast to bf16 rounds
         stochastically in training (``ops/quantizer.stochastic_round_bf16``)
  fp16 -> compute dtype float16 (the default is bfloat16)

Dropout masks and stochastic-rounding bits come from the ``generator``
argument of :meth:`DeepSpeedTransformerLayer.forward` (the default
generator when None). The dropout masks are drawn before the checkpointed
body and passed into it, so a recomputed body applies the same masks
(``torch.utils.checkpoint`` replays the default RNG state, not an explicit
generator's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..cuda.flash_attention import flash_attention
from ..cuda.layer_norm import layer_norm
from ..cuda.softmax import fused_softmax
from ..quantizer import stochastic_round_bf16

_MASKED_LOGIT = -1e10        # the TPU layer's key-padding fill (:166-170)


@dataclasses.dataclass
class DeepSpeedTransformerConfig:
    """Reference-keyed layer config (transformer.py:39). ``batch_size``,
    ``local_rank`` and ``seed`` exist for signature parity and carry no
    behavior: shapes come from the inputs and random draws from the
    forward's generator."""
    batch_size: int = -1
    hidden_size: int = -1
    intermediate_size: int = -1
    heads: int = -1
    attn_dropout_ratio: float = 0.0
    hidden_dropout_ratio: float = 0.0
    num_hidden_layers: int = -1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    local_rank: int = -1
    seed: int = -1
    fp16: bool = False
    bf16: bool = True
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    return_tuple: bool = False
    training: bool = True

    def __post_init__(self):
        if self.hidden_size <= 0 or self.heads <= 0:
            raise ValueError("hidden_size and heads are required")
        if self.intermediate_size <= 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by heads "
                f"{self.heads}")
        if self.fp16 and self.bf16:
            self.bf16 = False      # explicit fp16 wins over the default
        if self.stochastic_mode and not self.bf16:
            raise ValueError(
                "stochastic_mode is implemented as an fp32 body with a "
                "stochastically-rounded bf16 output write; with "
                f"{'fp16' if self.fp16 else 'fp32'} compute it would "
                "silently not apply — use bf16 or drop the flag")

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.fp16:
            return torch.float16
        return torch.bfloat16 if self.bf16 else torch.float32

    @property
    def remat(self) -> bool:
        return (self.normalize_invertible or self.gelu_checkpoint
                or self.attn_dropout_checkpoint)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim through the B6 kernels. Its f32
    parameters stay f32 under a bf16 or fp16 body (the kernels read f32
    gamma and beta), as flax keeps them."""

    def __init__(self, hidden: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden, device=device))
        self.bias = nn.Parameter(torch.zeros(hidden, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if w.dtype not in (torch.float32, x.dtype):
            w, b = w.to(x.dtype), b.to(x.dtype)
        return layer_norm(x, w, b, self.eps)


class _StraightThrough(torch.autograd.Function):
    """The stochastically rounded output in the forward; the gradient
    passes through unchanged, as through a deterministic cast."""

    @staticmethod
    def forward(ctx, x, rounded):
        ctx.dtype = x.dtype
        return rounded

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


class DeepSpeedTransformerLayer(nn.Module):
    """BERT-style transformer layer (reference transformer.py:460):
    self-attention + FFN with Pre-LN or Post-LN residuals, dropout on
    attention probs and both residual branches.

    ``forward(hidden_states [B, S, H], attention_mask [B, S] optional,
    deterministic=None, generator=None)`` -> [B, S, H] (or a 1-tuple when
    ``return_tuple``). ``deterministic`` defaults to ``not
    config.training``. Parameters are f32, in the TPU layer's tree order:
    ``attn_ln``, ``attn_qkv``, ``attn_out``, ``inter``, ``output``,
    ``out_ln`` (``convert.transformer_layer_params_to_state_dict`` maps the
    flax tree onto them)."""

    def __init__(self, config: DeepSpeedTransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        h, inter = cfg.hidden_size, cfg.intermediate_size
        self.attn_ln = LayerNorm(h, cfg.layer_norm_eps, device)
        self.attn_qkv = nn.Linear(h, 3 * h, device=device)
        self.attn_out = nn.Linear(h, h, device=device)
        self.inter = nn.Linear(h, inter, device=device)
        self.output = nn.Linear(inter, h, device=device)
        self.out_ln = LayerNorm(h, cfg.layer_norm_eps, device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Normal(initializer_range) kernels, the two residual-output
        projections at initializer_range / sqrt(2 * num_hidden_layers)
        under ``adjust_init_range`` (the reference's rule); zero biases,
        unit LayerNorm scales."""
        cfg = self.config
        out_std = cfg.initializer_range
        if cfg.adjust_init_range and cfg.num_hidden_layers > 0:
            out_std /= math.sqrt(2.0 * cfg.num_hidden_layers)
        for lin, std in ((self.attn_qkv, cfg.initializer_range),
                         (self.attn_out, out_std),
                         (self.inter, cfg.initializer_range),
                         (self.output, out_std)):
            lin.weight.normal_(0.0, std, generator=generator)
            lin.bias.zero_()
        for ln in (self.attn_ln, self.out_ln):
            ln.weight.fill_(1.0)
            ln.bias.zero_()

    def _dropout_masks(self, x, deterministic, generator):
        """Keep masks (bool) of the attention probs and the two residual
        branches, drawn before the body; None where no dropout applies."""
        cfg = self.config
        b, s, h = x.shape

        def keep(rate, shape):
            if not rate or deterministic:
                return None
            u = torch.rand(shape, generator=generator, device=x.device)
            return u < 1.0 - rate
        return (keep(cfg.attn_dropout_ratio, (b, cfg.heads, s, s)),
                keep(cfg.hidden_dropout_ratio, (b, s, h)),
                keep(cfg.hidden_dropout_ratio, (b, s, h)))

    @staticmethod
    def _linear(x, lin: nn.Linear):
        return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))

    def _body(self, x, attention_mask, dt, keep_attn, keep_attn_out,
              keep_ff):
        cfg = self.config
        h, heads = cfg.hidden_size, cfg.heads
        hd = h // heads

        def dropout(t, keep, rate):
            if keep is None:
                return t
            return torch.where(keep, t / (1.0 - rate), 0.0)

        x = x.to(dt)
        b, s, _ = x.shape
        a_in = self.attn_ln(x) if cfg.pre_layer_norm else x
        q, k, v = (t.view(b, s, heads, hd)
                   for t in self._linear(a_in, self.attn_qkv).split(h, -1))
        if attention_mask is None and keep_attn is None:
            # hot path: the flash kernels (key-padding masks and
            # attention-prob dropout need the materialized probs)
            ctx = flash_attention(q, k, v, causal=False,
                                  sm_scale=1.0 / math.sqrt(hd))
            ctx = ctx.to(dt).reshape(b, s, h)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k
                                  ).float() / math.sqrt(hd)
            if attention_mask is not None:
                logits = torch.where(
                    attention_mask.bool()[:, None, None, :], logits,
                    _MASKED_LOGIT)
            probs = fused_softmax(logits).to(dt)
            probs = dropout(probs, keep_attn, cfg.attn_dropout_ratio)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h)
        attn_out = dropout(self._linear(ctx, self.attn_out), keep_attn_out,
                           cfg.hidden_dropout_ratio)
        x = x + attn_out
        if not cfg.pre_layer_norm:
            x = self.attn_ln(x)
        f_in = self.out_ln(x) if cfg.pre_layer_norm else x
        ff = F.gelu(self._linear(f_in, self.inter), approximate="none")
        ff = dropout(self._linear(ff, self.output), keep_ff,
                     cfg.hidden_dropout_ratio)
        x = x + ff
        if not cfg.pre_layer_norm:
            x = self.out_ln(x)
        return x

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        if deterministic is None:
            deterministic = not cfg.training
        if attention_mask is not None and attention_mask.dim() != 2:
            raise ValueError(
                f"attention_mask must be a [batch, seq] binary key-padding "
                f"mask (1 = attend); got rank {attention_mask.dim()}. "
                f"BERT-style extended additive masks ([B,1,1,S] with "
                f"0/-10000) are a framework-internal encoding — pass the "
                f"original binary mask instead")
        dt = cfg.compute_dtype
        sr_active = cfg.stochastic_mode and dt == torch.bfloat16
        if sr_active:
            # the reference's stochastic mode rounds f32 accumulations
            # into the low-precision output write, so the body runs f32
            # and only the final cast narrows
            dt = torch.float32
        masks = self._dropout_masks(hidden_states, deterministic, generator)
        if cfg.remat:
            out = checkpoint(self._body, hidden_states, attention_mask, dt,
                             *masks, use_reentrant=False)
        else:
            out = self._body(hidden_states, attention_mask, dt, *masks)
        if sr_active:
            if deterministic:
                out = out.to(torch.bfloat16)
            else:
                out = _StraightThrough.apply(
                    out, stochastic_round_bf16(out, generator))
        return (out,) if cfg.return_tuple else out
