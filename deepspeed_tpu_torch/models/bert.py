"""BERT encoder family in PyTorch.

Counterpart of ``deepspeed_tpu/models/bert.py``: the same config, the same
parameter names (``qkv``/``out_proj``/``up_proj``/``down_proj``/``wte``,
which ``convert.bert_params_to_state_dict`` maps from the TPU tree), post-LN
encoder blocks with exact GELU, a pooler and token types, and the MLM head.
The flax ``nn.scan`` over the blocks becomes a layer loop over ``blocks``.

``attention_impl="sparse"`` routes every layer through the block-sparse
attention of ``ops/sparse_attention`` (the CUDA kernels on a CUDA tensor,
their plain versions on a CPU tensor), bidirectional, with the padded
``attention_mask`` as its key-padding mask: pad inputs to whole layout
blocks with ``SparseAttentionUtils.pad_to_block_size`` first. "xla" is the
masked einsum (mask -1e10, probabilities cast to ``dtype``). The large
projections, the LayerNorms and GELU stay torch ops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse_attention.sparse_self_attention import sparse_attention
from .gpt import _layer_norm, _linear, init_weights


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The TPU package's BertConfig, field for field. ``scan_layers`` has no
    effect here (the blocks are a ModuleList either way); ``hidden_dropout``
    applies only to a forward with ``deterministic=False``, as in the TPU
    model."""
    vocab_size: int = 30522
    max_seq_len: int = 512
    type_vocab_size: int = 2     # 0 = no token-type embedding (DistilBERT)
    use_pooler: bool = True      # False = raw [CLS] state (DistilBERT)
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    scan_layers: bool = True
    attention_impl: str = "xla"      # xla | sparse
    sparse_attention: Any = None     # SparsityConfig when attention_impl=sparse

    def __post_init__(self):
        if self.attention_impl not in ("xla", "sparse"):
            raise ValueError(f"unknown attention_impl "
                             f"{self.attention_impl!r}")
        if self.attention_impl == "sparse" and self.sparse_attention is None:
            raise ValueError("attention_impl='sparse' needs a "
                             "sparse_attention SparsityConfig")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


def bert_large(**kw) -> BertConfig:
    return BertConfig(num_layers=24, num_heads=16, d_model=1024,
                      d_ff=4096, **kw)


def _norm(cfg: BertConfig, device) -> nn.LayerNorm:
    return nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps,
                        dtype=cfg.param_dtype, device=device)


def _dense(cfg: BertConfig, n_in: int, n_out: int, device) -> nn.Linear:
    return nn.Linear(n_in, n_out, dtype=cfg.param_dtype, device=device)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = _dense(cfg, cfg.d_model, 3 * cfg.d_model, device)
        self.out_proj = _dense(cfg, cfg.d_model, cfg.d_model, device)

    def forward(self, x, attention_mask=None):
        """x [B, S, D]; ``attention_mask`` [B, S] bool (True = attend)."""
        cfg = self.cfg
        b, s, _ = x.shape
        qkv = _linear(x, self.qkv, cfg.dtype)
        q, k, v = (t.reshape(b, s, cfg.num_heads, cfg.head_dim)
                   for t in qkv.split(cfg.d_model, -1))
        scale = 1.0 / math.sqrt(cfg.head_dim)
        if cfg.attention_impl == "sparse":
            out = sparse_attention(q, k, v, cfg.sparse_attention,
                                   sm_scale=scale, causal=False,
                                   key_padding_mask=attention_mask)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
            if attention_mask is not None:
                logits = torch.where(attention_mask[:, None, None, :],
                                     logits, -1e10)
            probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return _linear(out.reshape(b, s, cfg.d_model), self.out_proj,
                       cfg.dtype)


class BertLayer(nn.Module):
    """Post-LN encoder block (original BERT): LN(x + attn(x)), then
    LN(x + ffn(x))."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn = BertSelfAttention(cfg, device=device)
        self.ln_attn = _norm(cfg, device)
        self.up_proj = _dense(cfg, cfg.d_model, cfg.d_ff, device)
        self.down_proj = _dense(cfg, cfg.d_ff, cfg.d_model, device)
        self.ln_ffn = _norm(cfg, device)

    def _dropout(self, x, deterministic: bool):
        p = self.cfg.hidden_dropout
        return x if not p or deterministic else F.dropout(x, p, True)

    def forward(self, x, attention_mask=None, deterministic: bool = True):
        dt = self.cfg.dtype
        a = self._dropout(self.attn(x, attention_mask), deterministic)
        x = _layer_norm(x + a, self.ln_attn, dt)
        h = F.gelu(_linear(x, self.up_proj, dt), approximate="none")
        h = self._dropout(_linear(h, self.down_proj, dt), deterministic)
        return _layer_norm(x + h, self.ln_ffn, dt)


class BertModel(nn.Module):
    """Encoder + pooler. ``forward(input_ids [B, S])`` ->
    (sequence_output [B, S, D], pooled_output [B, D])."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.d_model,
                                            **kw))
        if cfg.type_vocab_size:
            self.wtt = nn.Embedding(cfg.type_vocab_size, cfg.d_model, **kw)
        self.ln_emb = _norm(cfg, device)
        self.blocks = nn.ModuleList(BertLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        if cfg.use_pooler:
            self.pooler = _dense(cfg, cfg.d_model, cfg.d_model, device)
        self.init_weights()

    def init_weights(self, generator: Optional[torch.Generator] = None,
                     std: float = 0.02) -> None:
        """Random weights (``models.gpt.init_weights``)."""
        init_weights(self, generator, std)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                deterministic: bool = True):
        cfg = self.cfg
        dt = cfg.dtype
        s = input_ids.shape[1]
        x = F.embedding(input_ids, self.wte.weight.to(dt))
        x = x + self.wpe[None, :s].to(dt)
        if cfg.type_vocab_size:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + F.embedding(token_type_ids, self.wtt.weight.to(dt))
        x = _layer_norm(x, self.ln_emb, dt)
        if attention_mask is not None:
            attention_mask = torch.as_tensor(attention_mask,
                                             device=x.device).bool()
        for blk in self.blocks:
            x = blk(x, attention_mask, deterministic)
        if not cfg.use_pooler:
            return x, x[:, 0]
        return x, torch.tanh(_linear(x[:, 0], self.pooler, dt))


class BertForMaskedLM(nn.Module):
    """MLM head over the encoder; the decoder is stored untied, as in the
    TPU model. ``forward`` -> logits [B, S, V]."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg, device=device)
        self.transform = _dense(cfg, cfg.d_model, cfg.d_model, device)
        self.ln_head = _norm(cfg, device)
        self.decoder = _dense(cfg, cfg.d_model, cfg.vocab_size, device)
        self.init_weights()

    def init_weights(self, generator: Optional[torch.Generator] = None,
                     std: float = 0.02) -> None:
        """Random weights (``models.gpt.init_weights``)."""
        init_weights(self, generator, std)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                deterministic: bool = True):
        dt = self.cfg.dtype
        x, _ = self.bert(input_ids, token_type_ids, attention_mask,
                         deterministic)
        h = F.gelu(_linear(x, self.transform, dt), approximate="none")
        h = _layer_norm(h, self.ln_head, dt)
        return _linear(h, self.decoder, dt)
