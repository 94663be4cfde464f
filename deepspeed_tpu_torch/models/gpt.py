"""GPT model family (GPT-2 / GPT-NeoX style) in PyTorch.

Counterpart of ``deepspeed_tpu/models/gpt.py`` for serving. The flax
``nn.scan`` over stacked ``[L, ...]`` block params becomes a layer loop over
``blocks`` (``convert.py`` unstacks the TPU tree). Two forward modes:

  * :meth:`GPT.prefill` -- cacheless causal forward over a prompt batch;
    returns the final hidden states and every layer's K/V, which the serving
    engine moves into its arena;
  * :meth:`GPT.decode` -- ``s`` new tokens per row against a per-slot KV
    arena ``[L, B, S, h*d]`` (stored flat, as the TPU kernel path stores it)
    with a per-row write cursor. A write at ``>= max_seq_len`` is dropped:
    the serving engine pins retired lanes there (the masked-lane sentinel).

Decode attention routes through ``ops/cuda/decode_attention.py`` when
``decode_impl == "auto"`` (the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor) and through the masked einsum otherwise. Unlike the
TPU model, "auto" never gives way to the einsum: on the card a shape the
kernel does not take (head dim, cache dtype, query width) raises. The large
projections stay ``F.linear``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.decode_attention import (decode_attention,
                                         masked_cache_attention)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The TPU package's GPTConfig, field for field. Fields of features that
    later slices port (MoE, sparse attention, sequence parallelism, local
    windows, the int8 cache, the tp overlap) must stay at their defaults;
    the training-only knobs (dropout, scan, remat, activation partitioning,
    cpu checkpointing) are accepted and have no effect on serving."""
    vocab_size: int = 50304
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    rotary: bool = False             # False: learned positions (GPT-2)
    rotary_pct: float = 1.0
    parallel_residual: bool = False  # True for NeoX
    tp_overlap: bool = False
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16      # compute dtype
    param_dtype: Any = torch.float32
    dropout: float = 0.0
    scan_layers: bool = True
    scan_unroll: int = 1
    remat: bool = True
    remat_policy: str = "dots_no_batch"
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    attention_impl: str = "auto"     # auto | xla (both: the masked einsum)
    sparse_attention: Any = None
    # "auto": the decode kernel wrapper (CUDA kernel on the card, its plain
    # version on the CPU); "einsum": the masked einsum (the TPU "xla" path)
    decode_impl: str = "einsum"      # auto | einsum
    kv_cache_dtype: str = "auto"
    sequence_parallel: bool = False
    cp_impl: str = "ulysses"
    layer_norm_eps: float = 1e-5
    qk_scale: Any = None             # None -> 1/sqrt(head_dim)
    attn_windows: Any = None
    moe: bool = False
    num_experts: int = 1
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_eval_capacity_factor: float = 2.0
    moe_min_capacity: int = 4
    moe_aux_loss_coef: float = 0.01
    moe_use_residual: bool = False

    def __post_init__(self):
        if self.decode_impl not in ("auto", "einsum"):
            raise ValueError(f"unknown decode_impl {self.decode_impl!r}: "
                             f"use 'auto' or 'einsum'")
        if self.attention_impl not in ("auto", "xla"):
            raise NotImplementedError(
                f"attention_impl={self.attention_impl!r}: the flash and "
                f"sparse attention kernels are not ported yet")
        later = {"moe": self.moe, "sparse_attention":
                 self.sparse_attention is not None,
                 "sequence_parallel": self.sequence_parallel,
                 "attn_windows": self.attn_windows is not None,
                 "kv_cache_dtype='int8'": self.kv_cache_dtype != "auto",
                 "tp_overlap": self.tp_overlap}
        on = [name for name, flag in later.items() if flag]
        if on:
            raise NotImplementedError(
                f"{', '.join(on)}: not ported to PyTorch yet (see ROADMAP.md)")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def gpt2_125m(**kw):
    return GPTConfig(num_layers=12, num_heads=12, d_model=768, d_ff=3072, **kw)


def gpt2_1_3b(**kw):
    return GPTConfig(num_layers=24, num_heads=32, d_model=2048, d_ff=8192, **kw)


def gpt_neox_6_7b(**kw):
    return GPTConfig(num_layers=32, num_heads=32, d_model=4096, d_ff=16384,
                     rotary=True, parallel_residual=True, **kw)


def gpt_neox_20b(**kw):
    return GPTConfig(num_layers=44, num_heads=64, d_model=6144, d_ff=24576,
                     rotary=True, parallel_residual=True, tie_embeddings=False,
                     **kw)


def gpt3_175b(**kw):
    return GPTConfig(num_layers=96, num_heads=96, d_model=12288, d_ff=49152,
                     **kw)


# --------------------------------------------------------------------------
# Building blocks
# --------------------------------------------------------------------------

def rotary_embedding(x: torch.Tensor, positions: torch.Tensor,
                     rotary_dim: int) -> torch.Tensor:
    """Rotary position embedding on [..., S, H, D] over the first
    ``rotary_dim`` channels, interleaved pairs (0::2, 1::2)."""
    d = rotary_dim
    x_rot, x_pass = x[..., :d], x[..., d:]
    freqs = 1.0 / (10000 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[..., None].float() * freqs            # [.., S, d/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rot = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rot.to(x.dtype), x_pass], dim=-1)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: inputs and params cast to the compute
    dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _layer_norm(x: torch.Tensor, layer: nn.LayerNorm, dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: statistics in f32, result in dtype."""
    return F.layer_norm(x.float(), layer.normalized_shape,
                        layer.weight.float(), layer.bias.float(),
                        layer.eps).to(dtype)


def _kv_write(cache: torch.Tensor, kv: torch.Tensor,
              cur: torch.Tensor) -> None:
    """Write ``kv`` [b, s, h*d] into ``cache`` [b, S, h*d] at per-row offset
    ``cur`` [b], in place. Positions ``>= S`` are dropped (the masked-lane
    sentinel), one query column at a time so no position is written
    twice."""
    b, S = cache.shape[0], cache.shape[1]
    rows = torch.arange(b, device=cache.device)
    for j in range(kv.shape[1]):
        idx = cur + j
        keep = (idx < S)[:, None]
        idx = idx.clamp(max=S - 1)
        cache[rows, idx] = torch.where(keep, kv[:, j].to(cache.dtype),
                                       cache[rows, idx])


class SelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.qkv = nn.Linear(cfg.d_model, 3 * cfg.d_model, bias=True, **kw)
        self.out_proj = nn.Linear(cfg.d_model, cfg.d_model, bias=True, **kw)
        self.scale = (cfg.qk_scale if cfg.qk_scale is not None
                      else 1.0 / math.sqrt(cfg.head_dim))

    def forward(self, x, positions, kv=None, cache_index=None,
                decode_impl=None):
        """x [b, s, D]. Without ``kv``: causal attention over x itself
        (prefill). With ``kv = (ck, cv)`` [b, S, h*d] arena views: write this
        step's k/v at ``cache_index`` [b] and attend over each row's filled
        prefix. Returns (out [b, s, D], k, v [b, s, h*d])."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, d = cfg.num_heads, cfg.head_dim
        qkv = _linear(x, self.qkv, cfg.dtype)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(cfg.d_model, -1))
        if cfg.rotary:
            rd = int(cfg.rotary_pct * d)
            q = rotary_embedding(q, positions, rd)
            k = rotary_embedding(k, positions, rd)
        k, v = k.reshape(b, s, h * d), v.reshape(b, s, h * d)
        if kv is None:
            out = masked_cache_attention(q, k.view(b, s, h, d),
                                         v.view(b, s, h, d), 0, self.scale)
        else:
            ck, cv = kv
            _kv_write(ck, k, cache_index)
            _kv_write(cv, v, cache_index)
            out = self._decode_attention(q, ck, cv, cache_index,
                                         decode_impl or cfg.decode_impl)
        out = _linear(out.reshape(b, s, cfg.d_model), self.out_proj,
                      cfg.dtype)
        return out, k, v

    def _decode_attention(self, q, ck, cv, cur, impl):
        b, s, h, d = q.shape
        S = ck.shape[1]
        if impl == "auto":      # the kernel, which raises on a shape it lacks
            return decode_attention(q.contiguous(), ck, cv, cur + s,
                                    scale=self.scale)
        return masked_cache_attention(q, ck.view(b, S, h, d),
                                      cv.view(b, S, h, d), cur, self.scale)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.up_proj = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.down_proj = nn.Linear(cfg.d_ff, cfg.d_model, **kw)

    def forward(self, x):
        dt = self.cfg.dtype
        h = F.gelu(_linear(x, self.up_proj, dt), approximate="tanh")
        return _linear(h, self.down_proj, dt)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(eps=cfg.layer_norm_eps, dtype=cfg.param_dtype,
                  device=device)
        self.ln_1 = nn.LayerNorm(cfg.d_model, **kw)
        self.ln_2 = nn.LayerNorm(cfg.d_model, **kw)
        self.attn = SelfAttention(cfg, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, positions, kv=None, cache_index=None,
                decode_impl=None):
        dt = self.cfg.dtype
        a, k, v = self.attn(_layer_norm(x, self.ln_1, dt), positions, kv,
                            cache_index, decode_impl)
        if self.cfg.parallel_residual:
            # NeoX: x + attn(ln1(x)) + ffn(ln2(x))
            out = x + a + self.mlp(_layer_norm(x, self.ln_2, dt))
        else:
            hdn = x + a
            out = hdn + self.mlp(_layer_norm(hdn, self.ln_2, dt))
        return out, k, v


class GPT(nn.Module):
    """Decoder-only LM. ``forward(input_ids [B, S]) -> logits [B, S, V]``."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        if not cfg.rotary:
            self.wpe = nn.Parameter(
                torch.empty(cfg.max_seq_len, cfg.d_model, **kw))
        self.blocks = nn.ModuleList(
            Block(cfg, device=device) for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False,
                                     **kw)
        self.init_weights()

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None,
                     std: float = 0.02) -> None:
        """Random weights: matrices and embeddings ~ N(0, std), biases 0,
        LayerNorm scales 1."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in name or name.startswith("ln_"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)

    def _embed(self, input_ids, positions):
        dt = self.cfg.dtype
        x = F.embedding(input_ids, self.wte.weight.to(dt))
        if not self.cfg.rotary:
            x = x + self.wpe[positions].to(dt)
        return x

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Final-LayerNormed hidden states -> logits (tied: ``x @ wte.T``)."""
        head = self.wte if self.cfg.tie_embeddings else self.lm_head
        return F.linear(hidden.to(self.cfg.dtype),
                        head.weight.to(self.cfg.dtype))

    def prefill(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Cacheless causal forward. Returns (hidden [B, P, D] after ln_f,
        keys and values [L, B, P, h*d])."""
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device
                                     )[None, :].expand(b, s)
        x = self._embed(input_ids, positions)
        ks: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []
        for blk in self.blocks:
            x, k, v = blk(x, positions)
            ks.append(k)
            vs.append(v)
        x = _layer_norm(x, self.ln_f, self.cfg.dtype)
        return x, torch.stack(ks), torch.stack(vs)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden, _, _ = self.prefill(input_ids, positions)
        return self.logits(hidden)

    def decode(self, input_ids: torch.Tensor, positions: torch.Tensor,
               cache_k: torch.Tensor, cache_v: torch.Tensor,
               cache_index: torch.Tensor,
               decode_impl: Optional[str] = None) -> torch.Tensor:
        """``s`` tokens per row against the arena. input_ids/positions
        [B, s]; cache_k/cache_v [L, B, S, h*d], written in place at
        ``cache_index`` [B] (>= S drops the write). ``decode_impl``
        overrides ``cfg.decode_impl`` (the serving engine's megakernel
        switch). Returns logits [B, s, V]."""
        x = self._embed(input_ids, positions)
        for layer, blk in enumerate(self.blocks):
            x, _, _ = blk(x, positions, (cache_k[layer], cache_v[layer]),
                          cache_index, decode_impl)
        return self.logits(_layer_norm(x, self.ln_f, self.cfg.dtype))
