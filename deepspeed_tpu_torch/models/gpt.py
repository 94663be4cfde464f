"""GPT model family (GPT-2 / GPT-NeoX style) in PyTorch.

Counterpart of ``deepspeed_tpu/models/gpt.py``. The flax ``nn.scan`` over
stacked ``[L, ...]`` block params becomes a layer loop over ``blocks``
(``convert.py`` unstacks the TPU tree). Three forward modes:

  * :meth:`GPT.forward` -- the TPU ``GPT.__call__`` without a cache: the
    training forward. Attention routes through ``cfg.attention_impl``
    (:func:`causal_attention`): "auto"/"pallas" is the flash attention
    autograd function of ``ops/cuda/flash_attention.py`` (the CUDA kernels
    on a CUDA tensor, their plain versions on a CPU tensor), "sparse" the
    block-sparse one of ``ops/sparse_attention`` over
    ``cfg.sparse_attention``'s layout (always causal), "xla" the masked
    einsum. Under ``cfg.remat`` each block is checkpointed;
  * :meth:`GPT.prefill` -- cacheless causal forward over a prompt batch on
    the masked einsum (the TPU serving prefill's ``_cache_einsum``);
    returns the final hidden states and every layer's K/V, which the
    serving engine moves into its arena;
  * :meth:`GPT.decode` -- ``s`` new tokens per row against a per-slot KV
    arena ``[L, B, S, h*d]`` (stored flat, as the TPU kernel path stores it)
    with a per-row write cursor. A write at ``>= max_seq_len`` is dropped:
    the serving engine pins retired lanes there (the masked-lane sentinel).

Decode attention routes through ``ops/cuda/decode_attention.py`` when
``decode_impl == "auto"`` (the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor) and through the masked einsum otherwise. Unlike the
TPU model, "auto" never gives way to the einsum: on the card a shape a
kernel does not take (head dim, dtype, query width) raises. The large
projections, the loss and the LayerNorms stay torch ops.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from ..ops.cuda.decode_attention import (decode_attention,
                                         masked_cache_attention)
from ..ops.cuda.flash_attention import flash_attention
from ..ops.sparse_attention.sparse_self_attention import sparse_attention

aten = torch.ops.aten

# remat_policy -> the aten ops whose outputs a checkpointed block saves (the
# rest is recomputed in the backward): the analogues of JAX's
# dots_saveable and dots_with_no_batch_dims_saveable. F.linear reaches
# mm/addmm, the batched einsums of the "xla" attention bmm.
_REMAT_SAVE = {
    "nothing": (),
    "dots": (aten.mm.default, aten.addmm.default, aten.bmm.default,
             aten.baddbmm.default),
    "dots_no_batch": (aten.mm.default, aten.addmm.default),
}


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The TPU package's GPTConfig, field for field. Fields of features not
    ported yet (MoE, sequence parallelism, local windows, the int8 cache,
    the tp overlap, cpu checkpointing) must stay at their defaults.
    ``attention_impl="sparse"`` needs a ``sparse_attention`` SparsityConfig
    (the port's own, ``ops/sparse_attention``) and ``sparse_attention`` is
    read only under it. ``remat``/``remat_policy`` checkpoint each block of the
    training forward; ``dropout`` is unused, as in the TPU model; the scan
    knobs and ``partition_activations`` (a tp sharding constraint) have no
    effect on one device."""
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
    attention_impl: str = "auto"     # auto | pallas (flash) | sparse | xla
    sparse_attention: Any = None     # SparsityConfig when attention_impl=sparse
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
        if self.attention_impl not in ("auto", "xla", "pallas", "sparse"):
            raise ValueError(f"unknown attention_impl "
                             f"{self.attention_impl!r}: use 'auto', 'pallas', "
                             f"'sparse' or 'xla'")
        # The TPU model computes dense attention when attention_impl="sparse"
        # has no layout (its causal_attention falls through to the einsum);
        # the port refuses rather than hide the kernel.
        if self.attention_impl == "sparse" and self.sparse_attention is None:
            raise ValueError("attention_impl='sparse' needs a "
                             "sparse_attention SparsityConfig")
        if self.remat_policy not in _REMAT_SAVE:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}: "
                             f"use one of {sorted(_REMAT_SAVE)}")
        later = {"moe": self.moe,
                 "sequence_parallel": self.sequence_parallel,
                 "attn_windows": self.attn_windows is not None,
                 "kv_cache_dtype='int8'": self.kv_cache_dtype != "auto",
                 "tp_overlap": self.tp_overlap,
                 "cpu_checkpointing": self.cpu_checkpointing}
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


@torch.no_grad()
def init_weights(module: nn.Module,
                 generator: Optional[torch.Generator] = None,
                 std: float = 0.02) -> None:
    """Random weights for the port's models, by parameter name: matrices
    and embeddings ~ N(0, std), biases 0, LayerNorm (``ln_*``) scales 1."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif ".ln_" in name or name.startswith("ln_"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, std, generator=generator)


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


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     dtype, impl: str = "auto",
                     scale: Optional[float] = None,
                     sparse_config=None) -> torch.Tensor:
    """q, k, v: [B, S, H, D]. Routes to the configured attention: "auto" or
    "pallas" is the flash attention autograd function (the CUDA kernels on a
    CUDA tensor, which raise on a shape they lack; their plain versions on a
    CPU tensor), "sparse" the block-sparse one over ``sparse_config``'s
    layout, "xla" the TPU package's masked einsum (mask -1e10,
    probabilities cast to ``dtype``). Unlike the TPU model, "auto" does not
    turn into "xla" off the accelerator, and "sparse" without a layout
    raises instead of computing dense attention."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl in ("auto", "pallas"):
        return flash_attention(q, k, v, causal=True, sm_scale=scale)
    if impl == "sparse":
        if sparse_config is None:
            raise ValueError("impl='sparse' needs a sparse_config")
        # causal regardless of the layout's attention mode: a decoder LM
        # never sees the future, even through a bidirectional layout
        return sparse_attention(q, k, v, sparse_config, sm_scale=scale,
                                causal=True)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = q.shape[1]
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    logits = torch.where(causal, logits, -1e10)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


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
                decode_impl=None, attention_impl=None):
        """x [b, s, D]. Without ``kv``: causal attention over x itself,
        through :func:`causal_attention` with ``attention_impl`` (training)
        or, when that is None, the masked einsum (prefill). With
        ``kv = (ck, cv)`` [b, S, h*d] arena views: write this step's k/v at
        ``cache_index`` [b] and attend over each row's filled prefix.
        Returns (out [b, s, D], k, v [b, s, h*d])."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, d = cfg.num_heads, cfg.head_dim
        qkv = _linear(x, self.qkv, cfg.dtype)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(cfg.d_model, -1))
        if cfg.rotary:
            rd = int(cfg.rotary_pct * d)
            q = rotary_embedding(q, positions, rd)
            k = rotary_embedding(k, positions, rd)
        if kv is None and attention_impl is not None:
            out = causal_attention(q, k, v, dtype=cfg.dtype,
                                   impl=attention_impl, scale=self.scale,
                                   sparse_config=cfg.sparse_attention)
            return _linear(out.reshape(b, s, cfg.d_model), self.out_proj,
                           cfg.dtype), k, v
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
                decode_impl=None, attention_impl=None):
        dt = self.cfg.dtype
        a, k, v = self.attn(_layer_norm(x, self.ln_1, dt), positions, kv,
                            cache_index, decode_impl, attention_impl)
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

    def init_weights(self, generator: Optional[torch.Generator] = None,
                     std: float = 0.02) -> None:
        """Random weights: matrices and embeddings ~ N(0, std), biases 0,
        LayerNorm scales 1."""
        init_weights(self, generator, std)

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
        """The TPU ``GPT.__call__`` without a cache: logits [B, S, V], with
        attention through ``cfg.attention_impl``. Under ``cfg.remat`` (and
        with grad enabled) each block runs under non-reentrant
        ``torch.utils.checkpoint``, saving only what ``cfg.remat_policy``
        names; the rest, flash or sparse attention included, is recomputed
        in the backward."""
        cfg = self.cfg
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device
                                     )[None, :].expand(b, s)
        x = self._embed(input_ids, positions)
        run = functools.partial(_block_output, impl=cfg.attention_impl)
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x = torch_checkpoint.checkpoint(
                    run, blk, x, positions, use_reentrant=False,
                    context_fn=_remat_context(cfg.remat_policy))
            else:
                x = run(blk, x, positions)
        return self.logits(_layer_norm(x, self.ln_f, cfg.dtype))

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


def _block_output(blk: Block, x, positions, impl: str) -> torch.Tensor:
    return blk(x, positions, attention_impl=impl)[0]


def _remat_context(policy: str):
    """``context_fn`` of ``torch.utils.checkpoint`` for a remat policy."""
    saved = _REMAT_SAVE[policy]
    if not saved:
        return torch_checkpoint.noop_context_fn
    return functools.partial(
        torch_checkpoint.create_selective_checkpoint_contexts, list(saved))


def lm_loss_fn(logits: torch.Tensor,
               batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross entropy. ``batch``: {input_ids, labels?,
    loss_mask?}; labels default to the shifted input_ids. nll is the f32
    logsumexp minus the gathered label logit (no [B, S, V] log-softmax), as
    in the TPU package."""
    labels = batch.get("labels")
    if labels is None:
        labels = batch["input_ids"][:, 1:]
        logits = logits[:, :-1]
    lse = torch.logsumexp(logits.float(), dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll.float()
    mask = batch.get("loss_mask")
    if mask is None:
        return nll.mean()
    mask = mask[:, :nll.shape[1]].to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def gpt_flops_per_token(cfg: GPTConfig, seq_len: Optional[int] = None
                        ) -> float:
    """6N + attention flops per token (for MFU accounting): the training
    step's forward and backward, as the TPU package counts them."""
    s = seq_len or cfg.max_seq_len
    n = (12 * cfg.d_model ** 2 + 2 * cfg.d_model * cfg.d_ff) \
        * cfg.num_layers + 2 * cfg.vocab_size * cfg.d_model
    return 6.0 * n + 12.0 * cfg.num_layers * cfg.d_model * s
