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
    serving engine moves into its arena. Under ``kv_cache_dtype="int8"``
    the K/V come back quantized with their scales, and the prompt's own
    attention reads them dequantized, as the TPU prefill reads its int8
    cache;
  * :meth:`GPT.decode` -- ``s`` new tokens per row against a KV cache with
    a per-row write cursor: a per-slot arena ``[L, B, S, h*d]`` (stored
    flat, as the TPU kernel path stores it) or, with ``block_tables``, a
    paged block pool ``[L, nb + 1, bs, h*d]`` whose last block is a sink.
    A write at ``>= max_seq_len`` is dropped (the dense arena keeps the old
    value, the paged pool sends it to the sink): the serving engine pins
    retired lanes there (the masked-lane sentinel). An int8 cache is
    written quantized, with its f32 per-position scales beside it.

Decode attention routes through ``ops/cuda/decode_attention.py`` when
``decode_impl == "auto"`` (the dense or paged CUDA kernel, int8 or not, on a
CUDA tensor; their plain versions on a CPU tensor) and through the masked
einsum otherwise (over the pool gathered through the tables when paged).
Unlike the TPU model, "auto" never gives way to the einsum: on the card a
shape a kernel does not take (head dim, dtype, block size) raises; every
query width is taken. The large projections, the loss and the LayerNorms
stay torch ops.

Tensor parallelism (:func:`set_tensor_parallel`, or
:func:`init_tp_shards` for a model too large to build whole): each rank
keeps its shard of every Linear and of the token embedding by the TPU
package's ``tp_spec`` (``runtime/sharding.py``), and the collectives are
explicit (``module_inject/layers.py``): ``SelfAttention`` runs this rank's
``num_heads / tp`` heads (its q, k and v thirds of the fused ``qkv``),
``MLP`` a column then a row Linear, each row output reduced before the
residual add (a NeoX block reduces both branches; ``cfg.tp_overlap`` splits
the attention's reduce around the MLP GEMM in decode, ``ops/tp_overlap.py``),
``wte`` and an untied ``lm_head`` are vocab-parallel and the logits are
gathered whole on every rank. The KV cache a decode step reads holds this
rank's heads. Under ``cfg.partition_activations`` with ``remat`` each
block's saved input is this rank's ``S / tp`` rows, gathered again before
its recompute (:class:`PartitionedCheckpoint`).

Sequence parallelism (:func:`set_sequence_parallel`, the engine's
``mesh: {"sp": n}``): the TPU model expresses it as sharding constraints
and GSPMD inserts the exchanges; here each rank holds whole parameters and
its ``S / sp`` columns of every row (positions ``r * S / sp + i``), and
``SelfAttention`` exchanges explicitly over the sp group: under
``cp_impl="ulysses"`` q, k and v go to head shards (the whole sequence for
``H / sp`` heads, one all-to-all, :func:`seq_to_heads`), attend (the flash
kernels in training, which the TPU model cannot partition there) and come
back (:func:`heads_to_seq`); under ``"ring"`` the K/V chunks travel the
ring (``ops/ring_attention.py``).

Under ``cfg.moe`` every block's MLP is a Mixture-of-Experts layer
(``moe/layer.py``), as in the TPU model: the training forward
(``deterministic=False``) gates at ``moe_capacity_factor`` with the draws
of ``generator`` (made per layer before the blocks run, so a remat
recompute routes the same way) and returns ``(logits,
moe_aux_loss_coef * sum of the layers' l_aux)``; every other call (eval,
prefill, decode) gates at ``moe_eval_capacity_factor`` with no draw, over
every row it is given.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import zlib
from typing import Any, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from ..module_inject.layers import (copy_to_tp, embedding, gather_from_tp,
                                    reduce_from_tp, scatter_to_tp,
                                    shard_by_tp_spec, shard_module_,
                                    tp_kind, tp_linear, tp_partial)
from ..comm import comm
from ..ops.ring_attention import SP_TRAFFIC, ring_attention
from ..ops.tp_overlap import defer_attn_allreduce, overlap_supported
from ..utils.logging import logger

from ..ops.cuda.decode_attention import (decode_attention,
                                         masked_cache_attention,
                                         paged_decode_attention,
                                         paged_gather_kv)
from ..ops.cuda.flash_attention import flash_attention
from ..ops.quantizer import dequantize_kv, quantize_kv
from ..moe.layer import MoE
from ..ops.sparse_attention.sparse_self_attention import sparse_attention
from ..runtime.activation_checkpointing import (HostCheckpoints,
                                                offloaded_checkpoint,
                                                partitionable,
                                                partitioned_checkpoint)

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
    """The TPU package's GPTConfig, field for field. ``sequence_parallel``
    splits the sequence over the engine's sp group
    (:func:`set_sequence_parallel`) with ``cp_impl`` "ulysses" or "ring";
    it does nothing without one. ``moe`` replaces every block's MLP with
    ``num_experts`` MLP experts behind a top-``moe_top_k`` gate (``moe_use_residual``: PR-MoE's
    dense residual MLP beside them). ``attn_windows`` is one local-attention window (or None,
    a global layer) a layer, GPT-Neo's alternation; it needs
    ``scan_layers=False``, as in the TPU model, and refuses
    ``attention_impl="sparse"`` (the TPU model's sparse path drops the
    window). ``cpu_checkpointing`` (with ``remat``)
    keeps each block's input in page-locked host memory instead of on the
    device (:func:`offloaded_checkpoint`). ``kv_cache_dtype`` is
    "auto" (the cache in ``dtype``) or "int8". ``tp_overlap`` (parallel
    residual only) splits the attention's tp reduce around the MLP GEMM in
    decode; ``partition_activations`` keeps a tp rank's ``S / tp`` rows of
    each remat-saved block input. Both do nothing at tp 1.
    ``attention_impl="sparse"`` needs a ``sparse_attention`` SparsityConfig
    (the port's own, ``ops/sparse_attention``) and ``sparse_attention`` is
    read only under it. ``remat``/``remat_policy`` checkpoint each block of the
    training forward; ``dropout`` is unused, as in the TPU model; the scan
    knobs have no effect."""
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
        if self.cpu_checkpointing and not self.remat:
            raise ValueError(
                "cpu_checkpointing offloads remat-saved block inputs to "
                "host memory, so it requires remat=True")
        if self.cp_impl not in ("ulysses", "ring"):
            raise ValueError(
                f"cp_impl must be 'ulysses' or 'ring', got {self.cp_impl!r}")
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
        if self.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'auto' or 'int8', "
                             f"got {self.kv_cache_dtype!r}")
        if self.remat_policy not in _REMAT_SAVE:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}: "
                             f"use one of {sorted(_REMAT_SAVE)}")
        if self.attn_windows is not None:
            windows = tuple(self.attn_windows)
            if len(windows) != self.num_layers:
                raise ValueError(f"attn_windows has {len(windows)} entries "
                                 f"for {self.num_layers} layers")
            if self.scan_layers:
                raise ValueError("attn_windows (heterogeneous layers) "
                                 "requires scan_layers=False")
            if self.attention_impl == "sparse":
                raise ValueError("attn_windows with attention_impl='sparse':"
                                 " the block-sparse layout has no local "
                                 "window")
        if self.moe:
            if self.num_experts < 1 or self.moe_top_k not in (1, 2):
                raise ValueError(f"moe needs num_experts >= 1 and moe_top_k "
                                 f"1 or 2, got {self.num_experts} and "
                                 f"{self.moe_top_k}")
            if self.cpu_checkpointing:
                raise NotImplementedError(
                    "cpu_checkpointing of MoE blocks: not ported to PyTorch "
                    "yet (ROADMAP A9)")
            if self.sequence_parallel:
                raise NotImplementedError(
                    "sequence_parallel MoE blocks: not ported to PyTorch "
                    "yet (ROADMAP A9)")
        if self.tp_overlap and not self.parallel_residual:
            raise ValueError(
                "tp_overlap hides the attention all-reduce behind the "
                "parallel-residual MLP gemm; it requires "
                "parallel_residual=True")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def window(self, layer: int) -> Optional[int]:
        """Layer ``layer``'s local-attention window, None for a global
        layer."""
        return None if self.attn_windows is None else \
            self.attn_windows[layer]


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


def gpt_moe_1_3b(num_experts=128, **kw):
    """1.3B + MoE-128, the MoE-NLG family (reference
    docs/_posts/2021-12-09-deepspeed-moe-nlg.md:123-133)."""
    return GPTConfig(num_layers=24, num_heads=16, d_model=2048, d_ff=8192,
                     moe=True, num_experts=num_experts, **kw)


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


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: inputs and params cast to the compute
    dtype."""
    bias = None if bias is None else bias.to(dtype)
    return F.linear(x.to(dtype), weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: statistics in f32, result in dtype."""
    return F.layer_norm(x.float(), weight.shape, weight.float(),
                        bias.float(), eps).to(dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """``layer`` on ``x`` in ``dtype``; a tensor-parallel layer (a ``tp``
    tag) with its collectives."""
    if getattr(layer, "tp", None) is not None:
        return tp_linear(x, layer, dtype)
    return linear(x, layer.weight, layer.bias, dtype)


def _tp_group(layer: nn.Module):
    info = getattr(layer, "tp", None)
    return None if info is None else info.group


def _layer_norm(x: torch.Tensor, layer: nn.LayerNorm, dtype) -> torch.Tensor:
    return layer_norm(x, layer.weight, layer.bias, layer.eps, dtype)


def embed_tokens(cfg: GPTConfig, wte, wpe: Optional[torch.Tensor],
                 input_ids: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Token (and, without rotary, learned position) embeddings in the
    compute dtype: the trunk's input. ``wte`` is the table or its
    ``nn.Embedding`` (a vocab-parallel one under tp)."""
    dt = cfg.dtype
    x = embedding(input_ids, wte, dt)
    if not cfg.rotary:
        x = x + wpe[positions].to(dt)
    return x


def head_logits(cfg: GPTConfig, head: torch.Tensor,
                hidden: torch.Tensor) -> torch.Tensor:
    """Final-LayerNormed hidden states -> logits over ``head`` [V, D] (the
    tied ``wte`` or ``lm_head``)."""
    return F.linear(hidden.to(cfg.dtype), head.to(cfg.dtype))


def vocab_logits(cfg: GPTConfig, head: nn.Module,
                 hidden: torch.Tensor) -> torch.Tensor:
    """Final-LayerNormed hidden states -> logits over the module ``head``
    (the tied ``wte`` or ``lm_head``, weight [V, D]). Under tp the head is
    vocab-parallel and the logits are gathered: every rank returns them
    whole (a tied ``wte`` that auto-TP split by features reduces the partial
    logits of its features instead)."""
    group = _tp_group(head)
    if group is None:
        return head_logits(cfg, head.weight, hidden)
    if head.tp.kind == "feature":
        local = head_logits(cfg, head.weight, scatter_to_tp(hidden, group, -1))
        return reduce_from_tp(local, group)
    local = head_logits(cfg, head.weight, copy_to_tp(hidden, group))
    return gather_from_tp(local, group, -1)


def final_logits(cfg: GPTConfig, x: torch.Tensor, ln_w: torch.Tensor,
                 ln_b: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The trunk's output -> ln_f -> logits."""
    return head_logits(cfg, head, layer_norm(x, ln_w, ln_b,
                                             cfg.layer_norm_eps, cfg.dtype))


def _kv_write(cache: torch.Tensor, kv: torch.Tensor,
              cur: torch.Tensor) -> None:
    """Write ``kv`` [b, s, ...] into ``cache`` [b, S, ...] (a K/V arena
    layer [b, S, h*d], or its int8 scales [b, S]) at per-row offset ``cur``
    [b], in place, in one scatter. Positions ``>= S`` are dropped (the
    masked-lane sentinel): a dropped column is sent to a position the same
    scatter writes with the same value, its row's first column when that is
    live, else position S - 1 with the value the row holds there, so every
    repeated index carries one value and the scatter stays deterministic.
    Rows are distinct, so no two lanes race for one position."""
    b, S = cache.shape[0], cache.shape[1]
    s = kv.shape[1]
    rest = cache.shape[2:]
    pos = cur.long()[:, None] + torch.arange(s, device=cache.device)
    live = pos < S                                              # [b, s]
    first = live[:, :1]
    idx = torch.where(live, pos, torch.where(first, pos[:, :1], S - 1))
    bcast = (b, s) + (1,) * len(rest)
    new = kv.to(cache.dtype)
    held = cache[:, S - 1:]                                     # [b, 1, ...]
    val = torch.where(live.view(bcast), new,
                      torch.where(first.view(b, 1, *bcast[2:]),
                                  new[:, :1], held))
    rows = torch.arange(b, device=cache.device)[:, None] * S
    cache.view(b * S, *rest).index_copy_(0, (rows + idx).reshape(-1),
                                         val.reshape(b * s, *rest))


class PagedStep(NamedTuple):
    """One decode step's view of a paged cache, shared by every layer: the
    block tables [b, T] the attention reads through, and the flat pool
    index [b*s] each new position is written to (:func:`paged_write_index`)."""
    tables: torch.Tensor
    write_index: torch.Tensor


def paged_write_index(block_tables: torch.Tensor, cur: torch.Tensor, s: int,
                      block_size: int, num_blocks: int) -> torch.Tensor:
    """Where the paged write of ``s`` tokens per row at ``cur`` [b] lands:
    flat position ``table[r, p // bs] * bs + p % bs`` of a pool
    [num_blocks + 1, bs, ...] whose block ``num_blocks`` is the sink (the
    TPU package's ``_kv_write_paged`` index). A position ``>= T*bs`` (the
    masked-lane sentinel) or one whose table entry is the ``padded_table``
    sentinel (past the row's reservation) goes to the sink instead of being
    dropped by index range, which on a CUDA tensor would be a device-side
    assert. Only sink positions can be named twice, and nothing reads them
    unmasked. Returns [b*s] int64."""
    nb, bs = num_blocks, block_size
    T = block_tables.shape[1]
    pos = cur.long()[:, None] + torch.arange(s, device=cur.device)  # [b, s]
    blk = torch.gather(block_tables.long(), 1, (pos // bs).clamp(0, T - 1))
    flat = torch.where(pos < T * bs, blk.clamp(max=nb) * bs + pos % bs,
                       nb * bs)
    return flat.reshape(-1)


def _kv_write_paged(pool: torch.Tensor, kv: torch.Tensor,
                    index: torch.Tensor) -> None:
    """Paged counterpart of :func:`_kv_write`: ``kv`` [b, s, ...] into
    ``pool`` [nb + 1, bs, ...] at the flat positions ``index`` [b*s] of
    :func:`paged_write_index`, in place."""
    pool.view(-1, *pool.shape[2:]).index_copy_(
        0, index, kv.reshape(index.numel(), *pool.shape[2:]).to(pool.dtype))


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     dtype, impl: str = "auto",
                     scale: Optional[float] = None,
                     sparse_config=None,
                     window: Optional[int] = None) -> torch.Tensor:
    """q, k, v: [B, S, H, D]. Routes to the configured attention: "auto" or
    "pallas" is the flash attention autograd function (the CUDA kernels on a
    CUDA tensor, which raise on a shape they lack; their plain versions on a
    CPU tensor), "sparse" the block-sparse one over ``sparse_config``'s
    layout, "xla" the TPU package's masked einsum (mask -1e10,
    probabilities cast to ``dtype``). A local ``window`` (each query sees
    its last ``window`` keys) takes the masked einsum under every impl, as
    the TPU model's does. Unlike the TPU model, "auto" does not turn into
    "xla" off the accelerator, and "sparse" without a layout raises instead
    of computing dense attention."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if window is not None:
        impl = "xla"
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
    if window is not None:
        causal = causal.triu(-(window - 1))
    logits = torch.where(causal, logits, -1e10)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# --------------------------------------------------------------------------
# Sequence parallelism: the Ulysses exchanges
# --------------------------------------------------------------------------

def _sp_size(group) -> int:
    return 1 if group is None else group.size


def _all_to_all(x: torch.Tensor, group, split: int, cat: int
                ) -> torch.Tensor:
    """``x`` cut into ``group.size`` pieces along dim ``split``, piece j to
    rank j; the pieces received are joined along dim ``cat`` in rank
    order."""
    n = group.size
    shape = list(x.shape)
    pieces = x.reshape(shape[:split] + [n, shape[split] // n]
                       + shape[split + 1:]).movedim(split, 0).contiguous()
    SP_TRAFFIC["all_to_all"] += 1
    SP_TRAFFIC["all_to_all_bytes"] += pieces.numel() * pieces.element_size()
    got = comm.all_to_all_single(pieces, group)          # [n, ...piece]
    shape[split] //= n
    shape[cat] *= n
    return got.movedim(0, cat).reshape(shape)


class _SeqHeads(torch.autograd.Function):
    """``[..., S/sp, H, d]`` -> ``[..., S, H/sp, d]`` (``to_heads``) or
    back; the backward is the opposite exchange."""

    @staticmethod
    def forward(ctx, x, group, to_heads: bool):
        ctx.group, ctx.to_heads = group, to_heads
        seq, heads = x.dim() - 3, x.dim() - 2
        return (_all_to_all(x, group, heads, seq) if to_heads
                else _all_to_all(x, group, seq, heads))

    @staticmethod
    def backward(ctx, g):
        return _SeqHeads.forward(ctx, g, ctx.group, not ctx.to_heads), \
            None, None


class _GatherSeq(torch.autograd.Function):
    """``[..., S/sp, H, d]`` -> every rank's chunk joined along the
    sequence; the backward sums the ranks' grads and keeps this rank's
    chunk (each rank's grad of the whole sequence is its own)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        seq = x.dim() - 3
        return comm.all_gather(x.contiguous(), group).movedim(0, seq) \
            .flatten(seq, seq + 1)

    @staticmethod
    def backward(ctx, g):
        n, seq = ctx.group.size, g.dim() - 3
        parts = g.unflatten(seq, (n, g.shape[seq] // n)).movedim(seq, 0)
        return comm.reduce_scatter_base(parts.contiguous(),
                                        group=ctx.group)[0], None


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """The TPU package's ``sp_shard_heads``: ``[..., S/sp, H, d]`` sequence
    chunks -> ``[..., S, H/sp, d]``, the whole sequence for this rank's
    heads, by one all-to-all over the sp ``group`` (identity without
    one)."""
    return x if _sp_size(group) == 1 else _SeqHeads.apply(x, group, True)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The TPU package's ``sp_shard_sequence`` of an attention output:
    ``[..., S, H/sp, d]`` -> ``[..., S/sp, H, d]``."""
    return x if _sp_size(group) == 1 else _SeqHeads.apply(x, group, False)


_sp_drop_warned = set()


def ulysses_attention(q, k, v, group, attend) -> torch.Tensor:
    """``attend(q, k, v)`` over the whole sequence, for this rank's
    ``[B, S/sp, H, d]`` chunks: q, k and v go to head shards together and
    the output comes back to sequence chunks. Where sp does not divide the
    heads, the TPU package's constraint drops the sp axis (with a warning)
    and computes the same result; so does this: the chunks are gathered,
    every head attends over the whole sequence and the rank keeps its own
    rows."""
    n = _sp_size(group)
    if n == 1:
        return attend(q, k, v)
    qkv = torch.stack([q, k, v])
    if q.shape[2] % n == 0:
        return heads_to_seq(attend(*seq_to_heads(qkv, group).unbind(0)),
                            group)
    key = (tuple(q.shape), n)
    if key not in _sp_drop_warned:
        _sp_drop_warned.add(key)
        logger.warning(
            f"sequence-parallel sharding dropped: dim 2 of a "
            f"{tuple(q.shape)} chunk is not divisible by sp={n} -- Ulysses "
            f"needs num_heads % sp == 0; gathering the sequence instead")
    s, r = q.shape[1], group.rank
    out = attend(*_GatherSeq.apply(qkv, group).unbind(0))
    return out[:, r * s:(r + 1) * s]


class SelfAttention(nn.Module):
    """``window``: this layer's local-attention window (None: global). A
    windowed layer attends through the masked einsum in the forward, the
    prefill and decode, whatever ``attention_impl`` / ``decode_impl`` say,
    as the TPU model's does, and has no paged path. ``sp_group``: the sp
    group the sequence is split over (:func:`set_sequence_parallel`)."""

    def __init__(self, cfg: GPTConfig, device=None,
                 window: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.window = window
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.qkv = nn.Linear(cfg.d_model, 3 * cfg.d_model, bias=True, **kw)
        self.out_proj = nn.Linear(cfg.d_model, cfg.d_model, bias=True, **kw)
        self.scale = (cfg.qk_scale if cfg.qk_scale is not None
                      else 1.0 / math.sqrt(cfg.head_dim))
        self.sp_group = None

    @property
    def local_heads(self) -> int:
        """This rank's heads: all of them, or ``num_heads / tp`` under tp
        (its third of the fused ``qkv``'s output features each)."""
        return self.qkv.out_features // (3 * self.cfg.head_dim)

    def forward(self, x, positions, kv=None, cache_index=None,
                decode_impl=None, attention_impl=None,
                paged: Optional[PagedStep] = None, partial: bool = False):
        """x [b, s, D]. Without ``kv``: causal attention over x itself,
        through :func:`causal_attention` with ``attention_impl`` (training)
        or, when that is None, the masked einsum (prefill; under the int8
        cache over the quantized K/V, dequantized). With
        ``kv = (ck, cv, k_scale, v_scale)``: write this step's k/v at
        ``cache_index`` [b] and attend over each row's filled prefix. ck/cv
        are [b, S, h*d] arena views, or with ``paged`` (the step's tables
        and write index) the paged pools [nb + 1, bs, h*d]; the scales are
        None, or the int8 cache's f32 [b, S] / [nb + 1, bs] views.
        Returns (out [b, s, D], k, v [b, s, h*d]); under the int8 cache's
        prefill k and v are (int8 payload [b, s, h*d], f32 scale [b, s])
        pairs. Under tp the heads and k/v are this rank's, and ``partial``
        returns the out projection's partial product, unreduced and without
        its bias (the caller reduces it: ``tp_overlap``).

        Under ``cfg.sequence_parallel`` with an sp group, x is this rank's
        sequence chunk and attention without ``kv`` spans the whole
        sequence: ``cp_impl="ulysses"`` through :func:`ulysses_attention`
        (the training forward's flash kernels over ``H / sp`` heads, or
        the prefill's masked einsum), ``"ring"`` (training) through
        ``ops/ring_attention.py``; k/v come back as the chunk's own. A
        decode step over an sp group raises."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, d = self.local_heads, cfg.head_dim
        sp = self.sp_group if _sp_size(self.sp_group) > 1 else None
        qkv = _linear(x, self.qkv, cfg.dtype)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, -1))
        if cfg.rotary:
            rd = int(cfg.rotary_pct * d)
            q = rotary_embedding(q, positions, rd)
            k = rotary_embedding(k, positions, rd)
        if kv is None and attention_impl is not None:
            ring = cfg.sequence_parallel and cfg.cp_impl == "ring"
            if ring and (self.window is not None
                         or cfg.sparse_attention is not None):
                raise NotImplementedError(
                    "cp_impl='ring' computes full causal attention; local "
                    "windows / sparse layouts are not ring-aware -- use "
                    "cp_impl='ulysses' for those configs")
            if sp is not None and attention_impl == "sparse":
                raise NotImplementedError(
                    "block-sparse attention over an sp group (its layout "
                    "split by heads): not ported to PyTorch yet (ROADMAP "
                    "A9)")
            if ring:
                out = ring_attention(q, k, v, sp, scale=self.scale)
            else:
                out = ulysses_attention(q, k, v, sp, functools.partial(
                    causal_attention, dtype=cfg.dtype, impl=attention_impl,
                    scale=self.scale, sparse_config=cfg.sparse_attention,
                    window=self.window))
            return self._project(out.reshape(b, s, h * d), partial), k, v
        if kv is not None and sp is not None:
            raise NotImplementedError(
                "a decode step over an sp group (a KV cache split over sp): "
                "not ported to PyTorch yet (ROADMAP A9)")
        k, v = k.reshape(b, s, h * d), v.reshape(b, s, h * d)
        if kv is None:
            kr, vr = k, v
            if cfg.kv_cache_dtype == "int8":
                group = _tp_group(self.out_proj)
                (kq, ks), (vq, vs) = (quantize_kv(k, group),
                                      quantize_kv(v, group))
                kr = dequantize_kv(kq, ks, cfg.dtype)
                vr = dequantize_kv(vq, vs, cfg.dtype)
                k, v = (kq, ks[..., 0]), (vq, vs[..., 0])
            out = ulysses_attention(
                q, kr.view(b, s, h, d), vr.view(b, s, h, d), sp,
                functools.partial(masked_cache_attention, first_q_pos=0,
                                  scale=self.scale, window=self.window))
        else:
            ck, cv, ksc, vsc = kv
            writes = [(ck, k), (cv, v)]
            if ksc is not None:
                group = _tp_group(self.out_proj)
                (kq, ks), (vq, vs) = (quantize_kv(k, group),
                                      quantize_kv(v, group))
                writes = [(ck, kq), (cv, vq), (ksc, ks[..., 0]),
                          (vsc, vs[..., 0])]
            for cache, new in writes:
                if paged is None:
                    _kv_write(cache, new, cache_index)
                else:
                    _kv_write_paged(cache, new, paged.write_index)
            out = self._decode_attention(
                q, ck, cv, cache_index, decode_impl or cfg.decode_impl,
                None if paged is None else paged.tables, ksc, vsc)
        return self._project(out.reshape(b, s, h * d), partial), k, v

    def _project(self, out: torch.Tensor, partial: bool) -> torch.Tensor:
        if partial:
            return tp_partial(out, self.out_proj, self.cfg.dtype)
        return _linear(out, self.out_proj, self.cfg.dtype)

    def _decode_attention(self, q, ck, cv, cur, impl, block_tables=None,
                          k_scale=None, v_scale=None):
        b, s, h, d = q.shape
        if self.window is not None:
            if block_tables is not None:
                raise NotImplementedError(
                    "paged KV decode has no local-window path")
            impl = "einsum"
        if impl == "auto":      # the kernel, which raises on a shape it lacks
            if block_tables is None:
                return decode_attention(q.contiguous(), ck, cv, cur + s,
                                        scale=self.scale, k_scale=k_scale,
                                        v_scale=v_scale)
            return paged_decode_attention(q.contiguous(), ck, cv,
                                          block_tables, cur + s,
                                          scale=self.scale, k_scale=k_scale,
                                          v_scale=v_scale)
        if block_tables is not None:    # the TPU package's gather path
            ck = paged_gather_kv(ck, block_tables)
            cv = paged_gather_kv(cv, block_tables)
            if k_scale is not None:
                k_scale = paged_gather_kv(k_scale, block_tables)
                v_scale = paged_gather_kv(v_scale, block_tables)
            cur = cur.clamp(max=ck.shape[1] - s)
        if k_scale is not None:
            ck = dequantize_kv(ck, k_scale[..., None], self.cfg.dtype)
            cv = dequantize_kv(cv, v_scale[..., None], self.cfg.dtype)
        S = ck.shape[1]
        return masked_cache_attention(q, ck.view(b, S, h, d),
                                      cv.view(b, S, h, d), cur, self.scale,
                                      window=self.window)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.up_proj = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.down_proj = nn.Linear(cfg.d_ff, cfg.d_model, **kw)

    def forward(self, x, partial: bool = False):
        """``partial``: under tp, the down projection's partial product,
        unreduced and without its bias (the caller reduces it)."""
        dt = self.cfg.dtype
        h = F.gelu(_linear(x, self.up_proj, dt), approximate="tanh")
        if partial:
            return tp_partial(h, self.down_proj, dt)
        return _linear(h, self.down_proj, dt)


class Block(nn.Module):
    """One transformer block: the MLP is ``mlp``, or under ``cfg.moe`` the
    MoE layer ``moe``."""

    def __init__(self, cfg: GPTConfig, device=None,
                 window: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        kw = dict(eps=cfg.layer_norm_eps, dtype=cfg.param_dtype,
                  device=device)
        self.ln_1 = nn.LayerNorm(cfg.d_model, **kw)
        self.ln_2 = nn.LayerNorm(cfg.d_model, **kw)
        self.attn = SelfAttention(cfg, device=device, window=window)
        if cfg.moe:
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.num_experts,
                           k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor,
                           eval_capacity_factor=cfg.moe_eval_capacity_factor,
                           min_capacity=cfg.moe_min_capacity,
                           use_residual=cfg.moe_use_residual,
                           dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                           device=device)
        else:
            self.mlp = MLP(cfg, device=device)

    def _ffn(self, h, deterministic, draws):
        """(ffn output, the MoE layer's l_aux or None)."""
        if not self.cfg.moe:
            return self.mlp(h), None
        out, l_aux, _ = self.moe(h, deterministic=deterministic, draws=draws)
        return out, l_aux

    def forward(self, x, positions, kv=None, cache_index=None,
                decode_impl=None, attention_impl=None, paged=None,
                deterministic=True, draws=None):
        """Returns (out, k, v, l_aux): l_aux is None for a dense block."""
        dt = self.cfg.dtype
        group = _tp_group(self.attn.out_proj)
        # a NeoX block split over tp reduces its two branches' partial
        # products together, once (Megatron's gpt_j_residual); in decode
        # under tp_overlap the attention's reduce runs under the MLP GEMM
        split = self.cfg.parallel_residual and group is not None \
            and not self.cfg.moe
        overlap = (split and self.cfg.tp_overlap and kv is not None
                   and overlap_supported(x, group))
        a, k, v = self.attn(_layer_norm(x, self.ln_1, dt), positions, kv,
                            cache_index, decode_impl, attention_impl, paged,
                            partial=split)
        if split:
            h = _layer_norm(x, self.ln_2, dt)
            b_attn = self.attn.out_proj.bias.to(dt)
            if overlap:
                pending = defer_attn_allreduce(a, group)
                f = self.mlp(h)
                out = x + (pending.wait() + b_attn + f)
            else:
                f = self.mlp(h, partial=True)
                out = x + (reduce_from_tp(a + f, group)
                           + (b_attn + self.mlp.down_proj.bias.to(dt)))
            return out, k, v, None
        if self.cfg.parallel_residual:
            # NeoX: x + attn(ln1(x)) + ffn(ln2(x))
            f, aux = self._ffn(_layer_norm(x, self.ln_2, dt), deterministic,
                               draws)
            out = x + a + f
        else:
            hdn = x + a
            f, aux = self._ffn(_layer_norm(hdn, self.ln_2, dt), deterministic,
                               draws)
            out = hdn + f
        return out, k, v, aux


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
            Block(cfg, device=device, window=cfg.window(i))
            for i in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False,
                                     **kw)
        self.sp_group = None
        self.init_weights()

    def flax_leaves(self):
        """Parameter name -> the TPU GPT's leaf that ``zero.abstract_init``'s
        counter fill is defined over (``convert.gpt_flax_leaves``)."""
        from ..convert import gpt_flax_leaves
        return gpt_flax_leaves(self.cfg)

    def init_weights(self, generator: Optional[torch.Generator] = None,
                     std: float = 0.02) -> None:
        """Random weights: matrices and embeddings ~ N(0, std), biases 0,
        LayerNorm scales 1."""
        init_weights(self, generator, std)

    def stacked_spec(self, loss_fn=None):
        """The prefix / block / suffix factoring the layer-streamed tier
        drives (``runtime/pipe/spmd.gpt_pipe_spec``)."""
        from ..runtime.pipe.spmd import gpt_pipe_spec
        return gpt_pipe_spec(self, loss_fn)

    @property
    def tp_group(self):
        """The tp group this model is split over (None: whole)."""
        return _tp_group(self.wte)

    @property
    def tp_size(self) -> int:
        group = self.tp_group
        return 1 if group is None else group.size

    @property
    def sp_size(self) -> int:
        return _sp_size(self.sp_group)

    def _positions(self, b: int, s: int, device) -> torch.Tensor:
        """Each row's positions [b, s]: ``0 .. s - 1``, or over an sp group
        this rank's chunk of the sequence, ``r * s + i``."""
        start = self.sp_group.rank * s if self.sp_size > 1 else 0
        return torch.arange(start, start + s, device=device)[None, :] \
            .expand(b, s)

    def _embed(self, input_ids, positions):
        return embed_tokens(self.cfg, self.wte, getattr(self, "wpe", None),
                            input_ids, positions)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Final-LayerNormed hidden states -> logits (tied: ``x @ wte.T``).
        Under tp the head is vocab-parallel and the logits are gathered:
        every rank returns them whole (a tied ``wte`` that auto-TP split by
        features reduces the partial logits of its features instead)."""
        head = self.wte if self.cfg.tie_embeddings else self.lm_head
        return vocab_logits(self.cfg, head, hidden)

    def prefill(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
        """Cacheless causal forward. Returns (hidden [B, P, D] after ln_f,
        keys and values [L, B, P, h*d]); under ``kv_cache_dtype="int8"``
        (hidden, int8 keys, int8 values, f32 key scales, f32 value scales
        [L, B, P]), the prompt having attended over the dequantized int8
        K/V. Over an sp group, ``input_ids`` and every output are this
        rank's chunk of the prompt positions."""
        b, s = input_ids.shape
        if positions is None:
            positions = self._positions(b, s, input_ids.device)
        x = self._embed(input_ids, positions)
        ks: List = []
        vs: List = []
        for blk in self.blocks:
            x, k, v, _ = blk(x, positions)
            ks.append(k)
            vs.append(v)
        x = _layer_norm(x, self.ln_f, self.cfg.dtype)
        if self.cfg.kv_cache_dtype == "int8":
            return (x, torch.stack([k for k, _ in ks]),
                    torch.stack([v for v, _ in vs]),
                    torch.stack([sc for _, sc in ks]),
                    torch.stack([sc for _, sc in vs]))
        return x, torch.stack(ks), torch.stack(vs)

    def gate_draws(self, num_tokens: int,
                   generator: torch.Generator) -> List:
        """Every MoE layer's training draws for a call of ``num_tokens``
        tokens on this rank, from ``generator``, layer by layer."""
        return [blk.moe.draws(generator, num_tokens) for blk in self.blocks]

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """The TPU ``GPT.__call__`` without a cache: logits [B, S, V], with
        attention through ``cfg.attention_impl``. Under ``cfg.remat`` (and
        with grad enabled) each block runs under non-reentrant
        ``torch.utils.checkpoint``, saving only what ``cfg.remat_policy``
        names; the rest, flash or sparse attention included, is recomputed
        in the backward. With ``cfg.cpu_checkpointing`` a block saves nothing
        on the device: its input waits in page-locked host memory
        (:func:`offloaded_checkpoint`). Under ``cfg.moe`` returns (logits,
        the weighted aux loss); ``deterministic=False`` is the training
        gate, with the draws of ``generator`` when one is given."""
        cfg = self.cfg
        b, s = input_ids.shape
        if positions is None:
            positions = self._positions(b, s, input_ids.device)
        x = self._embed(input_ids, positions)
        draws = [None] * cfg.num_layers
        if cfg.moe and not deterministic and generator is not None:
            draws = self.gate_draws(b * s, generator)
        run = functools.partial(_block_output, impl=cfg.attention_impl,
                                deterministic=deterministic)
        remat = cfg.remat and torch.is_grad_enabled()
        offload = HostCheckpoints(x.device) if (
            remat and cfg.cpu_checkpointing) else None
        part = (self.tp_group if remat and offload is None
                and cfg.partition_activations else None)
        if part is not None and not partitionable(x, part):
            part = None
        aux = []
        for blk, d in zip(self.blocks, draws):
            if part is not None:
                x = partitioned_checkpoint(part, functools.partial(
                    run, blk, positions=positions, draws=d), x)
            elif offload is not None:
                x = offloaded_checkpoint(
                    offload, functools.partial(run, blk, positions=positions),
                    x)
            elif remat:
                x = torch_checkpoint.checkpoint(
                    run, blk, x, positions, d, use_reentrant=False,
                    context_fn=_remat_context(cfg.remat_policy))
            else:
                x = run(blk, x, positions, d)
            if cfg.moe:
                x, a = x
                aux.append(a)
        logits = self.logits(_layer_norm(x, self.ln_f, cfg.dtype))
        if cfg.moe:
            return logits, cfg.moe_aux_loss_coef * torch.stack(aux).sum()
        return logits

    def decode(self, input_ids: torch.Tensor, positions: torch.Tensor,
               cache_k: torch.Tensor, cache_v: torch.Tensor,
               cache_index: torch.Tensor,
               decode_impl: Optional[str] = None,
               block_tables: Optional[torch.Tensor] = None,
               k_scale: Optional[torch.Tensor] = None,
               v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``s`` tokens per row against the cache. input_ids/positions
        [B, s]; cache_k/cache_v the dense arena [L, B, S, h*d] or, with
        ``block_tables`` [B, T] int32, the paged pools [L, nb + 1, bs,
        h*d] (block nb the sink, T*bs = S); written in place at
        ``cache_index`` [B] (>= S drops the write). Under
        ``kv_cache_dtype="int8"`` the caches are int8 and ``k_scale`` /
        ``v_scale`` their f32 scales, [L, B, S] or [L, nb + 1, bs].
        ``decode_impl`` overrides ``cfg.decode_impl`` (the serving engine's
        megakernel switch). Returns logits [B, s, V]."""
        if (k_scale is not None) != (self.cfg.kv_cache_dtype == "int8"):
            raise ValueError(
                f"kv_cache_dtype={self.cfg.kv_cache_dtype!r} with "
                f"k_scale={'given' if k_scale is not None else None}: the "
                f"int8 cache needs its scales, and only it takes them")
        paged = None
        if block_tables is not None:       # one write index for all layers
            paged = PagedStep(block_tables, paged_write_index(
                block_tables, cache_index, input_ids.shape[1],
                cache_k.shape[2], cache_k.shape[1] - 1))
        x = self._embed(input_ids, positions)
        for layer, blk in enumerate(self.blocks):
            kv = (cache_k[layer], cache_v[layer],
                  None if k_scale is None else k_scale[layer],
                  None if v_scale is None else v_scale[layer])
            x, _, _, _ = blk(x, positions, kv, cache_index, decode_impl,
                             paged=paged)
        return self.logits(_layer_norm(x, self.ln_f, self.cfg.dtype))


def _block_output(blk: Block, x, positions, draws=None, *, impl: str,
                  deterministic: bool = True):
    """A block's output in the training forward: x, or (x, l_aux) for an
    MoE block."""
    out, _, _, aux = blk(x, positions, attention_impl=impl,
                         deterministic=deterministic, draws=draws)
    return out if aux is None else (out, aux)


def _remat_context(policy: str):
    """``context_fn`` of ``torch.utils.checkpoint`` for a remat policy."""
    saved = _REMAT_SAVE[policy]
    if not saved:
        return torch_checkpoint.noop_context_fn
    return functools.partial(
        torch_checkpoint.create_selective_checkpoint_contexts, list(saved))


def lm_loss_fn(logits, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross entropy. ``batch``: {input_ids, labels?,
    loss_mask?}; labels default to the shifted input_ids. nll is the f32
    logsumexp minus the gathered label logit (no [B, S, V] log-softmax), as
    in the TPU package. A ``(logits, moe_aux_loss)`` model output adds the
    aux loss."""
    aux = None
    if isinstance(logits, tuple):
        logits, aux = logits
    loss = _nll_mean(logits, batch)
    return loss if aux is None else loss + aux


def _nll_mean(logits: torch.Tensor,
              batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
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


# --------------------------------------------------------------------------
# Tensor parallelism
# --------------------------------------------------------------------------

_TP_AND_SP = ("a model split over both tp and sp: not ported to PyTorch yet "
              "(ROADMAP A9)")


def _check_tp(cfg: GPTConfig, tp: int, sp: int = 1) -> None:
    if sp > 1:
        raise NotImplementedError(_TP_AND_SP)
    if cfg.moe:
        raise NotImplementedError(
            "an MoE model at tp > 1: not ported to PyTorch yet (ROADMAP A9)")
    if cfg.num_heads % tp:
        raise ValueError(f"tp={tp} does not divide num_heads="
                         f"{cfg.num_heads}: a rank runs whole heads")


def set_tensor_parallel(model: "GPT", group) -> "GPT":
    """Split the whole ``model`` over the tp ``group`` in place: each Linear
    and the token embedding keep this rank's shard by the TPU package's
    ``tp_spec`` (``module_inject.layers.shard_by_tp_spec``: q, k and v by
    heads, column Linears by output features, row ones by input features,
    ``wte`` and ``lm_head`` by vocab rows). int8 weights must already be
    quantized whole (``ops.quantizer.quantize_module``). A one-rank group
    changes nothing. Returns ``model``."""
    if group is None or group.size == 1:
        return model
    _check_tp(model.cfg, group.size, model.sp_size)
    if model.tp_size != 1:
        raise ValueError(f"the model is split over tp={model.tp_size} "
                         f"already")
    return shard_by_tp_spec(model, group)


@torch.no_grad()
def init_tp_shards(model: "GPT", group, seed: int, device,
                   std: float = 0.02) -> "GPT":
    """Give ``model`` (built on the meta device) random weights on
    ``device`` without ever holding it whole: module by module, the whole
    module's weights are drawn on ``device`` from a generator seeded with
    ``seed`` and the module's name (``init_weights``' rule: matrices and
    embeddings ~ N(0, std), biases 0, LayerNorm scales 1), then this rank
    keeps its tp shard (:func:`set_tensor_parallel`'s rule). Every rank
    draws the same whole modules, so the shards are slices of one model,
    the one ``group=None`` builds whole. Returns ``model``."""
    tp = 1 if group is None else group.size
    if tp > 1:
        _check_tp(model.cfg, tp)
    device = torch.device(device)
    # by name: a module split below is dropped (and its whole weights with
    # it) before the next one is drawn
    for name in [n for n, _ in model.named_modules()]:
        module = model.get_submodule(name)
        own = dict(module.named_parameters(recurse=False))
        if not own:
            continue
        gen = torch.Generator(device=device).manual_seed(
            (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % 2 ** 63)
        for pname, p in own.items():
            full = torch.empty(p.shape, dtype=p.dtype, device=device)
            qual = f"{name}.{pname}" if name else pname
            if pname.endswith("bias"):
                full.zero_()
            elif ".ln_" in qual or qual.startswith("ln_"):
                full.fill_(1.0)
            else:
                full.normal_(0.0, std, generator=gen)
            setattr(module, pname, nn.Parameter(full))
        full = p = None
        if tp > 1 and tp_kind(name, module, tp) is not None:
            shard_module_(model, name, module, group)
        del module, own
    return model


# --------------------------------------------------------------------------
# Sequence parallelism
# --------------------------------------------------------------------------

def set_sequence_parallel(model: "GPT", group) -> "GPT":
    """Split ``model``'s sequence over the sp ``group``: the parameters stay
    whole on every rank, each rank's forward takes its ``S / sp`` columns
    of every row (positions ``r * S / sp + i``) and attention exchanges
    over ``group`` (``cfg.cp_impl``). Needs ``cfg.sequence_parallel``; a
    one-rank group (or None) changes nothing. Returns ``model``."""
    if _sp_size(group) == 1:
        return model
    if not model.cfg.sequence_parallel:
        raise ValueError(
            f"mesh sp={group.size} needs a GPTConfig with "
            f"sequence_parallel=True (and cp_impl 'ulysses' or 'ring')")
    if model.tp_size > 1:
        raise NotImplementedError(_TP_AND_SP)
    model.sp_group = group
    for blk in model.blocks:
        blk.attn.sp_group = group
    return model
