"""Block-sparse attention, forward and backward.

Counterpart of the kernels of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``: the Pallas
``_fwd_kernel`` (B5), ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (B5b) become
the CUDA kernels in ``csrc/sparse_attention.cu``: the bf16 / fp16 backward
as persistent wgmma kernels fed by TMA through an mbarrier ring (the
machinery of ``csrc/hopper.cuh``, shared with flash), the bf16 / fp16
forward on the mma.sync tile code of ``csrc/attention_tiles.cuh``, f32 on
CUDA cores; head dims 32, 64, 96, 128.

The layout arrives as a :class:`TileLayout`: the fine layout compiled at the
kernels' 64-row tile (``ops/sparse_attention/sparse_self_attention.py``
builds it once per (seq_len, causal) and keeps it on each device). It holds a
row LUT (live key tiles of each (head, query tile), for the forward and dq),
a column LUT (live query tiles of each (head, key tile), for dk/dv), for
each live tile pair a 64-bit mask of its live fine blocks, and the backward
kernels' work lists: the dq kernel's (head, query tile) pairs, longest LUT
rows first, and the dk/dv kernel's items (a long column-LUT row is split
over several items, each writing its f32 partial to its own slot of a
workspace the wrapper allocates; the partials are summed in a fixed order,
so dk and dv are bitwise reproducible from run to run). The list of
live tile pairs, which only the plain versions read, stays on the host.

Semantics are the TPU kernels': key j is visible to query i when its fine
block is live, (causal) j <= i and (with ``kvm``, an f32 ``[B, S]``
key-padding mask) ``kvm[b, j] > 0``. A query with no visible key (a dead
row) gets zeros and ``lse = -1e30``; the backward recomputes p only where
``lse > -1e30 / 2``, so dead rows and masked keys get exactly zero grads.

A CUDA tensor launches the kernels; a CPU tensor runs the plain versions
(:func:`sparse_attention_forward_reference`,
:func:`sparse_attention_backward_reference`). The plain versions gather the
live tiles through the layout's list of live tile pairs and take a masked
softmax over them, so their memory grows with the live pairs, O(S * live
tiles per row * 64), not O(S^2): they run at S = 32768 on the card, where
``chip_smoke.py`` holds the kernels against them. On a CUDA tensor a head
dim, dtype or layout the kernels lack raises; nothing gives way to an einsum.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from .flash_attention import _stride_array, _strided, attention_delta

NEG_INF = -1e30        # the TPU kernels' mask value
TILE = 64              # rows of the kernels' tiles (kRows in the sources)
_TICKET_LEVELS = 16    # a split tile's combine tree (kLevels in the source)

_KERNEL_HEAD_DIMS = (32, 64, 96, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def sparse_supported(d: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take this head dim and dtype."""
    return d in _KERNEL_HEAD_DIMS and dtype in _KERNEL_DTYPES


class TileLayout(NamedTuple):
    """A sparsity layout compiled at the 64-row tile, on one device.
    ``nt = ceil(S / 64)`` tiles per head; LUT rows are padded to the longest
    row (``L``, ``Lq``) and hold ``cnt`` live entries each."""
    seq_len: int
    causal: bool
    shift: int                 # log2(min(layout block, 64))
    lut_k: torch.Tensor        # int32 [H, nt, L]   live key tiles
    cnt_k: torch.Tensor        # int32 [H, nt]
    bits_k: torch.Tensor       # int64 [H, nt, L]   fine-block masks
    lut_q: torch.Tensor        # int32 [H, nt, Lq]  live query tiles
    cnt_q: torch.Tensor        # int32 [H, nt]
    bits_q: torch.Tensor       # int64 [H, nt, Lq]
    dq_items: torch.Tensor     # int32 [H * nt, 2]: the dq kernel's work
    #                            list (head, query tile), longest rows first
    dkv_items: torch.Tensor    # int32 [n, 7]: the dk/dv kernel's items
    dkv_parts: int             # workspace partials of the split key tiles
    pairs: tuple               # host int64 [P] x 4: head, query tile, key
    #                            tile and mask of every live tile pair, in
    #                            (head, query tile) order, for the plain
    #                            versions

    @property
    def num_tiles(self) -> int:
        return self.cnt_k.shape[1]


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _tiles(x: torch.Tensor, nt: int) -> torch.Tensor:
    """[B, S, H, D] -> f32 [B, H, nt, 64, D], zeros past S."""
    b, s, h, d = x.shape
    x = F.pad(x.float(), (0, 0, 0, 0, 0, nt * TILE - s))
    return x.view(b, nt, TILE, h, d).permute(0, 3, 1, 2, 4)


def _stat_tiles(x: torch.Tensor, nt: int, fill: float) -> torch.Tensor:
    """[B, H, S] -> [B, H, nt, 64], ``fill`` past S."""
    b, h, s = x.shape
    return F.pad(x.float(), (0, nt * TILE - s), value=fill).view(
        b, h, nt, TILE)


def _untile(x: torch.Tensor, b: int, h: int, s: int) -> torch.Tensor:
    """[B, H * nt, 64, D] -> [B, S, H, D]."""
    return x.view(b, h, -1, x.shape[-1])[:, :, :s].transpose(1, 2)


class _Pairs(NamedTuple):
    """The live tile pairs on the plain version's device."""
    h: torch.Tensor            # int64 [P]
    q: torch.Tensor
    k: torch.Tensor
    bits: torch.Tensor


def _pairs(layout: TileLayout, device) -> _Pairs:
    return _Pairs(*(torch.from_numpy(x).to(device) for x in layout.pairs))


def _pair_mask(layout: TileLayout, pairs: _Pairs,
               kvm: Optional[torch.Tensor], b: int) -> torch.Tensor:
    """[B or 1, P, 64, 64] bool: the visible (query, key) cells of each live
    tile pair -- fine block live, key < S, causal, key-padding mask."""
    r = torch.arange(TILE, device=pairs.bits.device)
    sh = layout.shift
    bit = (r[:, None] >> sh) * (TILE >> sh) + (r[None, :] >> sh)
    mask = ((pairs.bits[:, None, None] >> bit) & 1).bool()
    keys = pairs.k[:, None] * TILE + r                           # [P, 64]
    mask &= (keys < layout.seq_len)[:, None, :]
    if layout.causal:
        rows = pairs.q[:, None] * TILE + r
        mask &= rows[:, :, None] >= keys[:, None, :]
    mask = mask[None]
    if kvm is not None:
        kept = F.pad(kvm.float(), (0, layout.num_tiles * TILE
                                   - layout.seq_len)) > 0        # [B, nt*64]
        mask = mask & kept[:, keys][:, :, None, :]
    return mask.expand(b, *mask.shape[1:]) if mask.shape[0] == 1 else mask


def _gather(x: torch.Tensor, pairs: _Pairs, tiles: torch.Tensor
            ) -> torch.Tensor:
    """Tiled [B, H, nt, 64, ...] -> [B, P, 64, ...] at each pair's head and
    ``tiles``."""
    return x[:, pairs.h, tiles]


def sparse_attention_forward_reference(q, k, v, layout: TileLayout,
                                       scale: float,
                                       kvm: Optional[torch.Tensor] = None):
    """The plain forward: ``_fwd_kernel``'s equations (mask value -1e30,
    ``m_safe``, ``l_safe``, lse -1e30 on dead rows) over the live tile
    pairs. Returns (out [B, S, H, D] in q's dtype, lse [B, H, S] f32)."""
    b, s, h, d = q.shape
    nt = layout.num_tiles
    pairs = _pairs(layout, q.device)
    n = pairs.h.shape[0]
    qs = _gather(_tiles(q, nt), pairs, pairs.q)
    ks = _gather(_tiles(k, nt), pairs, pairs.k)
    vs = _gather(_tiles(v, nt), pairs, pairs.k)
    mask = _pair_mask(layout, pairs, kvm, b)
    sc = torch.einsum("bpid,bpjd->bpij", qs, ks) * scale
    sc = torch.where(mask, sc, NEG_INF)
    seg = pairs.h * nt + pairs.q                                 # [P]
    m = torch.full((b, h * nt, TILE), NEG_INF, device=q.device)
    m = m.scatter_reduce(1, seg[None, :, None].expand(b, n, TILE),
                         sc.amax(-1), "amax")
    dead = m <= NEG_INF / 2
    m_safe = torch.where(dead, 0.0, m)
    p = torch.where(mask, torch.exp(sc - m_safe[:, seg, :, None]), 0.0)
    l = torch.zeros_like(m).index_add_(1, seg, p.sum(-1))
    acc = torch.zeros(b, h * nt, TILE, d, device=q.device).index_add_(
        1, seg, torch.einsum("bpij,bpjd->bpid", p, vs))
    l_safe = torch.where(l == 0, 1.0, l)
    out = _untile(acc / l_safe[..., None], b, h, s)
    lse = torch.where(dead, NEG_INF, m + torch.log(l_safe))
    return out.to(q.dtype), lse.view(b, h, -1)[:, :, :s].contiguous()


def sparse_attention_backward_reference(q, k, v, out, lse, dout,
                                        layout: TileLayout, scale: float,
                                        kvm: Optional[torch.Tensor] = None):
    """The plain backward: the equations of ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel`` (dead-row guard ``lse > -1e30 / 2``) over the live
    tile pairs. Returns (dq, dk, dv) in the inputs' dtype."""
    b, s, h, d = q.shape
    nt = layout.num_tiles
    pairs = _pairs(layout, q.device)
    qs = _gather(_tiles(q, nt), pairs, pairs.q)
    dos = _gather(_tiles(dout, nt), pairs, pairs.q)
    ks = _gather(_tiles(k, nt), pairs, pairs.k)
    vs = _gather(_tiles(v, nt), pairs, pairs.k)
    lses = _gather(_stat_tiles(lse, nt, NEG_INF), pairs, pairs.q)
    dels = _gather(_stat_tiles(attention_delta(out, dout), nt, 0.0), pairs,
                   pairs.q)
    mask = (_pair_mask(layout, pairs, kvm, b)
            & (lses > NEG_INF / 2)[..., None])
    sc = torch.einsum("bpid,bpjd->bpij", qs, ks) * scale
    p = torch.where(mask, torch.exp(sc - lses[..., None]), 0.0)
    dp = torch.einsum("bpid,bpjd->bpij", dos, vs)
    ds = p * (dp - dels[..., None]) * scale
    seg_q = pairs.h * nt + pairs.q
    seg_k = pairs.h * nt + pairs.k

    def gather_sum(seg, x):
        return _untile(torch.zeros(b, h * nt, TILE, d, device=q.device)
                       .index_add_(1, seg, x), b, h, s)

    dq = gather_sum(seg_q, torch.einsum("bpij,bpjd->bpid", ds, ks))
    dk = gather_sum(seg_k, torch.einsum("bpij,bpid->bpjd", ds, qs))
    dv = gather_sum(seg_k, torch.einsum("bpij,bpid->bpjd", p, dos))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------

def _check(q, layout: TileLayout, kvm, *others) -> None:
    b, s, h, d = q.shape
    if not sparse_supported(d, q.dtype):
        raise ValueError(
            f"sparse kernels take d in {_KERNEL_HEAD_DIMS} and "
            f"f32/bf16/fp16; got d={d} {q.dtype}")
    for t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"q/k/v/dO must share shape, dtype and device: "
                f"{tuple(q.shape)} {q.dtype} {q.device} vs {tuple(t.shape)} "
                f"{t.dtype} {t.device}")
    if (layout.seq_len, layout.cnt_k.shape[0]) != (s, h) \
            or layout.cnt_k.device != q.device:
        raise ValueError(
            f"layout compiled for S={layout.seq_len}, H="
            f"{layout.cnt_k.shape[0]} on {layout.cnt_k.device}; tensors "
            f"have S={s}, H={h} on {q.device}")
    if kvm is not None and (kvm.shape != (b, s) or kvm.dtype != torch.float32
                            or not kvm.is_contiguous()
                            or kvm.device != q.device):
        raise ValueError(f"kvm must be a contiguous f32 [B, S] = {(b, s)} "
                         f"tensor on {q.device}")


def _lut_args(lut, cnt, bits, shift):
    return (lut.data_ptr(), cnt.data_ptr(), bits.data_ptr(), lut.shape[-1],
            shift)


def _tail(q, layout: TileLayout, kvm, scale):
    b, s, h, d = q.shape
    return (None if kvm is None else kvm.data_ptr(), b, s, h, d,
            int(layout.causal), float(scale), _KERNEL_DTYPES[q.dtype],
            _build.stream_of(q))


def sparse_attention_forward(q, k, v, layout: TileLayout, scale: float,
                             kvm: Optional[torch.Tensor] = None):
    """(out, lse): the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if q.device.type == "cpu":
        return sparse_attention_forward_reference(q, k, v, layout, scale, kvm)
    _check(q, layout, kvm, k, v)
    q, k, v = _strided(q), _strided(k), _strided(v)
    b, s, h, d = q.shape
    out = torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.dstorch_sparse_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _stride_array(q, k, v),
            *_lut_args(layout.lut_k, layout.cnt_k, layout.bits_k,
                       layout.shift), *_tail(q, layout, kvm, scale))
    _build.check(err, "sparse_fwd")
    _build.LAUNCHES["sparse_fwd"] += 1
    return out, lse


def sparse_attention_backward(q, k, v, out, lse, dout, layout: TileLayout,
                              scale: float,
                              kvm: Optional[torch.Tensor] = None):
    """(dq, dk, dv): the two kernels for a CUDA tensor, the plain version
    for a CPU tensor."""
    if q.device.type == "cpu":
        return sparse_attention_backward_reference(q, k, v, out, lse, dout,
                                                   layout, scale, kvm)
    _check(q, layout, kvm, k, v, dout)
    q, k, v, dout = _strided(q), _strided(k), _strided(v), _strided(dout)
    b, s, h, d = q.shape
    delta = attention_delta(out, dout)
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty(b, s, h, d, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    strides = _stride_array(q, k, v, dout)
    tail = _tail(q, layout, kvm, scale)
    ws = tickets = None
    if layout.dkv_parts:
        ws = torch.empty(b, layout.dkv_parts, 2, TILE, d, dtype=torch.float32,
                         device=q.device)
        tickets = torch.zeros(b, layout.dkv_parts, _TICKET_LEVELS,
                              dtype=torch.int32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.dstorch_sparse_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), strides,
            *_lut_args(layout.lut_k, layout.cnt_k, layout.bits_k,
                       layout.shift),
            layout.dq_items.data_ptr(), layout.dq_items.shape[0], *tail)
        _build.check(err, "sparse_bwd_dq")
        _build.LAUNCHES["sparse_bwd_dq"] += 1
        err = lib.dstorch_sparse_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            strides, *_lut_args(layout.lut_q, layout.cnt_q, layout.bits_q,
                                layout.shift),
            layout.dkv_items.data_ptr(), layout.dkv_items.shape[0],
            layout.dkv_parts, None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr(), *tail)
    _build.check(err, "sparse_bwd_dkv")
    _build.LAUNCHES["sparse_bwd_dkv"] += 1
    return dq, dk, dv


class SparseAttention(torch.autograd.Function):
    """Block-sparse ``out = softmax(q k^T * scale) v`` with the sparse
    forward and backward. Saves q, k, v, out and lse; the layout and the
    key-padding mask ride on ``ctx``. Re-entrant under
    ``torch.utils.checkpoint`` (a recomputed block runs the forward
    again)."""

    @staticmethod
    def forward(ctx, q, k, v, layout: TileLayout, scale: float,
                kvm: Optional[torch.Tensor]):
        out, lse = sparse_attention_forward(q, k, v, layout, scale, kvm)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.layout, ctx.scale, ctx.kvm = layout, scale, kvm
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = sparse_attention_backward(q, k, v, out, lse, dout,
                                               ctx.layout, ctx.scale, ctx.kvm)
        return dq, dk, dv, None, None, None
