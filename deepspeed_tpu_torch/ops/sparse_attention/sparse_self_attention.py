"""Block-sparse self attention: the layout compiler and the entry point.

Counterpart of the host half of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``
(``_CompiledLayout`` and ``sparse_attention``). The TPU package compiles the
layout at its Pallas tile (``_kernel_block``, up to 128 rows) and expands the
fine mask inside the kernel; here :class:`CompiledLayout` compiles it at the
CUDA kernels' 64-row tile and packs the fine blocks of each live tile pair
into a 64-bit mask (``ops/cuda/sparse_attention.py`` and
``csrc/sparse_attention.cu`` read it):

  * block 64 (``bench.py``'s long-context case): one layout block is one
    tile; the mask is one bit;
  * block 8, 16 or 32: a tile holds (64 / block)^2 fine blocks, one bit
    each (S need not be a multiple of 64: the last tile is padded);
  * block 128 or more: a block spans (block / 64)^2 tiles.

A causal layout is tril-ified at block (and tile) granularity, and the
kernels add the exact elementwise causal mask. Compiled layouts are cached
on the config per ``(seq_len, causal)`` as the TPU package does, and their
tensors per device, so a step makes no host-to-device copy for the layout.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..cuda.sparse_attention import TILE, SparseAttention, TileLayout
from .sparsity_config import SparsityConfig


DKV_CHUNK = 32        # column-LUT entries per item of the dk/dv kernel


def _dkv_items(cnt_q: np.ndarray):
    """The dk/dv kernel's work items [n, 7] (head, key tile, first and end
    column-LUT entry, the key tile's first workspace partial or -1, the
    item's rank among the tile's items, the tile's item count): a key tile
    whose LUT row is longer than ``DKV_CHUNK`` is split over several items,
    each writing its own partial; the longest items come first. Returns
    (items, partials)."""
    items, parts = [], 0
    for h, kt in np.ndindex(*cnt_q.shape):
        n = int(cnt_q[h, kt])
        if n <= DKV_CHUNK:
            items.append((h, kt, 0, n, -1, 0, 1))
            continue
        chunks = -(-n // DKV_CHUNK)
        items += [(h, kt, c * DKV_CHUNK, min(n, (c + 1) * DKV_CHUNK), parts,
                   c, chunks) for c in range(chunks)]
        parts += chunks
    items = np.asarray(items, np.int32)
    return items[np.argsort(items[:, 2] - items[:, 3], kind="stable")], parts


def _dq_items(cnt_k: np.ndarray) -> np.ndarray:
    """The row-LUT work list [n, 2] (head, query tile) that the forward and
    the dq kernel walk: every (head, query tile) once, the longest row-LUT
    rows first (ties in (head, tile) order), so the persistent kernels'
    last rounds are their shortest."""
    h, qt = np.divmod(np.argsort(-cnt_k.reshape(-1), kind="stable"),
                      cnt_k.shape[1])
    return np.stack([h, qt], 1).astype(np.int32)


def _build_lut(coarse: np.ndarray, bits: np.ndarray):
    """Per row of ``coarse`` [H, n, m] (bool), the live columns in order,
    their masks from ``bits`` [H, n, m], and the counts."""
    counts = coarse.sum(-1).astype(np.int32)
    length = max(int(counts.max()), 1)
    order = np.argsort(~coarse, axis=-1, kind="stable")[..., :length]
    valid = np.arange(length) < counts[..., None]
    lut = np.where(valid, order, 0).astype(np.int32)
    masks = np.where(valid, np.take_along_axis(bits, order, -1),
                     np.uint64(0))
    return lut, counts, masks.view(np.int64)


class CompiledLayout:
    """The look-up tables of one (layout, seq_len, causal): a row LUT of
    live key tiles per (head, query tile) for the forward and dq, a column
    LUT of live query tiles per (head, key tile) for dk/dv, the fine-block
    mask of every live tile pair, the backward kernels' work lists (dq:
    query tiles longest first; dk/dv: runs of at most ``DKV_CHUNK``
    column-LUT entries, longest first), and the list of live pairs for the
    plain versions. Host arrays; :meth:`on` gives the tensors on a
    device."""

    def __init__(self, fine: np.ndarray, block: int, seq_len: int,
                 causal: bool):
        if block < 8 or block & (block - 1):
            raise ValueError(f"the sparse kernels take a layout block that "
                             f"is a power of two >= 8; got {block}")
        h, nb, _ = fine.shape
        fine = fine.astype(bool)
        if causal:
            fine = fine & np.tril(np.ones((nb, nb), bool))
        nt = -(-seq_len // TILE)
        if block >= TILE:
            rep = block // TILE
            coarse = fine.repeat(rep, 1).repeat(rep, 2)
            bits = coarse.astype(np.uint64)
        else:
            per = TILE // block
            pad = nt * per - nb
            f = np.pad(fine, ((0, 0), (0, pad), (0, pad)))
            cells = (f.reshape(h, nt, per, nt, per).transpose(0, 1, 3, 2, 4)
                     .reshape(h, nt, nt, per * per))
            weights = np.left_shift(np.uint64(1),
                                    np.arange(per * per, dtype=np.uint64))
            bits = (cells.astype(np.uint64) * weights).sum(-1,
                                                           dtype=np.uint64)
            coarse = cells.any(-1)
        if causal:                 # tiles above the diagonal see nothing
            coarse = coarse & np.tril(np.ones((nt, nt), bool))
        self.seq_len, self.causal, self.num_heads = seq_len, causal, h
        self.shift = int(math.log2(min(block, TILE)))
        self.lut_k, self.cnt_k, self.bits_k = _build_lut(coarse, bits)
        self.lut_q, self.cnt_q, self.bits_q = _build_lut(
            coarse.transpose(0, 2, 1), bits.transpose(0, 2, 1))
        self.dq_items = _dq_items(self.cnt_k)
        self.dkv_items, self.dkv_parts = _dkv_items(self.cnt_q)
        ph, pq, pk = np.nonzero(coarse)
        self.pairs = (ph.astype(np.int64), pq.astype(np.int64),
                      pk.astype(np.int64), bits[ph, pq, pk].view(np.int64))
        self._on: Dict[str, TileLayout] = {}

    def on(self, device) -> TileLayout:
        """The kernels' tensors on ``device``, built on first use (the pair
        list stays on the host)."""
        key = str(torch.device(device))
        if key not in self._on:
            t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(
                device)                                     # noqa: E731
            self._on[key] = TileLayout(
                self.seq_len, self.causal, self.shift,
                t(self.lut_k), t(self.cnt_k), t(self.bits_k),
                t(self.lut_q), t(self.cnt_q), t(self.bits_q),
                t(self.dq_items), t(self.dkv_items), self.dkv_parts,
                self.pairs)
        return self._on[key]


def compiled_layout(sparsity_config: SparsityConfig, seq_len: int,
                    causal: bool) -> CompiledLayout:
    """The config's layout at ``seq_len``, compiled once and cached on the
    config per (seq_len, causal), as the TPU package caches its LUTs."""
    cache = getattr(sparsity_config, "_tile_layout_cache", None)
    if cache is None:
        cache = {}
        sparsity_config._tile_layout_cache = cache
    key = (seq_len, bool(causal))
    if key not in cache:
        fine = np.asarray(sparsity_config.make_layout(seq_len), np.int64)
        cache[key] = CompiledLayout(fine, sparsity_config.block, seq_len,
                                    bool(causal))
    return cache[key]


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sparsity_config: SparsityConfig,
                     sm_scale: Optional[float] = None,
                     causal: Optional[bool] = None,
                     key_padding_mask=None) -> torch.Tensor:
    """Block-sparse attention. q, k, v: [B, S, H, D] -> [B, S, H, D].

    ``causal=None`` derives causality from ``sparsity_config.attention``;
    pass ``causal=True`` for autoregressive use (exact elementwise masking,
    and the layout is tril-ified so dead tiles are skipped).

    ``key_padding_mask``: optional [B, S] (1 = attend, 0 = masked key), as
    BERT passes it after ``SparseAttentionUtils.pad_to_block_size``. Masked
    keys drop out inside the kernel tiles; a query whose visible keys are
    all masked (a pure-padding row) outputs zeros."""
    b, s, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if causal is None:
        causal = getattr(sparsity_config, "attention",
                         "bidirectional") == "unidirectional"
    layout = compiled_layout(sparsity_config, s, causal)
    if layout.num_heads != h:
        raise ValueError(f"sparsity layout has {layout.num_heads} heads, "
                         f"tensors have {h}")
    kvm = None
    if key_padding_mask is not None:
        kvm = torch.as_tensor(key_padding_mask, device=q.device).to(
            torch.float32).contiguous()
        if kvm.shape != (b, s):
            raise ValueError(f"key_padding_mask must be [B, S] = {(b, s)}, "
                             f"got {tuple(kvm.shape)}")
    return SparseAttention.apply(q, k, v, layout.on(q.device), scale, kvm)
