"""Block-sparse attention layout configurations.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``,
kept as the port's own copy (numpy only; the port imports nothing of the JAX
package). The classes, their parameters, their validation and their random
draws are the same line for line, so a layout built here equals the JAX
package's bit for bit: ``SparsityConfig`` base, ``DenseSparsityConfig``,
``FixedSparsityConfig`` (Sparse Transformers, arXiv:1904.10509),
``VariableSparsityConfig``, ``BigBirdSparsityConfig`` (arXiv:2007.14062) and
``BSLongformerSparsityConfig`` (arXiv:2004.05150).

A layout is a ``[num_heads, num_blocks, num_blocks]`` 0/1 ndarray: entry
(h, i, j) says whether query block i attends to key block j for head h.
Layouts are built host-side in numpy (they are tiny and static per seq_len)
and compiled by ``sparse_self_attention.py`` into the look-up tables of live
64-row tiles that the CUDA kernels walk.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

# Deterministic seed for random-block layouts: every host must build the
# SAME layout or data-parallel replicas would compute different functions
# (the reference uses the unseeded global `random`, sparsity_config.py:6 —
# safe there only because torch broadcasts module buffers from rank 0).
LAYOUT_SEED = 0x5EED


def _check_attention_mode(attention: str) -> None:
    if attention not in ("unidirectional", "bidirectional"):
        raise ValueError(
            f"attention must be 'unidirectional' or 'bidirectional', "
            f"got {attention!r}")


def _check_global_ranges(starts: List[int], ends: Optional[List[int]]) -> None:
    """Validate paired [start, end) global-block ranges."""
    if ends is None:
        return
    if len(starts) != len(ends):
        raise ValueError(
            f"global_block_indices has {len(starts)} entries but "
            f"global_block_end_indices has {len(ends)} — they pair up "
            f"as [start, end) ranges")
    for s, e in zip(starts, ends):
        if s >= e:
            raise ValueError(
                f"empty global range: start {s} >= end {e}")



class SparsityConfig:
    """Base: block size + per-head layout bookkeeping (reference :9-61)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len={seq_len} is not a multiple of the layout block "
                f"size ({self.block}); pad the sequence first "
                f"(SparseAttentionUtils.pad_to_block_size)")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), np.int64)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    # -- shared pattern helpers (hoisted; the reference duplicates these
    # across config classes) ------------------------------------------------
    def _set_sliding_window(self, h: int, layout: np.ndarray,
                            num_window_blocks: int) -> np.ndarray:
        num_blocks = layout.shape[1]
        if num_blocks < num_window_blocks:
            raise ValueError(
                f"sliding window spans {num_window_blocks} blocks but the "
                f"sequence only has {num_blocks} blocks per row")
        w = num_window_blocks // 2
        for row in range(num_blocks):
            layout[h, row, max(0, row - w):min(row + w + 1, num_blocks)] = 1
        return layout

    def _set_random(self, h: int, layout: np.ndarray, num_random_blocks: int,
                    unidirectional: bool) -> np.ndarray:
        num_blocks = layout.shape[1]
        if num_blocks < num_random_blocks:
            raise ValueError(
                f"cannot place {num_random_blocks} random blocks in a row "
                f"of only {num_blocks} blocks")
        rng = np.random.default_rng(LAYOUT_SEED + h)
        for row in range(num_blocks):
            hi = row + 1 if unidirectional else num_blocks
            k = min(num_random_blocks, hi)
            cols = rng.choice(hi, size=k, replace=False)
            layout[h, row, cols] = 1
        return layout


class DenseSparsityConfig(SparsityConfig):
    """All blocks live — for comparison/debug (reference :64-93)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed local windows + periodic global blocks (reference :94-241)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks ({num_local_blocks}) must be a multiple "
                f"of num_global_blocks ({num_global_blocks}) so global "
                f"stripes tile the local windows evenly")
        self.num_global_blocks = num_global_blocks
        _check_attention_mode(attention)
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "horizontal_global_attention writes full rows and is only "
                "meaningful for attention='bidirectional'")
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "num_different_global_patterns > 1 requires "
                "different_layout_per_head=True (otherwise every head "
                "shares one layout and the variants are unreachable)")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"num_different_global_patterns="
                f"{num_different_global_patterns} exceeds the distinct "
                f"global-stripe offsets available per local window "
                f"({num_local_blocks // num_global_blocks})")
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h: int, layout: np.ndarray):
        num_blocks = layout.shape[1]
        for start in range(0, num_blocks, self.num_local_blocks):
            end = min(start + self.num_local_blocks, num_blocks)
            for row in range(start, end):
                hi = row + 1 if self.attention == "unidirectional" else end
                layout[h, row, start:hi] = 1
        return layout

    def set_global_layout(self, h: int, layout: np.ndarray):
        num_blocks = layout.shape[1]
        first_global = self.num_local_blocks - (
            1 + h % self.num_different_global_patterns) * self.num_global_blocks
        end = num_blocks - (num_blocks % self.num_local_blocks)
        for i in range(first_global, end, self.num_local_blocks):
            first_row = 0 if self.attention == "bidirectional" else i
            layout[h, first_row:, i:i + self.num_global_blocks] = 1
            if self.horizontal_global_attention:
                layout[h, i:i + self.num_global_blocks, :] = 1
        if end < num_blocks:  # short trailing window
            start = min(end + first_global, num_blocks - self.num_global_blocks)
            stop = start + self.num_global_blocks
            first_row = 0 if self.attention == "bidirectional" else start
            layout[h, first_row:, start:stop] = 1
            if self.horizontal_global_attention:
                layout[h, start:stop, :] = 1
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable local windows + explicit global indices + random blocks
    (reference :243-419)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        _check_global_ranges(self.global_block_indices,
                             global_block_end_indices)
        self.global_block_end_indices = global_block_end_indices
        _check_attention_mode(attention)
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "horizontal_global_attention writes full rows and is only "
                "meaningful for attention='bidirectional'")
        self.horizontal_global_attention = horizontal_global_attention

    def set_random_layout(self, h: int, layout: np.ndarray):
        return self._set_random(h, layout, self.num_random_blocks,
                                unidirectional=False)

    def set_local_layout(self, h: int, layout: np.ndarray):
        num_blocks = layout.shape[1]
        start = 0
        end = 0
        block_size = self.local_window_blocks[-1]
        for block_size in self.local_window_blocks:
            end = min(end + block_size, num_blocks)
            for row in range(start, end):
                hi = row + 1 if self.attention == "unidirectional" else end
                layout[h, row, start:hi] = 1
            start += block_size
        for i in range(start, num_blocks, block_size):
            end = min(i + block_size, num_blocks)
            for row in range(i, end):
                hi = row + 1 if self.attention == "unidirectional" else end
                layout[h, row, i:hi] = 1
        return layout

    def set_global_layout(self, h: int, layout: np.ndarray):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            for idx in self.global_block_indices:
                if idx < num_blocks:
                    if self.horizontal_global_attention:
                        layout[h, idx, :] = 1
                    first_row = 0 if self.attention == "bidirectional" else idx
                    layout[h, first_row:, idx] = 1
        else:
            for start_idx, end_idx in zip(self.global_block_indices,
                                          self.global_block_end_indices):
                if start_idx < num_blocks:
                    end_idx = min(end_idx, num_blocks)
                    if self.horizontal_global_attention:
                        layout[h, start_idx:end_idx, :] = 1
                    first_row = 0 if self.attention == "bidirectional" else start_idx
                    layout[h, first_row:, start_idx:end_idx] = 1
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding window + global blocks (reference :421-556)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        _check_attention_mode(attention)
        self.attention = attention

    def set_random_layout(self, h: int, layout: np.ndarray):
        return self._set_random(
            h, layout, self.num_random_blocks,
            unidirectional=(self.attention == "unidirectional"))

    def set_sliding_window_layout(self, h: int, layout: np.ndarray):
        return self._set_sliding_window(h, layout,
                                        self.num_sliding_window_blocks)

    def set_global_layout_itc(self, h: int, layout: np.ndarray):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_global_blocks:
            raise ValueError(
                f"num_global_blocks ({self.num_global_blocks}) exceeds the "
                f"{num_blocks} blocks in a row")
        layout[h, 0:self.num_global_blocks, :] = 1
        layout[h, :, 0:self.num_global_blocks] = 1
        if self.attention == "unidirectional":
            layout[h] = np.tril(layout[h])
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout_itc(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + explicit global indices
    (reference :559-683)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        _check_attention_mode(attention)
        self.attention = attention
        _check_global_ranges(self.global_block_indices,
                             global_block_end_indices)
        self.global_block_end_indices = global_block_end_indices

    def set_sliding_window_layout(self, h: int, layout: np.ndarray):
        return self._set_sliding_window(h, layout,
                                        self.num_sliding_window_blocks)

    def set_global_layout(self, h: int, layout: np.ndarray):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            for idx in self.global_block_indices:
                if idx < num_blocks:
                    layout[h, idx, :] = 1
                    layout[h, :, idx] = 1
        else:
            for start_idx, end_idx in zip(self.global_block_indices,
                                          self.global_block_end_indices):
                if start_idx < num_blocks:
                    end_idx = min(end_idx, num_blocks)
                    layout[h, start_idx:end_idx, :] = 1
                    layout[h, :, start_idx:end_idx] = 1
        if self.attention == "unidirectional":
            layout[h] = np.tril(layout[h])
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)
