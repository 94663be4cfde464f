"""Standalone block-sparse matmul: SDD / DSD / DDS.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/matmul.py`` (reference
``deepspeed/ops/sparse_attention/matmul.py:214-995``, the triton ``MatMul``
usable outside attention). The TPU op is XLA code, not a Pallas kernel: the
nonzero block coordinates come from the static layout at construction, the
work is one batched ``[nnz, block, block]`` product over the gathered
blocks, and DSD / DDS sum the products of each output row block with a
segment-sum over static row ids. This port does the same in torch ops:
blocks gathered by index, one ``torch.matmul`` over ``[B, nnz, ., .]``,
``index_add_`` over the row ids.

Sparse operands travel in the packed value layout ``[batch, nnz, block,
block]``, ``nnz`` enumerating the layout's nonzero (head, row, col) blocks
in ``np.nonzero`` order (row-major per head), as the JAX op and the
reference's triton kernels lay them out.
"""

from __future__ import annotations

import numpy as np
import torch


class MatMul:
    """Block-sparse matmul over a static block ``layout``.

    layout: [H, M_blocks, N_blocks] 0/1 (numpy or array-like; static).
    block:  square block size.
    mode:   'sdd' -- dense @ dense -> sparse (packed [B, nnz, blk, blk])
            'dsd' -- sparse @ dense -> dense
            'dds' -- dense @ sparse -> dense
    trans_a / trans_b transpose the last two dims of the respective
    operand before the multiply (the dense side only: a transposed packed
    operand raises at construction).

    Dense operands are [B, H, R, C]; a batch whose H is 1 broadcasts over
    the layout's H.
    """

    def __init__(self, layout, block: int, mode: str,
                 trans_a: bool = False, trans_b: bool = False):
        if mode not in ("sdd", "dsd", "dds"):
            raise ValueError(f"mode must be sdd/dsd/dds, got {mode!r}")
        layout = np.asarray(layout)
        if layout.ndim != 3:
            raise ValueError(f"layout must be [H, M_blocks, N_blocks]; "
                             f"got shape {layout.shape}")
        if (mode == "dsd" and trans_a) or (mode == "dds" and trans_b):
            raise NotImplementedError(
                "transposing the PACKED sparse operand needs a transposed "
                "layout (blocks move (i,j)->(j,i)), not just per-block "
                "transposes -- construct a MatMul over layout.transpose("
                "0, 2, 1) with swapped operand roles instead")
        if block < 1:
            raise ValueError("block must be positive")
        self.layout = layout != 0
        self.block = int(block)
        self.mode = mode
        self.trans_a = trans_a
        self.trans_b = trans_b
        h, i, j = np.nonzero(self.layout)
        if h.size == 0:
            raise ValueError("layout has no nonzero blocks")
        self.nnz = int(h.size)
        self._heads, self._mblocks, self._nblocks = (
            int(n) for n in self.layout.shape)
        self._h, self._i, self._j = (torch.from_numpy(a.astype(np.int64))
                                     for a in (h, i, j))
        self._idx = {}

    def _index(self, name: str, device) -> torch.Tensor:
        """The static index ``name`` on ``device`` (copied once)."""
        key = (name, str(device))
        if key not in self._idx:
            self._idx[key] = getattr(self, name).to(device)
        return self._idx[key]

    # ------------------------------------------------------------- helpers
    def _dense_blocks(self, x: torch.Tensor, rows: str, n_blocks: int,
                      what: str) -> torch.Tensor:
        """[B, H, R, C] -> per-nnz row blocks [B, nnz, block, C]. The row
        dim is checked against the layout (an index past it would raise on
        the card as a device assert, not as this error)."""
        b, hh, r, c = x.shape
        blk = self.block
        if r != n_blocks * blk:
            raise ValueError(
                f"{what}: dense operand dim {r} does not match the "
                f"layout's {n_blocks} blocks of {blk} "
                f"(= {n_blocks * blk}); check operand orientation")
        if hh not in (1, self._heads):
            raise ValueError(f"{what}: operand has {hh} heads, layout has "
                             f"{self._heads}")
        xb = x.reshape(b, hh, n_blocks, blk, c)
        rows_t = self._index(rows, x.device)
        heads = (torch.zeros_like(rows_t) if hh == 1
                 else self._index("_h", x.device))
        return xb[:, heads, rows_t]                  # [B, nnz, blk, C]

    @staticmethod
    def _t(x: torch.Tensor, do: bool) -> torch.Tensor:
        return x.transpose(-1, -2) if do else x

    def _segment_sum(self, prod: torch.Tensor, rows: str,
                     n_blocks: int) -> torch.Tensor:
        """[B, nnz, X, Y] -> [B, H * n_blocks, X, Y]: the products summed
        into their (head, row block) segment, in f32 for 16-bit products
        (rounded once, to their dtype, at the end)."""
        seg = (self._index("_h", prod.device) * n_blocks
               + self._index(rows, prod.device))
        acc = torch.float32 if prod.element_size() < 4 else prod.dtype
        out = prod.new_zeros((prod.shape[0], self._heads * n_blocks)
                             + tuple(prod.shape[2:]), dtype=acc)
        return out.index_add_(1, seg, prod.to(acc)).to(prod.dtype)

    # ---------------------------------------------------------------- call
    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        blk, mode = self.block, self.mode
        if mode == "sdd":
            A = self._t(a, self.trans_a)
            B = self._t(b, self.trans_b)
            if A.shape[-2] != self._mblocks * blk \
                    or B.shape[-1] != self._nblocks * blk:
                raise ValueError(
                    f"sdd: operands {tuple(A.shape)} x {tuple(B.shape)} do "
                    f"not match layout [{self._mblocks}x{self._nblocks}] "
                    f"blocks of {blk}")
            ab = self._dense_blocks(A, "_i", self._mblocks, "sdd lhs")
            bb = self._dense_blocks(B.transpose(-1, -2), "_j",
                                    self._nblocks, "sdd rhs")
            return torch.matmul(ab, bb.transpose(-1, -2))

        if mode == "dsd":
            # packed a [B, nnz, blk, blk] @ dense b [B, H, K, N]
            B = self._t(b, self.trans_b)
            if a.shape[1] != self.nnz:
                raise ValueError(
                    f"dsd: packed operand has {a.shape[1]} blocks, layout "
                    f"has {self.nnz}")
            bb = self._dense_blocks(B, "_j", self._nblocks, "dsd rhs")
            out = self._segment_sum(torch.matmul(a, bb), "_i",
                                    self._mblocks)     # [B, H*Mb, blk, N]
            bsz, _, _, n = out.shape
            return out.reshape(bsz, self._heads, self._mblocks * blk, n)

        # dds: dense a [B, H, M, K] @ packed b [B, nnz, blk, blk]
        A = self._t(a, self.trans_a)
        if b.shape[1] != self.nnz:
            raise ValueError(
                f"dds: packed operand has {b.shape[1]} blocks, layout has "
                f"{self.nnz}")
        ab = self._dense_blocks(A.transpose(-1, -2), "_i", self._mblocks,
                                "dds lhs")             # [B, nnz, blk, M]
        prod = torch.matmul(ab.transpose(-1, -2), b)   # [B, nnz, M, blk]
        out = self._segment_sum(prod, "_j", self._nblocks)
        bsz, _, m, _ = out.shape
        out = out.reshape(bsz, self._heads, self._nblocks, m, blk)
        return out.transpose(2, 3).reshape(bsz, self._heads, m,
                                           self._nblocks * blk)

    # ------------------------------------------------------------ packing
    def pack(self, dense: torch.Tensor) -> torch.Tensor:
        """Dense [B, H, M, N] -> packed [B, nnz, blk, blk] (layout order)."""
        blk = self.block
        bsz, hh, m, n = dense.shape
        if m != self._mblocks * blk or n != self._nblocks * blk:
            raise ValueError(
                f"pack: dense [{m}x{n}] does not match layout "
                f"[{self._mblocks}x{self._nblocks}] blocks of {blk}")
        if hh not in (1, self._heads):
            raise ValueError(f"pack: operand has {hh} heads, layout has "
                             f"{self._heads}")
        xb = dense.reshape(bsz, hh, m // blk, blk, n // blk, blk)
        xb = xb.movedim(4, 3)          # [B, H, Mb, Nb, blk, blk]
        dev = dense.device
        rows = self._index("_i", dev)
        heads = (torch.zeros_like(rows) if hh == 1
                 else self._index("_h", dev))
        return xb[:, heads, rows, self._index("_j", dev)]

    def unpack(self, packed: torch.Tensor, dtype=None) -> torch.Tensor:
        """Packed [B, nnz, blk, blk] -> dense [B, H, M, N] with zeros in
        the empty blocks."""
        blk = self.block
        bsz, dev = packed.shape[0], packed.device
        out = torch.zeros((bsz, self._heads, self._mblocks, self._nblocks,
                           blk, blk),
                          dtype=packed.dtype if dtype is None else dtype,
                          device=dev)
        out[:, self._index("_h", dev), self._index("_i", dev),
            self._index("_j", dev)] = packed.to(out.dtype)
        return out.movedim(3, 4).reshape(bsz, self._heads,
                                         self._mblocks * blk,
                                         self._nblocks * blk)
