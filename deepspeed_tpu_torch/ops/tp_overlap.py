"""Overlapping the post-attention tp collective with the MLP GEMM.

Counterpart of ``deepspeed_tpu/ops/tp_overlap.py``. In a decode step of a
parallel-residual block (``x + attn(ln1 x) + ffn(ln2 x)``, NeoX) the MLP
reads ``ln2(x)`` and does not wait for the attention branch, so the
attention's tp reduce can run under the MLP GEMM. The TPU package pins the
attention output hidden-sharded and lets GSPMD split its psum into a
reduce-scatter and an all-gather around the GEMM; here the split is
written out:

  * :func:`defer_attn_allreduce` starts the reduce-scatter of the attention
    branch's partial product over the hidden dim (``async_op=True``) and
    returns a handle; the caller runs the MLP, then ``handle.wait()``
    all-gathers the summed pieces (the all-reduce's result: at tp 2 one
    two-term add an element either way, so the tokens stay bitwise those of
    the plain all-reduce). Only where :func:`overlap_supported`: a [B, S,
    D] tensor, a tp group of more than one rank and D divisible by it;
    otherwise the handle holds the plain all-reduce;
  * :func:`ring_allreduce`: the all-reduce as a ring of ``comm.ppermute``
    hops, a reduce-scatter then an all-gather, 2 (n - 1) hops of 1/n of
    the rows;
  * :func:`decode_step_overlap_model`: the analytic step model
    ``attn + max(collective, mlp)`` against ``attn + collective + mlp``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from ..comm import comm


def overlap_supported(y: torch.Tensor, group) -> bool:
    """The reduce-scatter / all-gather split needs a tp group of more than
    one rank and a hidden dim it divides."""
    if group is None or y.dim() != 3:
        return False
    return group.size > 1 and y.shape[-1] % group.size == 0


class DeferredReduce:
    """A pending sum of every tp rank's ``[B, S, D]`` partial: a started
    reduce-scatter over D (or, where the split does not apply, the finished
    all-reduce). :meth:`wait` returns the sum."""

    def __init__(self, y: torch.Tensor, group):
        self.group, self.shape = group, y.shape
        if not overlap_supported(y, group):
            self.done = comm.all_reduce(y.contiguous().clone(), group=group)
            self.work = None
            return
        n = group.size
        # [D, B*S] rows: the reduce-scatter splits dim 0, so each rank
        # receives its D/n hidden channels of every token
        self.rows = y.reshape(-1, y.shape[-1]).t().contiguous()
        self.piece = self.rows.new_empty((self.rows.shape[0] // n,)
                                         + tuple(self.rows.shape[1:]))
        self.work = dist.reduce_scatter_tensor(
            self.piece, self.rows, group=group.group, async_op=True)
        self.done = None

    def wait(self) -> torch.Tensor:
        if self.done is not None:
            return self.done
        self.work.wait()
        full = comm.all_gather_base(self.piece, group=self.group)
        self.done = full.t().reshape(self.shape)
        return self.done


def defer_attn_allreduce(y: torch.Tensor, group) -> DeferredReduce:
    """Start the tp sum of the attention branch's partial ``y`` [B, S, D];
    run the MLP, then ``.wait()`` for the sum."""
    return DeferredReduce(y, group)


def ring_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the tp ring of every rank's ``x`` [rows, ...] (rows
    divisible by the ring size), out of ``comm.ppermute`` hops: n - 1
    reduce-scatter hops leave rank r the whole sum of chunk r, n - 1
    all-gather hops pass the sums on. At n = 2 one add an element, bitwise
    the all-reduce; beyond, the ring's order of addition."""
    n = 1 if group is None else group.size
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(
            f"ring_allreduce needs rows % ring == 0, got {x.shape[0]} rows "
            f"on a {n}-wide tp group")
    r = group.rank
    chunks = list(x.chunk(n, 0))
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc = chunks[(r - 1) % n]
    for t in range(1, n):
        # the acc arriving from rank r - 1 carries chunk (r - t - 1) % n
        acc = comm.ppermute(acc.contiguous(), perm, group=group) \
            + chunks[(r - t - 1) % n]
    out = [None] * n
    out[r] = acc
    blk = acc
    for t in range(1, n):
        blk = comm.ppermute(blk.contiguous(), perm, group=group)
        out[(r - t) % n] = blk
    return torch.cat(out, 0)


def decode_step_overlap_model(t_attn: float, t_collective: float,
                              t_mlp: float) -> Dict[str, float]:
    """The decode step with the collective exposed (attn -> collective ->
    mlp) and hidden under the MLP GEMM; both times and their ratio."""
    unhidden = t_attn + t_collective + t_mlp
    overlapped = t_attn + max(t_collective, t_mlp)
    return {
        "t_attn_s": float(t_attn),
        "t_collective_s": float(t_collective),
        "t_mlp_s": float(t_mlp),
        "step_unhidden_s": float(unhidden),
        "step_overlapped_s": float(overlapped),
        "overlap_ratio": float(overlapped / unhidden) if unhidden else 1.0,
        "hidden_s": float(unhidden - overlapped),
    }


__all__ = ["overlap_supported", "defer_attn_allreduce", "DeferredReduce",
           "ring_allreduce", "decode_step_overlap_model"]
