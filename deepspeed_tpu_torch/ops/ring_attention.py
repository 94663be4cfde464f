"""Ring attention: context parallelism by rotating K/V chunks around the sp
group.

Counterpart of ``deepspeed_tpu/ops/ring_attention.py``. There, one
``shard_map`` region runs ``_ring_local`` on every sp shard and JAX
differentiates its ``lax.scan`` of ``ppermute`` hops. Here each rank is one
process holding its sequence chunk, and :class:`RingAttention` is an
``autograd.Function`` over ``comm.ppermute`` (which has no gradient):

  * forward: the rank keeps its q chunk; step t holds the K/V chunk of rank
    ``src = (r - t) % n`` (the local chunk first, then a hop to the next
    rank before each further step). The block runs the flash forward (B1,
    ``ops/cuda/flash_attention.py``): causal on the diagonal (``src == r``),
    full below it (``src < r``), and skipped above it (``src > r``: in JAX
    such a block adds exactly ``exp(-1e30 - m) = 0``, because the local
    block is merged first). The partials merge through B1's f32 ``lse``.
    The chunks a rank attended to are kept for the backward, as JAX's scan
    keeps its carries;
  * backward: ``delta = rowsum(dO * out)`` once from the merged output,
    then the walk in reverse, each block through B1b with the merged
    ``lse`` and that ``delta``: dq adds up on the rank, and an f32 dk/dv
    accumulator hops the ring backwards, gathering each rank's share of
    one chunk's grads on its way to the chunk's owner (the reverse
    rotation JAX gets by differentiating its scan): n - 1 hops, no K/V
    sent again.

A one-rank group (or none) is a single causal block, as JAX's ``ring == 1``.
:func:`ring_attention_reference` is the plain version: ``_block_attend`` /
``_ring_local``'s equations over the whole sequence, every rank's walk
simulated in one process (autograd gives its grads).

``SP_TRAFFIC`` counts this rank's sequence-parallel exchanges: ring hops
here, the Ulysses all-to-alls of ``models/gpt.py`` (calls and bytes sent).
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch

from ..comm import comm
from .cuda.flash_attention import (attention_delta, flash_attention,
                                   flash_attention_backward,
                                   flash_attention_forward)

NEG_INF = -1e30

SP_TRAFFIC: collections.Counter = collections.Counter()


def _block_attend(q, k, v, q_pos, k_pos, scale: float, causal: bool):
    """One blockwise partial: (row max [B, H, Sq], exp-sum [B, H, Sq],
    weighted values [B, Sq, H, D]), f32 (JAX ``_block_attend``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None], s,
                        NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
    return m, l, acc.float()


def ring_attention_reference(q, k, v, ring: int,
                             scale: Optional[float] = None,
                             causal: bool = True) -> torch.Tensor:
    """The plain version over whole ``[B, S, H, D]`` tensors: the walk of
    each of ``ring`` ranks over ``S / ring``-row chunks, merged as
    ``_ring_local`` merges (masked blocks included)."""
    b, S, h, d = q.shape
    if S % ring:
        raise ValueError(f"ring {ring} does not divide the sequence {S}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    c = S // ring
    base = torch.arange(c, device=q.device)
    outs = []
    for r in range(ring):
        qr = q[:, r * c:(r + 1) * c]
        m = torch.full((b, h, c), NEG_INF, device=q.device)
        l = torch.zeros(b, h, c, device=q.device)
        acc = torch.zeros(b, c, h, d, device=q.device)
        for t in range(ring):
            src = (r - t) % ring
            kv = slice(src * c, (src + 1) * c)
            bm, bl, bacc = _block_attend(qr, k[:, kv], v[:, kv], r * c + base,
                                         src * c + base, scale, causal)
            m_new = torch.maximum(m, bm)
            c_old, c_new = torch.exp(m - m_new), torch.exp(bm - m_new)
            l = l * c_old + bl * c_new
            acc = (acc * c_old.transpose(1, 2)[..., None]
                   + bacc * c_new.transpose(1, 2)[..., None])
            m = m_new
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        outs.append(acc / l_safe.transpose(1, 2)[..., None])
    return torch.cat(outs, 1).to(q.dtype)


def _rotate(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """One hop: rank i's ``x`` to rank i + ``step`` (mod n)."""
    n = group.size
    SP_TRAFFIC["ring_hops"] += 1
    SP_TRAFFIC["ring_bytes"] += x.numel() * x.element_size()
    return comm.ppermute(x, [(i, (i + step) % n) for i in range(n)], group)


def _merge(out, lse, o, l):
    """Two partials of one softmax row merged by their log-sum-exps: out
    f32 [B, S, H, D], lse f32 [B, H, S]."""
    new = torch.logaddexp(lse, l)
    a = torch.exp(lse - new).transpose(1, 2)[..., None]
    b = torch.exp(l - new).transpose(1, 2)[..., None]
    return out * a + o.float() * b, new


def _blocks(n: int, r: int, causal: bool):
    """(step, whether its block runs, whether it is causal) of rank r's
    walk: the chunk of rank (r - t) % n at step t."""
    for t in range(n):
        src = (r - t) % n
        yield t, not (causal and src > r), causal and src == r


class RingAttention(torch.autograd.Function):
    """Ring attention over ``group`` (size > 1): q, k, v are this rank's
    ``[B, S/n, H, D]`` chunks, rank-ordered along the sequence."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale: float, causal: bool):
        n, r = group.size, group.rank
        kv = torch.stack([k, v])
        out = lse = None
        held = []                   # the chunk each step attended to
        for t, runs, diag in _blocks(n, r, causal):
            if t:
                kv = _rotate(kv, group)
            held.append(kv if runs else None)
            if not runs:
                continue
            o, l = flash_attention_forward(q, kv[0], kv[1], diag, scale)
            out, lse = (o.float(), l) if out is None else _merge(out, lse,
                                                                 o, l)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, out, lse, *held)
        ctx.group, ctx.scale, ctx.causal = group, scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, out, lse, *held = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n, r = group.size, group.rank
        dout = dout.contiguous()
        delta = attention_delta(out, dout)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = None
        for t, runs, diag in reversed(list(_blocks(n, r, ctx.causal))):
            # the accumulator of the chunk this rank held at step t: the
            # next rank's, which held it at step t + 1
            dkv = (torch.zeros((2,) + tuple(q.shape), dtype=torch.float32,
                               device=q.device) if dkv is None
                   else _rotate(dkv, group, -1))
            if not runs:
                continue
            kv = held[t]
            gq, gk, gv = flash_attention_backward(q, kv[0], kv[1], out, lse,
                                                  dout, diag, scale,
                                                  delta=delta)
            dq += gq.float()
            dkv[0] += gk.float()
            dkv[1] += gv.float()
        return (dq.to(q.dtype), dkv[0].to(q.dtype), dkv[1].to(q.dtype),
                None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, *, scale: Optional[float] = None,
                   causal: bool = True) -> torch.Tensor:
    """q, k, v: this rank's ``[B, S/sp, H, D]`` chunks over the sp
    ``group`` -> its ``[B, S/sp, H, D]`` attention output. The blocks run
    the flash kernels on a CUDA tensor, their plain versions on a CPU
    tensor."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if group is None or group.size == 1:
        return flash_attention(q, k, v, causal=causal, sm_scale=scale)
    return RingAttention.apply(q, k, v, group, scale, causal)
