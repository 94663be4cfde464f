"""KV-cache decode attention, dense and paged: read only each row's live
prefix.

Counterpart of ``deepspeed_tpu/ops/pallas/decode_attention.py``. The Pallas
kernels ``_decode_kernel`` (dense) and ``_paged_decode_kernel`` (paged), with
their int8 branches, become one CUDA kernel template in
``csrc/decode_attention.cuh`` (bound by ``decode_attention.cu`` and
``paged_decode_attention.cu``), templated on where a key position lives:
split-KV over a thread-block cluster (one cluster per (row, head), its
ranks splitting the row's live tiles), TMA copies into a shared-memory
ring, an online softmax per warp and a merge in a fixed order; see the
source for its design.
:func:`decode_attention_split_reference` is that split algebra in plain
PyTorch, for the tests; nothing on the main path calls it.

The dense cache is stored flat, ``[b, S, h*d]``, as the TPU path stores it;
the paged cache is a block pool ``[nb, bs, h*d]`` read through block tables
``[b, T]``. An int8 cache carries one f32 dequant multiplier per position
(``k_scale``/``v_scale``: ``[b, S]`` dense, ``[nb, bs]`` paged).
:func:`decode_attention` and :func:`paged_decode_attention` launch the
kernel for a CUDA tensor and run the plain PyTorch version
(:func:`decode_attention_reference`, :func:`paged_decode_attention_reference`)
for a CPU tensor; they never fall back from one to the other.
``masked_cache_attention`` is the masked-einsum attention the model's
prefill uses, the TPU package's XLA path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..quantizer import dequantize_kv
from . import _build

NEG_INF = float(torch.finfo(torch.float32).min)

# Widest query width one launch takes: a decode step (1), a speculative
# verify (k + 1) and a fused chunked-prefill step (prefill_chunk, 16 by
# default). A wider call runs as consecutive launches of at most this many
# queries (:func:`query_pieces`).
MAX_LAUNCH_S = 16
_KERNEL_HEAD_DIMS = (32, 64, 80, 96, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The kernel's split (csrc/decode_attention.cuh: kTile, kMaxSplit): key
# tiles of SPLIT_TILE positions, at most MAX_SPLIT blocks a (row, head).
SPLIT_TILE = 32
MAX_SPLIT = 8


def split_count(S: int, tile: int = SPLIT_TILE) -> int:
    """The blocks (cluster ranks) the kernel gives each (row, head) of a
    cache of S positions: chosen from S only, never from the fills."""
    return min(MAX_SPLIT, -(-S // tile))


def split_ranges(fill: int, n_split: int, tile: int = SPLIT_TILE):
    """The kernel's plan for a row of ``fill`` live positions: rank r
    owns the whole tiles [r*n // n_split, (r+1)*n // n_split) of the row's
    n = ceil(fill / tile) live tiles, as ``[start, stop)`` position ranges
    (the last cut at the fill). Together they cover [0, fill) once."""
    n = -(-fill // tile)
    out = []
    for r in range(n_split):
        t0, t1 = r * n // n_split, (r + 1) * n // n_split
        out.append((t0 * tile, min(t1 * tile, fill)))
    return out


def query_pieces(s: int):
    """The launches of a width-s call: ``(a, n)`` for the queries [a, a + n),
    consecutive pieces of at most :data:`MAX_LAUNCH_S`. Query i of a call
    with fill f sees positions < f - (s - 1) + i, so the piece [a, a + n) is
    a width-n call with fill f - (s - 1) + a + n - 1 (:func:`piece_fill`)."""
    return [(a, min(MAX_LAUNCH_S, s - a)) for a in range(0, s, MAX_LAUNCH_S)]


def piece_fill(fill: torch.Tensor, s: int, a: int, n: int) -> torch.Tensor:
    """The fill of the piece [a, a + n) of a width-s call with (clamped)
    fill ``fill``. A negative result (a piece whose queries see nothing) is
    clamped to 0 by the kernel, where its queries still see nothing."""
    return fill - (s - 1) + (a + n - 1)


def decode_supported(s: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes this query width, head dim and compute dtype
    (q's; the cache is the same dtype or int8 with scales). Every width >= 1
    is taken: up to :data:`MAX_LAUNCH_S` in one launch, wider in pieces.
    :func:`decode_attention` raises on a CUDA tensor of any other shape."""
    return s >= 1 and d in _KERNEL_HEAD_DIMS and dtype in _KERNEL_DTYPES


def paged_decode_supported(s: int, d: int, dtype: torch.dtype,
                           block_size: int) -> bool:
    """:func:`decode_supported` plus the pool's block size, a multiple of 8
    (it divides S = T * block_size by construction).
    :func:`paged_decode_attention` raises on a CUDA tensor of any other
    shape."""
    return decode_supported(s, d, dtype) and block_size >= 8 \
        and block_size % 8 == 0


def masked_cache_attention(q, ck, cv, first_q_pos, scale, window=None):
    """Masked-einsum cache attention: q [b, s, h, d] with query i at absolute
    position ``first_q_pos + i`` (a scalar or a [b] tensor), ck/cv
    [b, S, h, d]; each query sees keys at positions <= its own and, with a
    local ``window``, > its own - window (GPT-Neo's local layers). Softmax
    in f32, probabilities cast back to q's dtype, as the TPU package
    computes it."""
    S = ck.shape[1]
    s = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, ck).float() * scale
    key_pos = torch.arange(S, device=q.device)[None, None, None, :]
    fq = torch.as_tensor(first_q_pos, device=q.device)
    if fq.dim() == 1:                               # per-row: [b, 1, s, 1]
        q_pos = (fq[:, None] + torch.arange(s, device=q.device)
                 )[:, None, :, None]
    else:
        q_pos = (fq + torch.arange(s, device=q.device))[None, None, :, None]
    hidden = key_pos > q_pos
    if window is not None:
        hidden = hidden | (key_pos <= q_pos - window)
    logits = logits.masked_fill(hidden, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, cv)


def _as_cache_len(cache_len, b: int, S: int, device) -> torch.Tensor:
    clen = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    return torch.broadcast_to(clen, (b,)).clamp(0, S)


def decode_attention_reference(q, cached_key, cached_value, cache_len,
                               scale: float, k_scale=None, v_scale=None):
    """The plain version: the masked einsum over the whole cache, with a
    query that sees no key returning zeros, as the kernel does. Caches are
    flat [b, S, h*d] (or [b, S, h, d]); an int8 cache is dequantized to q's
    dtype first with its [b, S] scales (the TPU fallback's order)."""
    b, s_q, h, d = q.shape
    S = cached_key.shape[1]
    clen = _as_cache_len(cache_len, b, S, q.device)
    ck = cached_key.reshape(b, S, h * d)
    cv = cached_value.reshape(b, S, h * d)
    if k_scale is not None:
        ck = dequantize_kv(ck, k_scale.reshape(b, S, 1), q.dtype)
        cv = dequantize_kv(cv, v_scale.reshape(b, S, 1), q.dtype)
    first_q = clen - s_q
    out = masked_cache_attention(q, ck.view(b, S, h, d), cv.view(b, S, h, d),
                                 first_q, scale)
    # query i sees p < first_q + i + 1: none when that bound is <= 0
    sees = (first_q[:, None] + torch.arange(1, s_q + 1, device=q.device)) > 0
    return torch.where(sees[:, :, None, None], out, torch.zeros_like(out))


def _finite(m: torch.Tensor) -> torch.Tensor:
    """m with -inf (a state that saw no key) replaced by 0, so exp(x - m)
    never computes -inf - -inf."""
    return torch.where(torch.isneginf(m), 0.0, m)


def decode_attention_split_reference(q, k, v, cache_len, scale: float,
                                     n_split: int, tile: int = SPLIT_TILE,
                                     k_scale=None, v_scale=None):
    """The kernel's split algebra in plain PyTorch (for the tests; nothing
    on the main path calls it). Each row's live positions are cut by
    :func:`split_ranges` into ``n_split`` ranks; each rank keeps an f32
    partial state (m, l, acc) per (head, query) over the keys it owns that
    the query sees (m = -inf, l = 0 where it sees none), and the states
    merge in rank order with every factor of an m = -inf state taken as 0,
    so a query that sees no key returns exact zeros, never NaN. q:
    [b, s_q, h, d]; k/v: [b, S, h*d] (or [b, S, h, d]) in q's dtype, or
    int8 with [b, S] f32 ``k_scale``/``v_scale`` multiplied in f32, as the
    kernel does. Returns [b, s_q, h, d] in q's dtype."""
    b, s_q, h, d = q.shape
    S = k.shape[1]
    clen = _as_cache_len(cache_len, b, S, q.device)
    kf = k.reshape(b, S, h, d).float()
    vf = v.reshape(b, S, h, d).float()
    if k_scale is not None:
        kf = kf * k_scale.reshape(b, S, 1, 1).float()
        vf = vf * v_scale.reshape(b, S, 1, 1).float()
    qf = q.float()
    out = torch.zeros(b, s_q, h, d, dtype=torch.float32, device=q.device)
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    for row in range(b):
        fill = int(clen[row])
        lim = fill - (s_q - 1) + torch.arange(s_q, device=q.device)
        states = []                                 # per rank: m, l, acc
        for p0, p1 in split_ranges(fill, n_split, tile):
            pos = torch.arange(p0, p1, device=q.device)
            s = torch.einsum("qhd,khd->qhk", qf[row], kf[row, p0:p1]) * scale
            vis = (pos[None, :] < lim[:, None])[:, None, :]     # [s_q, 1, n]
            s = torch.where(vis, s, neg_inf)
            m = s.amax(dim=-1) if p1 > p0 else torch.full(
                (s_q, h), float("-inf"), device=q.device)
            e = torch.where(vis, torch.exp(s - _finite(m)[..., None]), 0.0)
            states.append((m, e.sum(dim=-1),
                           torch.einsum("qhk,khd->qhd", e, vf[row, p0:p1])))
        M = torch.stack([m for m, _, _ in states]).amax(dim=0)
        L = torch.zeros(s_q, h, device=q.device)
        O = torch.zeros(s_q, h, d, device=q.device)
        for m, l, acc in states:                    # rank order
            f = torch.where(m == neg_inf, 0.0, torch.exp(m - _finite(M)))
            L = L + l * f
            O = O + acc * f[..., None]
        out[row] = torch.where(L[..., None] > 0,
                               O / torch.where(L > 0, L, 1.0)[..., None], 0.0)
    return out.to(q.dtype)


def paged_gather_kv(pool: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """The gather of the plain version: pool [nb, bs, ...] through
    block_tables [b, T] -> [b, T*bs, ...]. Position p of row i reads flat
    pool index ``block_tables[i, p // bs] * bs + p % bs``, clipped into the
    pool (``mode="clip"``): sentinel entries past a row's reservation read
    the pool's last position, which lies past the row's fill and is masked
    by the caller."""
    nb, bs = pool.shape[:2]
    b, T = block_tables.shape
    p = torch.arange(T * bs, device=pool.device)
    blk = block_tables.long()[:, p // bs]                         # [b, S]
    flat = (blk * bs + p % bs).clamp(0, nb * bs - 1)
    return pool.reshape(nb * bs, *pool.shape[2:])[flat]


def paged_decode_attention_reference(q, k_pool, v_pool, block_tables,
                                     cache_len, scale: float, k_scale=None,
                                     v_scale=None):
    """The plain version of the paged kernel: gather the pools (and an int8
    pool's [nb, bs] scales) through the tables, then
    :func:`decode_attention_reference` over the gathered [b, T*bs, h*d]
    cache."""
    kf = paged_gather_kv(k_pool, block_tables)
    vf = paged_gather_kv(v_pool, block_tables)
    ks = vs = None
    if k_scale is not None:
        ks = paged_gather_kv(k_scale, block_tables)
        vs = paged_gather_kv(v_scale, block_tables)
    return decode_attention_reference(q, kf, vf, cache_len, scale, ks, vs)


def _check_kernel_args(q, k, v, k_scale, v_scale, scale_shape, d, s_q):
    if not decode_supported(s_q, d, q.dtype):
        raise ValueError(
            f"decode kernel takes s_q >= 1, d in "
            f"{_KERNEL_HEAD_DIMS}, f32/bf16/fp16; got s_q={s_q} d={d} "
            f"{q.dtype}")
    int8 = k_scale is not None
    want = torch.int8 if int8 else q.dtype
    if k.dtype != want or v.dtype != want:
        raise ValueError(f"cache dtypes {k.dtype} {v.dtype}: expected {want} "
                         f"for q {q.dtype}"
                         + (" with scales" if int8 else ""))
    tensors = [("q", q), ("cached_key", k), ("cached_value", v)]
    if int8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != scale_shape:
                raise ValueError(f"{name} must be f32 {scale_shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return int8


def decode_attention(q: torch.Tensor, cached_key: torch.Tensor,
                     cached_value: torch.Tensor, cache_len,
                     scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [b, s_q, h, d], s_q >= 1. cached_key/value: the flat
    [b, S, h*d] cache (a rank-4 [b, S, h, d] cache is viewed flat), in q's
    dtype, or int8 with ``k_scale``/``v_scale`` [b, S] f32 dequant
    multipliers. cache_len: valid positions per row including this call's
    s_q tokens, a scalar or [b]; entries past S (the serving engine's
    retired-lane sentinel) are clamped to S. Query i of a row with fill f
    attends to positions < f - (s_q - 1) + i. Returns [b, s_q, h, d] in q's
    dtype.

    A CUDA tensor launches the kernel, once a piece of
    :func:`query_pieces` (one launch up to s_q 16); a CPU tensor runs
    :func:`decode_attention_reference`."""
    b, s_q, h, d = q.shape
    S = cached_key.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if q.device.type == "cpu":
        return decode_attention_reference(q, cached_key, cached_value,
                                          cache_len, scale, k_scale, v_scale)
    kf = cached_key.reshape(b, S, h * d)
    vf = cached_value.reshape(b, S, h * d)
    int8 = _check_kernel_args(q, kf, vf, k_scale, v_scale, (b, S), d, s_q)
    clen = _as_cache_len(cache_len, b, S, q.device)
    name = "decode_attention_int8" if int8 else "decode_attention"

    def launch(a, n, fill, out):
        lib = _build.library()
        with torch.cuda.device(q.device):
            err = lib.dstorch_decode_attention(
                q[:, a:].data_ptr(), kf.data_ptr(), vf.data_ptr(),
                k_scale.data_ptr() if int8 else None,
                v_scale.data_ptr() if int8 else None, fill.data_ptr(),
                out[:, a:].data_ptr(), b, n, s_q, h, d, S, float(scale),
                _KERNEL_DTYPES[q.dtype], int(int8), _build.stream_of(q))
        _build.check(err, name)
        _build.LAUNCHES[name] += 1

    return _launch_pieces(q, clen, launch)


def _launch_pieces(q: torch.Tensor, clen: torch.Tensor, launch):
    """Run ``launch(a, n, fill, out)`` once for each piece ``(a, n)`` of
    :func:`query_pieces` (one launch when s_q <= 16), its fill
    :func:`piece_fill`: the kernel reads the piece's queries from q and
    writes its columns of ``out`` in place (row stride s_q)."""
    s_q = q.shape[1]
    out = torch.empty_like(q)
    if s_q <= MAX_LAUNCH_S:
        launch(0, s_q, clen.contiguous(), out)
        return out
    for a, n in query_pieces(s_q):
        launch(a, n, piece_fill(clen, s_q, a, n).contiguous(), out)
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           cache_len, scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Decode attention over a paged cache. q: [b, s_q, h, d], s_q >= 1
    (pieces of at most 16 as :func:`decode_attention`); k_pool/v_pool:
    [nb, bs, h*d] block pools in q's dtype, or int8 with
    ``k_scale``/``v_scale`` [nb, bs] f32; block_tables: [b, T] (S = T*bs);
    cache_len: valid positions per row including this call's tokens, a
    scalar or [b], clamped to S. Table entries past nb - 1 (the
    ``padded_table`` sentinel) are read clamped into the pool; they lie past
    their row's fill and are masked. Returns [b, s_q, h, d].

    A CUDA tensor launches the paged kernel; a CPU tensor runs
    :func:`paged_decode_attention_reference`."""
    b, s_q, h, d = q.shape
    nb, bs = k_pool.shape[:2]
    T = block_tables.shape[1]
    S = T * bs
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, cache_len, scale, k_scale,
            v_scale)
    if not paged_decode_supported(s_q, d, q.dtype, bs):
        raise ValueError(
            f"decode kernel takes s_q >= 1, d in "
            f"{_KERNEL_HEAD_DIMS}, f32/bf16/fp16, block_size a multiple of 8; "
            f"got s_q={s_q} d={d} {q.dtype} block_size={bs}")
    kf = k_pool.reshape(nb, bs, h * d)
    vf = v_pool.reshape(nb, bs, h * d)
    int8 = _check_kernel_args(q, kf, vf, k_scale, v_scale, (nb, bs), d, s_q)
    if (block_tables.dtype != torch.int32 or block_tables.shape[0] != b
            or block_tables.device != q.device
            or not block_tables.is_contiguous()):
        raise ValueError(f"block_tables must be contiguous int32 [{b}, T] on "
                         f"{q.device}")
    clen = _as_cache_len(cache_len, b, S, q.device)
    name = "paged_decode_attention_int8" if int8 else "paged_decode_attention"

    def launch(a, n, fill, out):
        lib = _build.library()
        with torch.cuda.device(q.device):
            err = lib.dstorch_paged_decode_attention(
                q[:, a:].data_ptr(), kf.data_ptr(), vf.data_ptr(),
                k_scale.data_ptr() if int8 else None,
                v_scale.data_ptr() if int8 else None, block_tables.data_ptr(),
                fill.data_ptr(), out[:, a:].data_ptr(), b, n, s_q, h, d, nb,
                bs, T, float(scale), _KERNEL_DTYPES[q.dtype], int(int8),
                _build.stream_of(q))
        _build.check(err, name)
        _build.LAUNCHES[name] += 1

    return _launch_pieces(q, clen, launch)
