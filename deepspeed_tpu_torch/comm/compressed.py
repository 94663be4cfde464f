"""Error-feedback 1-bit compressed all-reduce.

Counterpart of ``deepspeed_tpu/comm/compressed.py`` (reference
``deepspeed/runtime/comm/nccl.py:52-203``: worker sign-compression with
error feedback, a phase-1 all-to-all of packed sign bits and an all-gather
of the per-rank scales, server-side recompression with its own error
buffer, a phase-2 all-gather of the server signs and scales).

The TPU package runs every rank in one program over a stacked ``[G, n]``
view; here each process is one rank and passes its own ``[n]`` buffer, as
every collective of ``comm`` does: its ``all_to_all`` becomes
``comm.all_to_all_single`` of a ``[world, chunk/8]`` uint8 tensor and its
``all_gather`` of the scales ``comm.all_gather``. Sign bits are packed 8 a
byte (bit i of byte j is element 8j+i), so the phase-1 payload is n/8
bytes and one fp32 scale a rank.

The compression scheme (the same math as the TPU package and the
reference)::

  worker:  buf += worker_error
           scale = ||buf||_2 / sqrt(n)
           worker_error = buf - scale * sign(buf)      # sign(0) := +1
  server:  m = sum_r scale_r * sign_r / world          # my 1/world chunk
           m += server_error
           s_scale = ||m||_2 / sqrt(n/world)
           server_error = m - s_scale * sign(m)
  result:  concat_r s_scale_r * sign_r                 # via all-gather

Every norm accumulates in f64 before it is rounded to f32 (the TPU
package sums in f32): the f32 scale then comes out the same on the card
and on the host, so a CPU run of the same inputs gives the same bits.
Over gloo a CUDA tensor goes on the wire through a host copy (gloo's own
staging); ``WIRE`` counts the bytes this rank sent and received.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch

from . import comm as dist

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)
# bytes this rank put on the wire and took off it in compressed_allreduce
WIRE: collections.Counter = collections.Counter()


def _bit_weights(device) -> torch.Tensor:
    return torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=device)


def padded_size(n: int, world_size: int) -> int:
    """Smallest size >= n divisible by world*lcm(world, 8), so each rank's
    server chunk is itself a whole number of packed bytes (the reference's
    ``divider`` math, zoadam.py corrected_tensor_size)."""
    divider = world_size * 8 // math.gcd(world_size, 8)  # lcm(world, 8)
    unit = world_size * divider
    return ((n + unit - 1) // unit) * unit


def pack_signs(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., 8k] -> uint8 [..., k]; bit i of byte j = bits[..., 8j+i]."""
    b = bits.reshape(bits.shape[:-1] + (-1, 8)).to(torch.uint8)
    return (b * _bit_weights(bits.device)).sum(-1, dtype=torch.uint8)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., k] -> bool [..., 8k] (inverse of pack_signs)."""
    bits = (packed[..., None] & _bit_weights(packed.device)) != 0
    return bits.reshape(packed.shape[:-1] + (-1,))


def _pm1(bits: torch.Tensor) -> torch.Tensor:
    """bool -> f32 {-1, +1} with the reference's sign(0) := +1 convention."""
    one = torch.ones((), dtype=torch.float32, device=bits.device)
    return torch.where(bits, one, -one)


def _rms(x: torch.Tensor) -> torch.Tensor:
    """||x||_2 / sqrt(numel) as a 0-dim f32 tensor (accumulated in f64)."""
    norm = torch.linalg.vector_norm(x, dtype=torch.float64).float()
    return norm / torch.sqrt(torch.tensor(float(x.numel()),
                                          device=x.device))


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """``comm.all_gather`` of ``x``, its bytes counted in ``WIRE``."""
    world = dist.get_world_size(group)
    nbytes = x.numel() * x.element_size()
    WIRE["sent"] += (world - 1) * nbytes
    WIRE["received"] += (world - 1) * nbytes
    return dist.all_gather(x, group=group)


def compressed_allreduce(buf: torch.Tensor, worker_error: torch.Tensor,
                         server_error: torch.Tensor,
                         group: Optional[dist.CommGroup] = None):
    """1-bit averaging all-reduce with error feedback over ``group`` (default
    the world); every rank calls it with its own tensors.

    Args:
      buf: [n] this rank's f32 buffer; n must be ``padded_size``-aligned.
      worker_error: [n] this rank's worker error-feedback buffer.
      server_error: [n/world] this rank's server error buffer.

    Returns (avg [n], new_worker_error [n], new_server_error [n/world]); the
    average is the same on every rank, bit for bit.
    """
    world = dist.get_world_size(group)
    n = buf.shape[0]
    if n % (world * 8):
        raise ValueError(f"buffer size {n} not aligned for world={world}; "
                         f"pad to {padded_size(n, world)}")
    chunk = n // world

    corrected = buf + worker_error
    scale = _rms(corrected)
    sign_bits = corrected >= 0
    new_worker_error = corrected - scale * _pm1(sign_bits)
    del corrected

    # phase 1: all-to-all of packed sign chunks + all-gather of the scales
    packed = pack_signs(sign_bits).reshape(world, chunk // 8)
    del sign_bits
    moved = (world - 1) * (chunk // 8)
    WIRE["sent"] += moved
    WIRE["received"] += moved
    recv = dist.all_to_all_single(packed, group=group)     # [world, chunk/8]
    scales = _gather(scale.reshape(1), group).reshape(world)

    # server side: sum my chunk's contributions in rank order, recompress
    m = torch.zeros(chunk, dtype=torch.float32, device=buf.device)
    for r in range(world):
        m = m + (scales[r] / world) * _pm1(unpack_signs(recv[r]))
    m = m + server_error
    s_scale = _rms(m)
    s_bits = m >= 0
    new_server_error = m - s_scale * _pm1(s_bits)
    del m

    # phase 2: all-gather of the server signs and scales
    all_s = _gather(pack_signs(s_bits), group)               # [world, chunk/8]
    all_scales = _gather(s_scale.reshape(1), group).reshape(world, 1)
    result = (all_scales * _pm1(unpack_signs(all_s))).reshape(n)
    return result, new_worker_error, new_server_error


def wire_bytes_compressed(n: int, world_size: int) -> int:
    """Bytes a rank puts on the wire for one compressed all-reduce of n
    f32: the phase-1 all-to-all sends (world-1)/world * n/8 sign bytes and
    the phase-2 all-gather receives the same; scales are world f32s (the
    TPU package's accounting, against 2*4*n dense ring bytes)."""
    signs = n // 8  # sent once in a2a, received once in allgather
    scales = 2 * world_size * 4
    return 2 * signs + scales


def wire_bytes_dense(n: int, world_size: int) -> int:
    """Ring-allreduce bytes per rank for n fp32: 2 * (world-1)/world * 4n."""
    return int(2 * (world_size - 1) / world_size * 4 * n)


class CompressedBackend:
    """The reference ``NcclBackend`` / ``MpiBackend`` surface
    (runtime/comm/nccl.py:52) over this rank's tensor: the buffer is padded
    to ``padded_size`` inside, the error buffers are this rank's."""

    def __init__(self, group: Optional[dist.CommGroup] = None):
        self.group = group if group is not None else dist.new_group("dp")
        self.size = self.group.size

    def error_shapes(self, n: int):
        """This rank's (worker error, server error) shapes for a buffer of
        n elements."""
        npad = padded_size(n, self.size)
        return (npad,), (npad // self.size,)

    def compressed_allreduce(self, buf, worker_error, server_error):
        """buf: [n] this rank's buffer -> ([n] average, new worker error,
        new server error)."""
        n = buf.shape[0]
        npad = padded_size(n, self.size)
        if tuple(worker_error.shape) != (npad,):
            raise ValueError(f"worker_error must be [{npad}]")
        padded = torch.zeros(npad, dtype=torch.float32, device=buf.device)
        padded[:n] = buf
        out, we, se = compressed_allreduce(padded, worker_error,
                                           server_error, self.group)
        return out[:n], we, se
