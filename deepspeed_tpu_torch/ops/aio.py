"""Async file I/O handle for NVMe offload (the ZeRO-Infinity tier).

Counterpart of ``deepspeed_tpu/ops/aio.py`` (reference: the ``aio_handle``
of ``csrc/aio/py_lib/deepspeed_py_aio_handle.cpp``: block_size /
queue_depth knobs, async pread/pwrite + wait, sync variants), over CPU
tensors and the port's own native engine (``ops/cpu/csrc/aio.cpp``). A
failed build raises; there is no Python stand-in.

O_DIRECT needs the buffer address, the length and the file offset to be
multiples of :data:`DIRECT_ALIGN`. ``torch.empty`` promises none of that, so
:func:`aligned_empty` over-allocates and hands back an aligned view (pinned
with ``cudaHostRegister`` when the card copies from it). Where a filesystem
refuses O_DIRECT the file is opened buffered instead; the handle counts
which mode each open ran in (:attr:`AsyncIOHandle.opens`).
"""

from __future__ import annotations

import collections
import ctypes
import os
import weakref

import torch

from .cpu import _build

# O_DIRECT granularity: 4096 covers every modern NVMe / filesystem (logical
# block 512 or 4096). Buffers, lengths and offsets must all be multiples.
DIRECT_ALIGN = 4096


def padded_nbytes(nbytes: int) -> int:
    """Round a transfer length up to the O_DIRECT granularity."""
    return -(-int(nbytes) // DIRECT_ALIGN) * DIRECT_ALIGN


def _unregister(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


def aligned_empty(n: int, dtype=torch.float32, pin: bool = False
                  ) -> torch.Tensor:
    """Uninitialized 1-D CPU tensor of AT LEAST ``n`` elements whose data
    pointer is DIRECT_ALIGN-aligned and whose length is rounded up to the
    alignment boundary, so ``t[:k]`` serves compute while
    ``t[:padded_count]`` serves direct I/O inside the allocation (the
    reference pins and aligns its aio buffers the same way,
    csrc/aio/common/deepspeed_aio_utils.cpp). ``pin`` page-locks it with
    ``cudaHostRegister`` (released when the tensor is collected), so copies
    between it and the card run asynchronously at full rate."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    padded = padded_nbytes(n * itemsize)
    raw = torch.empty(padded + DIRECT_ALIGN, dtype=torch.uint8)
    off = (-raw.data_ptr()) % DIRECT_ALIGN
    view = raw[off:off + padded].view(dtype)
    if pin and padded:
        cudart = torch.cuda.cudart()
        err = cudart.cudaHostRegister(view.data_ptr(), padded, 0)
        if err != cudart.cudaError.success:
            raise RuntimeError(f"cudaHostRegister of {padded} bytes failed: "
                               f"{err}")
        weakref.finalize(view, _unregister, view.data_ptr())
    return view


def _check_direct(t: torch.Tensor, nbytes: int, offset: int) -> None:
    """ValueError (not assert: ``python -O`` must not disable this) when a
    direct-I/O request isn't fully DIRECT_ALIGN-aligned."""
    if (t.data_ptr() % DIRECT_ALIGN or nbytes % DIRECT_ALIGN
            or offset % DIRECT_ALIGN):
        raise ValueError(
            f"direct I/O requires DIRECT_ALIGN({DIRECT_ALIGN})-aligned "
            f"buffer/len/offset; got data%align="
            f"{t.data_ptr() % DIRECT_ALIGN}, len%align="
            f"{nbytes % DIRECT_ALIGN}, off%align={offset % DIRECT_ALIGN}")


def _nbytes(t: torch.Tensor) -> int:
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError("aio needs a contiguous CPU tensor")
    return t.numel() * t.element_size()


class AsyncIOHandle:
    """Thread-pooled async file reader/writer over the native engine.

        h = AsyncIOHandle(block_size=1 << 20, queue_depth=8)
        h.async_pwrite(tensor, path); ...; h.wait()
        h.async_pread(tensor, path); ...; h.wait()

    ``opens`` counts the opens that ran ``"O_DIRECT"`` and ``"buffered"``;
    ``bytes_read`` / ``bytes_written`` count the bytes moved."""

    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 8,
                 single_submit: bool = False, overlap_events: bool = True,
                 num_threads: int = 0):
        self.block_size = block_size
        self.queue_depth = queue_depth
        self._lib = _build.library()
        self._handle = self._lib.aio_handle_new(
            block_size, queue_depth, num_threads or queue_depth)
        self._fds = []             # fds held until wait()
        self._keepalive = []       # buffers the engine may still touch
        self.opens = collections.Counter()
        self.bytes_read = 0
        self.bytes_written = 0

    def _open(self, path: str, write: bool, direct: bool) -> int:
        used = ctypes.c_int(0)
        fd = self._lib.aio_open(os.fsencode(path), int(write), int(direct),
                                ctypes.byref(used))
        if fd < 0:
            raise OSError(-fd, f"aio_open failed for {path}")
        if direct:
            self.opens["O_DIRECT" if used.value else "buffered"] += 1
        else:
            self.opens["buffered"] += 1
        return fd

    # ------------------------------------------------------------- async
    def _submit(self, t: torch.Tensor, path: str, offset: int, direct: bool,
                write: bool) -> int:
        nbytes = _nbytes(t)
        if direct:
            _check_direct(t, nbytes, offset)
        fd = self._open(path, write, direct)
        self._fds.append(fd)
        self._keepalive.append(t)
        submit = self._lib.aio_pwrite if write else self._lib.aio_pread
        submit(self._handle, fd, t.data_ptr(), nbytes, offset)
        if write:
            self.bytes_written += nbytes
        else:
            self.bytes_read += nbytes
        return 1

    def async_pwrite(self, t: torch.Tensor, path: str, offset: int = 0,
                     direct: bool = False) -> int:
        """``direct=True`` bypasses the page cache (O_DIRECT, as the
        reference aio engine always runs): pass an :func:`aligned_empty`
        buffer sliced to a :func:`padded_nbytes` length and an aligned
        offset (checked: ValueError otherwise)."""
        return self._submit(t, path, offset, direct, write=True)

    def async_pread(self, t: torch.Tensor, path: str, offset: int = 0,
                    direct: bool = False) -> int:
        return self._submit(t, path, offset, direct, write=False)

    def wait(self) -> int:
        rc = self._lib.aio_wait(self._handle)
        for fd in self._fds:
            self._lib.aio_close(fd)
        self._fds.clear()
        self._keepalive.clear()
        if rc < 0:
            raise OSError(f"aio_wait reported {-rc} failed chunks")
        return 0

    # -------------------------------------------------------------- sync
    def _sync(self, t: torch.Tensor, path: str, offset: int, direct: bool,
              write: bool) -> int:
        nbytes = _nbytes(t)
        if direct:
            _check_direct(t, nbytes, offset)
        fd = self._open(path, write, direct)
        try:
            fn = self._lib.aio_sync_pwrite if write else \
                self._lib.aio_sync_pread
            rc = fn(fd, t.data_ptr(), nbytes, offset)
        finally:
            self._lib.aio_close(fd)
        if rc != nbytes:
            raise OSError(f"short {'write to' if write else 'read from'} "
                          f"{path}: {rc} of {nbytes} bytes")
        if write:
            self.bytes_written += nbytes
        else:
            self.bytes_read += nbytes
        return rc

    def sync_pwrite(self, t: torch.Tensor, path: str, offset: int = 0,
                    direct: bool = False) -> int:
        return self._sync(t, path, offset, direct, write=True)

    def sync_pread(self, t: torch.Tensor, path: str, offset: int = 0,
                   direct: bool = False) -> int:
        return self._sync(t, path, offset, direct, write=False)

    def close(self) -> None:
        """Drain in-flight requests and stop the worker threads."""
        if self._handle is not None:
            self.wait()
            self._lib.aio_handle_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.aio_handle_free(self._handle)
            self._handle = None
