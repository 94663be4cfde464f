"""Build and bind the package's hand-written CUDA kernels.

The ``.cu`` sources under ``csrc/`` expose plain C functions (no PyTorch
headers, so ``nvcc`` takes seconds, not minutes). At first use they are
compiled for Hopper (``sm_90a``) by ``torch.utils.cpp_extension.load`` into
``deepspeed_tpu_torch/_build/`` (listed in ``.gitignore``) and bound with
``ctypes``. A build error raises; nothing here catches it.

Every kernel wrapper counts its launches in :data:`LAUNCHES` (one per kernel
launch, nowhere else), so a run can show which kernels its path went through.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "_build")
SOURCES = ("decode_attention.cu", "sampling.cu", "flash_attention.cu",
           "sparse_attention.cu")
CUDA_FLAGS = ["-O3", "-std=c++17", "-lineinfo",
              "-gencode=arch=compute_90a,code=sm_90a"]

LAUNCHES: collections.Counter = collections.Counter()

_lib = None
_lock = threading.Lock()

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, cache_len, out, b, s_q, h, d, S, scale, dtype, stream
    "dstorch_decode_attention": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int,
                                 _int, _int, _float, _int, _vp],
    # logits, gumbel, out_logits, out_tokens, b, V, top_k, top_p, stream
    "dstorch_sampling": [_vp, _vp, _vp, _vp, _int, _int, _int, _float, _vp],
    # q, k, v, out, lse, strides, B, S, H, d, causal, scale, dtype, stream
    "dstorch_flash_fwd": [_vp] * 6 + [_int] * 5 + [_float, _int, _vp],
    # q, k, v, dout, lse, delta, dq, strides, B, S, H, d, causal, scale,
    # dtype, stream
    "dstorch_flash_bwd_dq": [_vp] * 8 + [_int] * 5 + [_float, _int, _vp],
    # q, k, v, dout, lse, delta, dk, dv, strides, B, S, H, d, causal, scale,
    # dtype, stream
    "dstorch_flash_bwd_dkv": [_vp] * 9 + [_int] * 5 + [_float, _int, _vp],
    # ... the flash arguments up to strides, then lut_idx, lut_cnt, lut_bits,
    # lut_len, shift, kvm, B, S, H, d, causal, scale, dtype, stream
    "dstorch_sparse_fwd": [_vp] * 9 + [_int] * 2 + [_vp] + [_int] * 5
    + [_float, _int, _vp],
    "dstorch_sparse_bwd_dq": [_vp] * 11 + [_int] * 2 + [_vp] + [_int] * 5
    + [_float, _int, _vp],
    # dk/dv: lut_len and shift are followed by items, n_items, parts, ws,
    # tickets
    "dstorch_sparse_bwd_dkv": [_vp] * 12 + [_int] * 2 + [_vp] + [_int] * 2
    + [_vp] * 3 + [_int] * 5 + [_float, _int, _vp],
}


def library(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            from torch.utils.cpp_extension import load
            os.makedirs(BUILD_DIR, exist_ok=True)
            path = load(name="deepspeed_tpu_torch_kernels",
                        sources=[os.path.join(CSRC, s) for s in SOURCES],
                        extra_cuda_cflags=CUDA_FLAGS,
                        build_directory=BUILD_DIR,
                        is_python_module=False, verbose=verbose)
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def reset_launch_counts() -> None:
    LAUNCHES.clear()
