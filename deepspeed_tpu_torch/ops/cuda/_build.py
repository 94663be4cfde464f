"""Build and bind the package's hand-written CUDA kernels.

The ``.cu`` sources under ``csrc/`` expose plain C functions (no PyTorch
headers, so ``nvcc`` takes seconds, not minutes): decode attention and its
paged / int8 forms (B2, B3), sampling (B4), flash attention (B1, B1b),
block-sparse attention (B5, B5b), LayerNorm (B6), bias-GELU (B7) and
softmax (B8). The sparse and flash sources share ``attention_tiles.cuh``
and the Hopper machinery of their wgmma kernels, ``hopper.cuh``, the two
decode sources (dense, paged) ``decode_attention.cuh``, the row-wise ones
``rowwise.cuh``. At first use they are compiled for Hopper
(``sm_90a``) by ``torch.utils.cpp_extension.load`` into one library in
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
SOURCES = ("decode_attention.cu", "paged_decode_attention.cu", "sampling.cu",
           "flash_attention.cu", "sparse_attention.cu", "layer_norm.cu",
           "gelu.cu", "softmax.cu")
CUDA_FLAGS = ["-O3", "-std=c++17", "-lineinfo",
              "-gencode=arch=compute_90a,code=sm_90a"]

LAUNCHES: collections.Counter = collections.Counter()

_lib = None
_lock = threading.Lock()

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ll = ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, k_scale, v_scale, cache_len, out, b, s_q, q_stride, h, d, S,
    # scale, dtype, int8, stream
    "dstorch_decode_attention": [_vp] * 7 + [_int] * 6
    + [_float, _int, _int, _vp],
    # q, k_pool, v_pool, k_scale, v_scale, tables, cache_len, out, b, s_q,
    # q_stride, h, d, nb, bs, T, scale, dtype, int8, stream
    "dstorch_paged_decode_attention": [_vp] * 8 + [_int] * 8
    + [_float, _int, _int, _vp],
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
    # lut_len, shift, items, n_items, kvm, B, S, H, d, causal, scale, dtype,
    # stream
    "dstorch_sparse_fwd": [_vp] * 9 + [_int] * 2 + [_vp, _int, _vp]
    + [_int] * 5 + [_float, _int, _vp],
    # dq: lut_len and shift are followed by items, n_items
    "dstorch_sparse_bwd_dq": [_vp] * 11 + [_int] * 2 + [_vp, _int, _vp]
    + [_int] * 5 + [_float, _int, _vp],
    # dk/dv: lut_len and shift are followed by items, n_items, parts, ws,
    # tickets
    "dstorch_sparse_bwd_dkv": [_vp] * 12 + [_int] * 2 + [_vp] + [_int] * 2
    + [_vp] * 3 + [_int] * 5 + [_float, _int, _vp],
    # x, gamma, beta, y, mean, rstd, n, d, eps, dtype, param_f32, stream
    "dstorch_layer_norm_fwd": [_vp] * 6 + [_int] * 2 + [_float]
    + [_int] * 2 + [_vp],
    # x, gamma, mean, rstd, dy, dx, n, d, dtype, param_f32, stream
    "dstorch_layer_norm_dx": [_vp] * 6 + [_int] * 4 + [_vp],
    # x, bias, y, total, d, dtype, bias_f32, stream
    "dstorch_bias_gelu_fwd": [_vp] * 3 + [_ll] + [_int] * 3 + [_vp],
    # x, bias, dy, dx, total, d, dtype, bias_f32, stream
    "dstorch_bias_gelu_bwd": [_vp] * 4 + [_ll] + [_int] * 3 + [_vp],
    # x, y, n, s, sq, causal, dtype, stream
    "dstorch_softmax_fwd": [_vp] * 2 + [_int] * 5 + [_vp],
    # y, dy, dx, n, s, dtype, stream
    "dstorch_softmax_bwd": [_vp] * 3 + [_int] * 3 + [_vp],
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
