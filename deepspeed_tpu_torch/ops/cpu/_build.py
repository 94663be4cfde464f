"""Build and bind the port's native host libraries.

``csrc/cpu_adam.cpp`` (the SIMD Adam / Adagrad steps of ZeRO-Offload) and
``csrc/aio.cpp`` (the thread-pooled file I/O of the NVMe tier) are the
port's own copies of the JAX package's ``csrc/``: host C++ with a plain C
interface, bound with ``ctypes`` over ``tensor.data_ptr()``. At first use
``g++`` compiles them into one library under ``deepspeed_tpu_torch/_build/``
(listed in ``.gitignore``), named by a hash of the sources and flags. A
build error raises: the offload path has no pure-Python stand-in for the
library.

The sources use OpenMP. A library linked against the system's OpenMP
runtime beside the one torch loaded would run two thread pools that
oversubscribe the cores (or crash), so the objects are compiled with
``-fopenmp`` and linked against the runtime file this process already has
mapped (``openmp_runtime()``, read from ``/proc/self/maps`` after torch is
imported); the loader then finds it loaded and both share one pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import torch  # noqa: F401  (loads torch's OpenMP runtime before the build)

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "_build")
SOURCES = ("cpu_adam.cpp", "aio.cpp")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_vp, _i64, _int, _f = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_float)
_SIGNATURES = {
    # params, grads, exp_avg, exp_avg_sq, n, lr, beta1, beta2, eps,
    # weight_decay, adamw, step
    "ds_adam_step": ([_vp] * 4 + [_i64] + [_f] * 5 + [_int, _i64], None),
    # params, params_bf16, grads, exp_avg, exp_avg_sq, then as above
    "ds_adam_step_bf16": ([_vp] * 5 + [_i64] + [_f] * 5 + [_int, _i64],
                          None),
    # params, grads, exp_avg_sq, n, lr, eps, weight_decay
    "ds_adagrad_step": ([_vp] * 3 + [_i64] + [_f] * 3, None),
    # src, dst (uint16), n
    "ds_f32_to_bf16": ([_vp, _vp, _i64], None),
    "ds_omp_max_threads": ([], _int),
    "aio_handle_new": ([_i64, _int, _int], _vp),
    "aio_handle_free": ([_vp], None),
    # path, for_write, direct, &used_direct
    "aio_open": ([ctypes.c_char_p, _int, _int, ctypes.POINTER(_int)], _int),
    "aio_close": ([_int], None),
    "aio_pread": ([_vp, _int, _vp, _i64, _i64], _i64),
    "aio_pwrite": ([_vp, _int, _vp, _i64, _i64], _i64),
    "aio_wait": ([_vp], _i64),
    "aio_sync_pread": ([_int, _vp, _i64, _i64], _i64),
    "aio_sync_pwrite": ([_int, _vp, _i64, _i64], _i64),
}


def openmp_runtime() -> Optional[str]:
    """The OpenMP runtime file mapped into this process (torch's), or None
    when none is loaded."""
    names = ("libgomp", "libiomp", "libomp")
    with open("/proc/self/maps") as fh:
        for line in fh:
            path = line.split()[-1]
            if any(os.path.basename(path).startswith(n) for n in names):
                return path
    return None


def loaded_openmp_runtimes() -> List[str]:
    """Every distinct OpenMP runtime file mapped into this process: one
    when the library shares torch's."""
    names = ("libgomp", "libiomp", "libomp")
    found = set()
    with open("/proc/self/maps") as fh:
        for line in fh:
            path = line.split()[-1]
            if any(os.path.basename(path).startswith(n) for n in names):
                found.add(os.path.realpath(path))
    return sorted(found)


def cpu_flags() -> List[str]:
    """The JAX package's builder flags (``deepspeed_tpu/ops/op_builder.py``),
    SIMD extensions gated on what this CPU has: the same flags give the
    same arithmetic."""
    flags = ["-O3", "-std=c++17", "-fPIC"]
    with open("/proc/cpuinfo") as fh:
        info = fh.read()
    if "avx2" in info:
        flags += ["-mavx2", "-mfma"]
    if "avx512f" in info:
        flags += ["-mavx512f"]
    return flags


def _run(cmd: List[str]) -> None:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(
            f"building the native host library failed ({' '.join(cmd)}):\n"
            f"{res.stderr[-4000:]}")


def build(csrc: str = None, build_dir: str = None) -> str:
    """Compile the sources into a shared library; returns its path (an
    existing build of the same sources and flags is reused)."""
    csrc, build_dir = csrc or CSRC, build_dir or BUILD_DIR
    srcs = [os.path.join(csrc, s) for s in SOURCES]
    runtime = openmp_runtime()
    flags = cpu_flags()
    h = hashlib.sha256(" ".join(flags + [str(runtime)]).encode())
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(build_dir, f"cpu_{h.hexdigest()[:16]}")
    out = os.path.join(out_dir, "libdstorch_cpu.so")
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = []
    for s in srcs:
        obj = os.path.join(out_dir, os.path.basename(s) + f".{os.getpid()}.o")
        _run(["g++", "-c", "-fopenmp", *flags, s, "-o", obj])
        objs.append(obj)
    # -fopenmp at the link would add the system's -lgomp: name torch's
    # runtime instead (its soname is then found already loaded)
    omp = ([runtime, f"-Wl,-rpath,{os.path.dirname(runtime)}"]
           if runtime else ["-fopenmp"])
    _run(["g++", "-shared", *flags, *objs, *omp, "-lpthread", "-o", tmp])
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, out)          # atomic: concurrent builders are safe
    return out


def library() -> ctypes.CDLL:
    """The native host library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib
