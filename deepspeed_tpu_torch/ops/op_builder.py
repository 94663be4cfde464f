"""Op builders: which native and device ops this install can build and load.

Counterpart of ``deepspeed_tpu/ops/op_builder.py`` (reference
``op_builder/builder.py``: one ``OpBuilder`` a op with ``is_compatible`` and
``load``, and ``ALL_OPS`` for ``ds_report``), over the port's own builds:

  * the host ops (``cpu_adam``, ``cpu_adagrad``, ``async_io``) live in one
    library that ``ops/cpu/_build.py`` compiles with g++ from
    ``ops/cpu/csrc/``; a builder checks its symbols there;
  * the device ops (``flash_attn``, ``fused_layer_norm``, ``fused_softmax``,
    ``fused_gelu``, ``sparse_attn``) are the hand-written Hopper kernels that
    ``ops/cuda/_build.py`` compiles with nvcc from ``ops/cuda/csrc/``; a
    builder's ``load()`` builds that library and returns the op's wrapper
    module, or raises with the build's error. It never hands back a plain
    version: without a card there is nothing to load;
  * ``quantizer`` is the port's ``ops/quantizer.py`` (torch ops), loaded as
    the JAX entry loads its module.

The names are the JAX map's.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional, Sequence, Tuple

_PKG = "deepspeed_tpu_torch.ops"


def _native():
    from .cpu import _build
    return _build.library()


def _device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the device kernels build for "
                           "and run on an sm_90a card")
    from .cuda import _build
    return _build.library()


def _try(fn) -> Tuple[object, Optional[str]]:
    """``(fn(), None)``, or ``(None, its error)``: a build or import that
    fails is reported, not hidden."""
    try:
        return fn(), None
    except Exception as exc:            # noqa: BLE001 (reported, not hidden)
        return None, f"{type(exc).__name__}: {exc}"


def is_compatible() -> bool:
    """True when the native host library builds and loads."""
    return _try(_native)[0] is not None


def build_report() -> str:
    """ds_report-style lines: the native host library and the device
    kernels, each OK or UNAVAILABLE with the build's error."""
    lines = []
    for fn, what in ((_native, "native ops"), (_device, "cuda kernels")):
        lib, err = _try(fn)
        lines.append(f"{what} {'.' * (22 - len(what))} " + (
            "OK" if lib is not None else f"UNAVAILABLE ({err})"))
    return "\n".join(lines)


class _NativeOpBuilder:
    """One host op of the native library (reference ``CPUAdamBuilder``,
    ``AsyncIOBuilder``): compatible when the library builds and has the
    op's symbols."""

    def __init__(self, name: str, symbols: Sequence[str]):
        self.name = name
        self.symbols = list(symbols)

    def is_compatible(self) -> bool:
        lib = _try(_native)[0]
        return lib is not None and all(hasattr(lib, s) for s in self.symbols)

    def load(self):
        return _native()


class _CudaOpBuilder:
    """One device op: its kernels' symbols in the CUDA library and its
    wrapper module (``ops/cuda/<module>.py``)."""

    def __init__(self, name: str, module: str, symbols: Sequence[str]):
        self.name = name
        self.module = module
        self.symbols = list(symbols)

    def is_compatible(self) -> bool:
        lib = _try(_device)[0]
        return lib is not None and all(hasattr(lib, s) for s in self.symbols)

    def load(self):
        lib = _device()
        missing = [s for s in self.symbols if not hasattr(lib, s)]
        if missing:
            raise RuntimeError(f"{self.name}: the CUDA library lacks "
                               f"{missing}")
        return importlib.import_module(self.module)


class _ModuleOpBuilder:
    """An op that is a module of the package (no build step)."""

    def __init__(self, name: str, module: str):
        self.name = name
        self.module = module

    def is_compatible(self) -> bool:
        return _try(lambda: importlib.import_module(self.module))[0] \
            is not None

    def load(self):
        return importlib.import_module(self.module)


def available_builders() -> Dict[str, object]:
    """Name -> builder map for ds_report (reference ``op_builder.ALL_OPS``);
    the JAX package's names."""
    cuda = f"{_PKG}.cuda"

    def dev(name, module, *symbols):
        return _CudaOpBuilder(name, f"{cuda}.{module}",
                              [f"dstorch_{s}" for s in symbols])
    return {
        "cpu_adam": _NativeOpBuilder("cpu_adam",
                                     ["ds_adam_step", "ds_adam_step_bf16"]),
        "cpu_adagrad": _NativeOpBuilder("cpu_adagrad", ["ds_adagrad_step"]),
        "async_io": _NativeOpBuilder("async_io",
                                     ["aio_handle_new", "aio_pread",
                                      "aio_pwrite", "aio_wait"]),
        "flash_attn": dev("flash_attn", "flash_attention", "flash_fwd",
                          "flash_bwd_dq", "flash_bwd_dkv"),
        "fused_layer_norm": dev("fused_layer_norm", "layer_norm",
                                "layer_norm_fwd", "layer_norm_dx"),
        "fused_softmax": dev("fused_softmax", "softmax", "softmax_fwd",
                             "softmax_bwd"),
        "fused_gelu": dev("fused_gelu", "gelu", "bias_gelu_fwd",
                          "bias_gelu_bwd"),
        "sparse_attn": dev("sparse_attn", "sparse_attention", "sparse_fwd",
                           "sparse_bwd_dq", "sparse_bwd_dkv"),
        "quantizer": _ModuleOpBuilder("quantizer", f"{_PKG}.quantizer"),
    }

