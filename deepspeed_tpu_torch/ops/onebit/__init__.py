"""Namespace parity with the reference's 1-bit op backends
(``deepspeed/ops/adam/onebit`` tier): the implementations live with the
fp16 runtime, where the compressed exchange is wired into the engine.
"""

from ...runtime.fp16.onebit.adam import OnebitAdam
from ...runtime.fp16.onebit.lamb import OnebitLamb
from ...runtime.fp16.onebit.zoadam import ZeroOneAdam

__all__ = ["OnebitAdam", "OnebitLamb", "ZeroOneAdam"]
