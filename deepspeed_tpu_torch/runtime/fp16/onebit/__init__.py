"""1-bit optimizers: communication-compressed Adam / LAMB variants.

Counterpart of ``deepspeed_tpu/runtime/fp16/onebit`` (reference:
``deepspeed/runtime/fp16/onebit/{adam,lamb,zoadam}.py``): a warmup phase
with a dense gradient all-reduce, then a compression phase in which only
error-feedback sign-compressed state crosses the wire
(``comm/compressed.py``).

Each optimizer is a per-rank step over one flat padded f32 vector: every
rank calls it with its own local gradient and state, and the step decides
what crosses the wire (a dense mean, or the 1-bit exchange). The phase is
chosen on the host from the count of applied updates
(``integration.OnebitRunner``), as the TPU package picks one compiled
program a phase.
"""

from .adam import OnebitAdam
from .lamb import OnebitLamb
from .zoadam import ZeroOneAdam, ZeroOnePolicy

ONEBIT_OPTIMIZERS = {
    "onebitadam": OnebitAdam,
    "onebitlamb": OnebitLamb,
    "zerooneadam": ZeroOneAdam,
}

__all__ = ["OnebitAdam", "OnebitLamb", "ZeroOneAdam", "ZeroOnePolicy",
           "ONEBIT_OPTIMIZERS"]
