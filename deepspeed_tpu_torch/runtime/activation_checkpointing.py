"""Function-style activation checkpointing, and the host-offloaded
checkpoint behind ``cpu_checkpointing``.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing.py``
(reference ``deepspeed/runtime/activation_checkpointing/checkpointing.py``:
``configure`` :825, ``checkpoint`` :743, ``is_configured`` :907, ``reset``
:768), exported as ``deepspeed_tpu_torch.checkpointing``:

    import deepspeed_tpu_torch as dst
    dst.checkpointing.configure(None, checkpoint_in_cpu=True)
    y = dst.checkpointing.checkpoint(block_fn, x)

``checkpoint`` is a non-reentrant ``torch.utils.checkpoint`` by default
(nothing saved, the forward recomputed in the backward). Under
``checkpoint_in_cpu`` it is :class:`OffloadedCheckpoint`: the function's
tensor inputs wait in page-locked host memory instead of on the device,
the TPU package's ``save_and_offload_only_these_names`` policy. Note that
``torch.autograd.graph.save_on_cpu`` around a checkpoint would not do it:
it does not move a checkpoint's inputs, and it would move every other
saved tensor of the region too. ``partition_activations`` is recorded (a
tensor-parallel sharding of the saved inputs: ROADMAP A9) and changes
nothing on one device. The knobs with no mapping here
(``contiguous_checkpointing``, ``synchronize``, ``profile``) raise, as in
the TPU package. The reference's RNG tracker has no counterpart: the
port's models draw no random numbers in a checkpointed block.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils import checkpoint as torch_checkpoint

_config: Optional[Dict[str, Any]] = None


class HostCheckpoints:
    """The tensors checkpoints keep in host memory, by index in the order
    they were saved. On a CUDA device each copy runs on a side stream into
    page-locked memory, and the device tensor is recorded on that stream
    so that the allocator reuses its memory only once the copy is done,
    with no wait on the host; a load brings its tensor back and starts
    fetching the one saved before it, since the backward walks the
    checkpoints in reverse. On the CPU the copies are plain clones."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.host: List[Optional[torch.Tensor]] = []
        self._fetched: Dict[int, Any] = {}   # index -> (copy, its event)
        self._live = 0                    # saved and not loaded yet

    def save(self, x: torch.Tensor) -> int:
        """Start the copy of ``x`` to the host; its index."""
        if self._live == 0:               # nothing refers to old indices
            self.host.clear()
            self._fetched.clear()
        self._live += 1
        if not self.cuda:
            self.host.append(x.detach().clone())
            return len(self.host) - 1
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        self.stream.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(self.stream):
            host.copy_(x.detach(), non_blocking=True)
        x.record_stream(self.stream)
        self.host.append(host)
        return len(self.host) - 1

    def _start_fetch(self, i: int, device) -> None:
        if i < 0 or i in self._fetched or self.host[i] is None:
            return
        with torch.cuda.stream(self.stream):
            dev = self.host[i].to(device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._fetched[i] = (dev, ev)

    def load(self, i: int, device) -> torch.Tensor:
        """Tensor ``i`` back on ``device``; the fetch of ``i - 1`` starts."""
        self._live -= 1
        if not self.cuda:
            x, self.host[i] = self.host[i], None
            return x
        self._start_fetch(i, device)
        dev, ev = self._fetched.pop(i)
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ev)
        dev.record_stream(stream)
        self.host[i] = None       # the copy event guards its reuse
        self._start_fetch(i - 1, device)
        return dev


class OffloadedCheckpoint(torch.autograd.Function):
    """``run(*args)`` checkpointed with its tensor inputs in host memory:
    the forward runs it without grad and sends the tensors to ``store``;
    the backward brings them back (the latest first), runs ``run`` again
    under grad and backpropagates through it, the parameters' grads
    accumulating as in any backward (the reentrant checkpoint's scheme).
    A backward reaches the parameters only when some tensor input needs
    grad, as with the reentrant checkpoint."""

    @staticmethod
    def forward(ctx, store: HostCheckpoints, run, *args):
        ctx.store, ctx.run = store, run
        ctx.args = [(store.save(a), a.device, a.requires_grad)
                    if isinstance(a, torch.Tensor) else (None, None, a)
                    for a in args]
        with torch.no_grad():
            return run(*args)

    @staticmethod
    def backward(ctx, *grads):
        args: List[Any] = [None] * len(ctx.args)
        for k in sorted(range(len(ctx.args)), reverse=True,
                        key=lambda k: -1 if ctx.args[k][0] is None
                        else ctx.args[k][0]):
            idx, device, spec = ctx.args[k]
            if idx is None:
                args[k] = spec
            else:
                args[k] = ctx.store.load(idx, device).detach() \
                    .requires_grad_(spec)
        with torch.enable_grad():
            out = ctx.run(*args)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if isinstance(o, torch.Tensor) and o.requires_grad
                 and g is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return (None, None) + tuple(
            a.grad if isinstance(a, torch.Tensor) else None for a in args)


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Record the checkpointing policy (reference checkpointing.py:825);
    ``mpu_`` and ``deepspeed_config`` are taken for signature parity."""
    bad = []
    if contiguous_checkpointing:
        bad.append("contiguous_checkpointing (PyTorch's caching allocator "
                   "owns buffer layout; there is no manual contiguous arena "
                   "to fill)")
    if synchronize:
        bad.append("synchronize (no per-checkpoint host sync points)")
    if profile:
        bad.append("profile (use wall_clock_breakdown)")
    if bad:
        raise ValueError("checkpointing.configure cannot honor: "
                         + "; ".join(bad))
    global _config
    _config = {
        "partition_activations": bool(partition_activations),
        "num_checkpoints": num_checkpoints,
        "checkpoint_in_cpu": bool(checkpoint_in_cpu),
        "stores": {},
    }


def is_configured() -> bool:
    return _config is not None


def reset() -> None:
    """Clear the recorded configuration (the reference frees its
    per-iteration buffers here; the host stores go with the
    configuration)."""
    global _config
    _config = None


def _store(device: torch.device) -> HostCheckpoints:
    stores = _config["stores"]
    key = str(device)
    if key not in stores:
        stores[key] = HostCheckpoints(device)
    return stores[key]


def checkpoint(function, *args):
    """``function(*args)`` under rematerialization: nothing kept for the
    backward but its inputs (on the host under ``checkpoint_in_cpu``); the
    forward runs again during the backward (reference
    checkpointing.py:743)."""
    if _config and _config["checkpoint_in_cpu"]:
        if not torch.is_grad_enabled():
            return function(*args)
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), None)
        if device is None:
            raise ValueError("checkpoint_in_cpu needs a tensor input")
        return OffloadedCheckpoint.apply(_store(device), function, *args)
    return torch_checkpoint.checkpoint(function, *args, use_reentrant=False)
