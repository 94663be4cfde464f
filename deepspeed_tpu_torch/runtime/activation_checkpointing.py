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
``checkpoint_in_cpu`` it is :func:`offloaded_checkpoint`: the function's
tensor inputs wait in page-locked host memory instead of on the device,
the TPU package's ``save_and_offload_only_these_names`` policy. Both modes
differentiate what the function closes over (its parameters) whether or
not a tensor input needs grad, as ``jax.checkpoint`` does. Note that
``torch.autograd.graph.save_on_cpu`` around a checkpoint would not do it:
it does not move a checkpoint's inputs, and it would move every other
saved tensor of the region too. ``partition_activations`` (the GPT model's
``cfg.partition_activations``, which the engine sets from the config) is
:func:`partitioned_checkpoint`: a tp rank keeps its ``S / tp`` rows of the
block input and gathers the rest from its tp partners before the
recompute (the TPU package's ``tp_shard_sequence``, reference
checkpointing.py:493); where tp does not divide S it warns once and the
block keeps its whole input, as the TPU package does. The knobs with no mapping here
(``contiguous_checkpointing``, ``synchronize``, ``profile``) raise, as in
the TPU package. The reference's RNG tracker has no counterpart: the
port's models draw no random numbers in a checkpointed block.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from ..utils.logging import logger

_config: Optional[Dict[str, Any]] = None


class HostCheckpoints:
    """The tensors checkpoints keep in host memory, by index in the order
    they were saved. Each host copy belongs to the checkpoint that saved it
    (:meth:`save` hands it back, and the autograd graph holds it); the
    store keeps only a weak reference, so a forward whose backward never
    runs frees its copies with its graph. On a CUDA device each copy runs
    on a side stream into page-locked memory, and the device tensor is
    recorded on that stream so that the allocator reuses its memory only
    once the copy is done, with no wait on the host (the caching host
    allocator likewise keeps a page-locked block until its copies have
    run); a load brings its tensor back and starts fetching the one saved
    before it, since the backward walks the checkpoints in reverse. On the
    CPU the copies are plain clones."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        # index -> a weak reference to its host copy; None once loaded or
        # freed with its graph
        self.host: List[Optional[weakref.ref]] = []
        self._fetched: Dict[int, Any] = {}   # index -> (copy, its event)
        self._live = 0                    # saved, neither loaded nor freed

    def _freed(self, i: int) -> None:
        """The host copy ``i`` died unloaded (its graph was dropped)."""
        if i < len(self.host) and self.host[i] is not None:
            self.host[i] = None
            self._fetched.pop(i, None)
            self._live -= 1

    def save(self, x: torch.Tensor) -> Tuple[int, torch.Tensor]:
        """Start the copy of ``x`` to the host: (its index, the copy, which
        the caller keeps until it loads it)."""
        if self._live == 0:               # nothing refers to old indices
            self.host.clear()
            self._fetched.clear()
        self._live += 1
        i = len(self.host)
        if not self.cuda:
            host = x.detach().clone()
        else:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.stream.wait_stream(torch.cuda.current_stream(x.device))
            with torch.cuda.stream(self.stream):
                host.copy_(x.detach(), non_blocking=True)
            x.record_stream(self.stream)
        self.host.append(weakref.ref(host, lambda _, i=i: self._freed(i)))
        return i, host

    def _start_fetch(self, i: int, host: torch.Tensor, device) -> None:
        if i < 0 or i in self._fetched or host is None:
            return
        with torch.cuda.stream(self.stream):
            dev = host.to(device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._fetched[i] = (dev, ev)

    def load(self, i: int, host: torch.Tensor, device) -> torch.Tensor:
        """Tensor ``i`` (whose host copy is ``host``) back on ``device``;
        the fetch of ``i - 1`` starts."""
        self._live -= 1
        self.host[i] = None
        if not self.cuda:
            return host
        self._start_fetch(i, host, device)
        dev, ev = self._fetched.pop(i)
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ev)
        dev.record_stream(stream)
        prev = self.host[i - 1] if i > 0 else None
        self._start_fetch(i - 1, None if prev is None else prev(), device)
        return dev


class OffloadedCheckpoint(torch.autograd.Function):
    """``run(*args)`` checkpointed with its tensor inputs in host memory:
    the forward runs it without grad and sends the tensors to ``store``;
    the backward brings them back (the latest first), runs ``run`` again
    under grad and backpropagates through it, the parameters' grads
    accumulating as in any backward (the reentrant checkpoint's scheme).
    Call it through :func:`offloaded_checkpoint`, whose anchor input makes
    the backward run, and so reach the parameters ``run`` closes over,
    when no tensor input needs grad."""

    @staticmethod
    def forward(ctx, store: HostCheckpoints, run, anchor, *args):
        ctx.store, ctx.run = store, run
        ctx.args = [(*store.save(a), a.device, a.requires_grad)
                    if isinstance(a, torch.Tensor) else (None, None, None, a)
                    for a in args]
        with torch.no_grad():
            return run(*args)

    @staticmethod
    def backward(ctx, *grads):
        args: List[Any] = [None] * len(ctx.args)
        for k in sorted(range(len(ctx.args)), reverse=True,
                        key=lambda k: -1 if ctx.args[k][0] is None
                        else ctx.args[k][0]):
            idx, host, device, spec = ctx.args[k]
            if idx is None:
                args[k] = spec
            else:
                args[k] = ctx.store.load(idx, host, device).detach() \
                    .requires_grad_(spec)
        ctx.args = None                  # the host copies go with it
        with torch.enable_grad():
            out = ctx.run(*args)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if isinstance(o, torch.Tensor) and o.requires_grad
                 and g is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return (None, None, None) + tuple(
            a.grad if isinstance(a, torch.Tensor) else None for a in args)


# A leaf that needs grad, handed to every offloaded checkpoint as an input:
# autograd then runs the checkpoint's backward even when no real input needs
# grad (a frozen embedding output, say), so the parameters the function
# closes over get their grads, as under the non-reentrant checkpoint and
# jax.checkpoint. Its own grad is always None.
_ANCHOR = torch.empty(0, requires_grad=True)


def offloaded_checkpoint(store: HostCheckpoints, run, *args):
    """``run(*args)`` under :class:`OffloadedCheckpoint` with its inputs in
    ``store``; the output needs grad whenever grad is enabled."""
    return OffloadedCheckpoint.apply(store, run, _ANCHOR, *args)


class PartitionedCheckpoint(torch.autograd.Function):
    """``run(x)`` checkpointed with only this tp rank's ``S / tp`` rows of
    its input ``x`` [B, S, ...] kept (every tp rank holds the same ``x``):
    the forward runs ``run`` without grad; the backward all-gathers the rows
    over the tp group, runs ``run`` again under grad and backpropagates
    through it (the reentrant scheme, as :class:`OffloadedCheckpoint`).
    The grad of ``x`` is the same on every tp rank (the block's collectives
    reduce it), so it is returned whole."""

    @staticmethod
    def forward(ctx, group, run, anchor, x):
        from ..module_inject.layers import _slice
        ctx.group, ctx.run = group, run
        ctx.needs = x.requires_grad
        ctx.save_for_backward(_slice(x.detach(), group, 1))
        with torch.no_grad():
            return run(x)

    @staticmethod
    def backward(ctx, *grads):
        from ..module_inject.layers import _gather
        (rows,) = ctx.saved_tensors
        x = _gather(rows, ctx.group, 1).detach().requires_grad_(ctx.needs)
        with torch.enable_grad():
            out = ctx.run(x)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if isinstance(o, torch.Tensor) and o.requires_grad
                 and g is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return None, None, None, x.grad


_partition_warned = set()


def partitionable(x: torch.Tensor, group) -> bool:
    """Whether ``x`` [B, S, ...] partitions over the tp ``group``: more
    than one rank, and S divisible by it. Warns once a shape where S does
    not divide (the block then keeps its whole input)."""
    n = 1 if group is None else group.size
    if n <= 1 or x.dim() < 3:
        return False
    if x.shape[1] % n:
        key = (tuple(x.shape), n)
        if x.shape[1] > 1 and key not in _partition_warned:
            _partition_warned.add(key)
            logger.warning(
                f"partition_activations dropped: seq dim {x.shape[1]} of a "
                f"{tuple(x.shape)} tensor is not divisible by tp={n}; "
                f"activations stay whole for this shape")
        return False
    return True


def partitioned_checkpoint(group, run, x: torch.Tensor):
    """``run(x)`` under :class:`PartitionedCheckpoint` over the tp
    ``group``; the output needs grad whenever grad is enabled."""
    return PartitionedCheckpoint.apply(group, run, _ANCHOR, x)


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
        return offloaded_checkpoint(_store(device), function, *args)
    return torch_checkpoint.checkpoint(function, *args, use_reentrant=False)
