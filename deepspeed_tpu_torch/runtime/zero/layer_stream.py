"""Layer-streamed training: the card holds one transformer block's
parameters at a time.

Counterpart of ``deepspeed_tpu/runtime/zero/layer_stream.py`` (reference:
the partitioned-parameter coordinator and its swapper,
partitioned_param_coordinator.py:240 and partitioned_param_swapper.py:37,
which train 13B-40B models on one 32 GB GPU). The parameters live in the
host optimizer's mirrors (``HostOffloadOptimizer``: pinned DRAM, or files
on the NVMe param tier) and stream through the card a block at a time:

  forward : an explicit loop over the blocks. Block i + 1's parameters are
            copied to the card on a copy stream into the second of two
            device buffer sets while block i computes on the first, ordered
            by events (the coordinator's prefetch ahead); the last
            iteration skips the dead prefetch. Only the layer inputs are
            kept, [L, B, S, D] in the compute dtype.
  head    : the loss and its cotangent by autograd over the resident
            parameters (embeddings, final norm, head), which are uploaded
            from the mirrors at the step's start and freed at its end.
  backward: the blocks in reverse, each fetched again (prefetching i - 1),
            replayed under ``torch.enable_grad()`` from its saved input and
            backpropagated. Its f32 grads go to page-locked host memory on a
            copy stream and are summed into the host optimizer's grad
            buffers (written in place by a step's first micro-batch, added
            to by the others); the finite flag stays on the card and is
            read once a step.
  prefix  : backward to the resident grads.
  update  : the engine takes the global norm (resident norms from the card,
            block norms from the host buffers, in leaf order), clips, and
            the host CPU Adam steps every leaf.

A micro-step fetches 2·L blocks (L in the forward, L in the backward) and
emits L; an eval fetches L. Between steps the card holds nothing of the
model: no block parameter, no resident parameter, no grad accumulator.
The device holds at most two block buffer sets, one block's f32 grads in
flight, the resident parameters and their f32 grads, and the layer inputs:
independent of depth apart from that [L, B, S, D] stack.

Model-agnostic through ``StackedPipeSpec`` (``runtime/pipe/spmd.py``):
GPT and BERT MLM expose ``stacked_spec``. One process, one card.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from ...comm import comm
from ...ops.aio import AsyncIOHandle, aligned_empty
from ..pipe.spmd import layer_of


class _CopyTimer:
    """CUDA event pairs and bytes of the copies one direction makes while
    a step is timed."""

    def __init__(self, timing: Optional[Dict[str, Any]], kind: str):
        self.timing, self.kind = timing, kind

    def copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        if self.timing is None:
            dst.copy_(src, non_blocking=True)
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        self.timing[f"{self.kind}_events"].append((start, end))
        self.timing[f"{self.kind}_bytes"] += src.numel() * src.element_size()


class LayerStreamer:
    """Host side of the streamed step: per-layer fetches from the mirrors
    into two device buffer sets, and the grad emits into the host
    optimizer's f32 grad buffers.

    ``fetches`` / ``emits`` count layer fetches and emits;
    ``peak_buffer_sets`` the most device buffer sets alive at once."""

    def __init__(self, host_optimizer, spec, compute_dtype,
                 device: torch.device) -> None:
        self.opt = host_optimizer
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._validate()
        L = spec.num_layers
        self.num_layers = L
        # leaf bookkeeping in the optimizer's (the model's) order
        self.block_idx: List[int] = []
        self.resident_idx: List[int] = []
        self.layers: List[List[int]] = [[] for _ in range(L)]
        self.local_names: List[List[str]] = [[] for _ in range(L)]
        for i, leaf in enumerate(self.opt.leaves):
            where = layer_of(leaf.path, spec.blocks_key)
            if where is None:
                self.resident_idx.append(i)
                continue
            layer, local = where
            if not 0 <= layer < L:
                raise ValueError(f"layer streaming: {leaf.path} is past the "
                                 f"{L} layers of the spec")
            self.block_idx.append(i)
            self.layers[layer].append(i)
            self.local_names[layer].append(local)
        if not self.block_idx:
            raise ValueError(f"layer streaming: no '{spec.blocks_key}.*' "
                             f"leaves found")
        first = [(n, self.opt.leaves[i].shape)
                 for n, i in zip(self.local_names[0], self.layers[0])]
        for layer in range(1, L):
            got = [(n, self.opt.leaves[i].shape) for n, i in
                   zip(self.local_names[layer], self.layers[layer])]
            if got != first:
                raise ValueError(
                    f"layer streaming needs identical blocks: layer {layer} "
                    f"has {got}, layer 0 {first}")
        self.names = self.local_names[0]
        self.shapes = [self.opt.leaves[i].shape for i in self.layers[0]]
        self.numels = [self.opt.leaves[i].global_numel
                       for i in self.layers[0]]
        self.block_numel = sum(self.numels)
        # the scaled f32 grad sums of the streamed leaves: the host
        # optimizer's own (page-locked) grad buffers, which its step reads
        self.grad_bufs: Dict[int, torch.Tensor] = {
            i: self.opt.grad_staging[i] for i in self.block_idx}
        self.fetches = 0
        self.emits = 0
        self.peak_buffer_sets = 0
        self.timing: Optional[Dict[str, Any]] = None
        self._sets: List[List[torch.Tensor]] = []
        self._fresh = True
        self._pending: List[Any] = []
        if self.cuda:
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
        nvme = self.opt.mirror_store is not None
        # the NVMe param tier reads each fetched block's leaf files into
        # page-locked staging, one buffer and one aio handle a buffer set
        self._staging = [aligned_empty(self.opt.staging_bytes(
            self.layers[0]), torch.uint8, pin=self.cuda)
            for _ in range(2)] if nvme else None
        self._aio = [AsyncIOHandle(num_threads=2) for _ in range(2)] \
            if nvme else None
        # the later micro-batches' grads land here before the host add
        # (allocated at the first such emit: gas 1 never needs them)
        self._grad_landing: Optional[List[torch.Tensor]] = None

    def _validate(self) -> None:
        bad = []
        if comm.get_world_size() > 1 or self.opt.dp_shard != (0, 1, 1):
            bad.append("multi-process dp")
        if self.spec.dtype is not None and \
                self.spec.dtype != self.compute_dtype:
            bad.append(f"model dtype {self.spec.dtype} != engine compute "
                       f"dtype {self.compute_dtype} (the carry must keep "
                       f"one dtype across blocks)")
        if bad:
            raise ValueError(
                "offload_param.layer_streaming does not support: "
                + ", ".join(bad) + " (the streamed step drives the "
                "stacked-trunk structure directly)")

    def _block_views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """A flat buffer of one block's elements as its leaves' shapes."""
        views, at = [], 0
        for n, shape in zip(self.numels, self.shapes):
            views.append(flat[at:at + n].view(shape))
            at += n
        return views

    # ------------------------------------------------------ device buffers
    def open(self) -> None:
        """Allocate the two device buffer sets (one block's parameters
        each, in the compute dtype) for a step."""
        self._sets = [self._block_views(torch.empty(
            self.block_numel, dtype=self.compute_dtype, device=self.device))
            for _ in range(2)]
        self._ready = [None, None]        # fetch done
        self._free = [None, None]         # last compute on the set done
        self.peak_buffer_sets = max(self.peak_buffer_sets, len(self._sets))

    def close(self) -> None:
        """Wait for the copies in flight, finish the pending grad adds and
        free the device buffers."""
        if self.cuda:
            self._h2d.synchronize()
            self._d2h.synchronize()
        self._finish_adds()
        self._sets, self._ready, self._free = [], [None, None], [None, None]

    def fetch_layer(self, i: int, s: int) -> None:
        """Layer ``i``'s parameters into buffer set ``s`` (on the copy
        stream, after the set's last reader)."""
        self.fetches += 1
        dst = self._sets[s]
        if self._staging is not None:
            if self._ready[s] is not None:
                self._ready[s].synchronize()   # staging s read by its H2D
            srcs = self.opt.start_mirror_reads(self.layers[i],
                                               self._staging[s], self._aio[s])
            self._aio[s].wait()
        else:
            srcs = [self.opt.mirror_flat(li) for li in self.layers[i]]
        if not self.cuda:
            for d, src, n in zip(dst, srcs, self.numels):
                d.view(-1).copy_(src[:n])
            return
        if self._free[s] is not None:
            self._h2d.wait_event(self._free[s])
        timer = _CopyTimer(self.timing, "h2d")
        with torch.cuda.stream(self._h2d):
            for d, src, n in zip(dst, srcs, self.numels):
                timer.copy(d.view(-1), src[:n])
            ev = torch.cuda.Event()
            ev.record(self._h2d)
        self._ready[s] = ev

    def layer_params(self, s: int, grad: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """Buffer set ``s`` by the names inside a block, for the compute
        stream (it waits for the set's fetch)."""
        if self.cuda and self._ready[s] is not None:
            torch.cuda.current_stream(self.device).wait_event(self._ready[s])
        return {n: (t.detach().requires_grad_() if grad else t)
                for n, t in zip(self.names, self._sets[s])}

    def release(self, s: int) -> None:
        """The compute stream is done with buffer set ``s`` once the work
        issued so far has run."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._free[s] = ev

    # --------------------------------------------------------- grad emits
    def reset_grads(self) -> None:
        """The next emits start the step's sums (they write the buffers in
        place; later micro-batches add)."""
        self._fresh = True

    def end_micro(self) -> None:
        """A micro-batch's emits are issued: the next ones add."""
        self._fresh = False

    def emit_layer(self, i: int, grads: Sequence[torch.Tensor]) -> None:
        """Layer ``i``'s scaled grads (in the compute dtype, on the card)
        as f32 to the host buffers."""
        self.emits += 1
        g32 = [g.float() for g in grads]
        dsts = [self.grad_bufs[li][:n].view(shape) for li, n, shape in
                zip(self.layers[i], self.numels, self.shapes)]
        targets = dsts
        if not self._fresh:
            # the other landing buffer may still be filling; this one's
            # last add is done once at most one emit is pending
            self._finish_adds(keep=1)
            if self._grad_landing is None:
                self._grad_landing = [aligned_empty(
                    self.block_numel, torch.float32, pin=self.cuda)
                    for _ in range(2)]
            targets = self._block_views(self._grad_landing[self.emits % 2])
        if not self.cuda:
            for t, g in zip(targets, g32):
                t.copy_(g)
        else:
            self._d2h.wait_stream(torch.cuda.current_stream(self.device))
            timer = _CopyTimer(self.timing, "d2h")
            with torch.cuda.stream(self._d2h):
                for t, g in zip(targets, g32):
                    timer.copy(t, g)
                    g.record_stream(self._d2h)
                ev = torch.cuda.Event()
                ev.record(self._d2h)
        if not self._fresh:
            self._pending.append((ev if self.cuda else None, dsts, targets))
            if not self.cuda:
                self._finish_adds()

    def _finish_adds(self, keep: int = 0) -> None:
        """Add the landed grads of all but the last ``keep`` pending emits
        into the host buffers."""
        while len(self._pending) > keep:
            ev, dsts, views = self._pending.pop(0)
            if ev is not None:
                ev.synchronize()
            for d, v in zip(dsts, views):
                d.add_(v)

    def block_norms(self) -> Dict[int, torch.Tensor]:
        """Each streamed leaf's grad-sum norm (host, f32), by leaf index:
        the clipping norm's host part. The TPU streamer sums their squares
        (``blocks_grad_sq``); the engine here stacks them with the resident
        norms in leaf order, as the plain offload step stacks its leaves'
        norms, so the two clip alike."""
        bufs = [self.grad_bufs[i] for i in self.block_idx]
        return dict(zip(self.block_idx, torch._foreach_norm(bufs)))

    def _resident_mirror(self, i: int) -> torch.Tensor:
        """Resident leaf i's mirror as a host tensor of its shape (on the
        NVMe tier a view of the store's staging: valid until its next
        read)."""
        leaf = self.opt.leaves[i]
        return self.opt.mirror_flat(i)[:leaf.global_numel].reshape(
            leaf.shape)

    def upload_resident(self) -> Dict[str, torch.Tensor]:
        """The resident parameters on the card for one step."""
        out = {}
        timer = _CopyTimer(self.timing, "h2d") if self.cuda else None
        for i in self.resident_idx:
            t = self._resident_mirror(i)
            dev = torch.empty(t.shape, dtype=self.compute_dtype,
                              device=self.device)
            if timer is None or self.opt.mirror_store is not None:
                dev.copy_(t)            # the NVMe tier's shared staging
            else:
                timer.copy(dev, t)
            out[self.opt.leaves[i].path] = dev
        return out

    def grads_flat_all(self) -> List[torch.Tensor]:
        """Every leaf's grad sum in leaf order: the host optimizer's grad
        buffers, which the resident grads were copied into."""
        return list(self.opt.grad_staging)

    def close_io(self) -> None:
        """Stop the aio threads of the NVMe staging."""
        for h in self._aio or ():
            h.close()


def _grad_of(outputs, inputs, grad_outputs):
    """torch.autograd.grad with zeros for the inputs the outputs do not
    reach."""
    got = torch.autograd.grad(outputs, inputs, grad_outputs,
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(got, inputs)]


def _forward(streamer: LayerStreamer, res, batch, keep: bool):
    """The streamed forward: (trunk output, its layer inputs, aux)."""
    spec, L = streamer.spec, streamer.num_layers
    with torch.no_grad():
        x, aux = spec.prefix(res, batch)
        if isinstance(aux, torch.Tensor):
            aux = aux.detach()
        xs: List[Optional[torch.Tensor]] = []
        streamer.fetch_layer(0, 0)
        for i in range(L):
            s = i % 2
            if i + 1 < L:
                streamer.fetch_layer(i + 1, 1 - s)
            p = streamer.layer_params(s)
            if keep:
                xs.append(x)
            x = spec.block(p, x, aux)
            streamer.release(s)
    return x, xs, aux


def build_streamed_eval(streamer: LayerStreamer):
    """Forward-only streamed loss: ``ev(resident, batch) -> loss``; the
    full model never sits on the card here either."""

    def ev(res, batch):
        streamer.open()
        try:
            x, _, _ = _forward(streamer, res, batch, keep=False)
            with torch.no_grad():
                return streamer.spec.suffix_loss(res, x, batch)
        finally:
            streamer.close()

    return ev


def build_streamed_step(streamer: LayerStreamer, gas: int):
    """The streamed train function: ``train(resident, batches, scale) ->
    (resident grad sums {name: f32 tensor}, metrics)``. The block grads
    leave through the emits into the host buffers; ``metrics`` holds the
    mean loss and the card's finite flag over every grad."""
    spec, L = streamer.spec, streamer.num_layers

    def micro_grads(res, batch, scale, finite):
        x_last, xs, aux = _forward(streamer, res, batch, keep=True)
        names = list(res)
        leaves = [res[n].detach().requires_grad_() for n in names]
        live = dict(zip(names, leaves))
        # head: the loss and its cotangents
        xl = x_last.detach().requires_grad_()
        with torch.enable_grad():
            loss = spec.suffix_loss(live, xl, batch)
            scaled = loss.float() * scale
        *d_head, dx = _grad_of(scaled, leaves + [xl], None)
        del scaled, xl, x_last
        # blocks in reverse: fetch again, replay, backpropagate, emit
        streamer.fetch_layer(L - 1, 0)
        for j, i in enumerate(range(L - 1, -1, -1)):
            s = j % 2
            if i > 0:
                streamer.fetch_layer(i - 1, 1 - s)
            p = streamer.layer_params(s, grad=True)
            xi = xs[i].detach().requires_grad_()
            xs[i] = None
            with torch.enable_grad():
                y = spec.block(p, xi, aux)
            *dp, dx = _grad_of(y, list(p.values()) + [xi], dx.to(y.dtype))
            del y, xi, p
            streamer.release(s)
            for g in dp:
                finite &= torch.isfinite(g).all()
            streamer.emit_layer(i, dp)
            del dp
        streamer.end_micro()
        # prefix: the resident grads through the embeddings
        with torch.enable_grad():
            x0 = spec.prefix(live, batch)[0]
        d_embed = _grad_of(x0, leaves, dx.to(x0.dtype))
        # summed in the parameters' dtype, as autograd sums a parameter
        # used twice (the tied embedding)
        d_res = {n: a + b for n, a, b in zip(names, d_head, d_embed)}
        return d_res, loss.detach(), finite

    def train(res, batches, scale):
        streamer.open()
        try:
            streamer.reset_grads()
            acc = {n: torch.zeros(t.shape, dtype=torch.float32,
                                  device=t.device) for n, t in res.items()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=streamer.device)
            finite = torch.ones((), dtype=torch.bool, device=streamer.device)
            for batch in batches:
                d_res, loss, finite = micro_grads(res, batch, scale, finite)
                for n, g in d_res.items():
                    acc[n] += g.float()
                    finite &= torch.isfinite(acc[n]).all()
                loss_sum += loss.float()
        finally:
            streamer.close()
        return acc, {"loss": loss_sum / gas, "finite": finite}

    return train


def streamed_update(engine, micros) -> Dict[str, Any]:
    """One streamed optimizer step of ``engine`` (its ``train_batch`` under
    ``offload_param.layer_streaming``): the streamed fwd/bwd over the
    micro-batches, the resident grads to the host buffers, the global norm
    (leaf order), clipping, the host step and the loss scale (the TPU
    engine's ``_streamed_train_batch``)."""
    st: LayerStreamer = engine._layer_streamer
    host = engine.host_optimizer
    gas = engine.gradient_accumulation_steps()
    timing = engine.offload_timing
    if timing is not None:
        timing.clear()
        timing.update(d2h_events=[], h2d_events=[], d2h_bytes=0,
                      h2d_bytes=0)
        t0 = time.perf_counter()
    st.timing = timing
    scale = engine._scale.cur_scale
    denom = scale * gas
    if engine.config.prescale_gradients:
        denom *= engine.config.gradient_predivide_factor
    if engine._stream_step is None:
        engine._stream_step = build_streamed_step(st, gas)
    batches = [engine._to_device(b) for b in micros]
    res = st.upload_resident()
    acc, metrics = engine._stream_step(res, batches, scale)
    del res
    with torch.no_grad():
        res_norms = dict(zip(acc, torch._foreach_norm(list(acc.values()))))
        # the resident grad sums to the host buffers (f32, undivided)
        path_of = {host.leaves[i].path: i for i in st.resident_idx}
        for name, a in acc.items():
            dst = host.grad_staging[path_of[name]][:a.numel()]
            dst.copy_(a.view(-1))
        finite = bool(metrics["finite"])
        if timing is not None:
            timing["device_fwd_bwd_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        norms = st.block_norms()
        if timing is not None:
            timing["host_norm_s"] = time.perf_counter() - t1
        for name, n in res_norms.items():
            norms[path_of[name]] = n.cpu()
        gnorm = (torch.stack([norms[i] for i in range(len(host.leaves))])
                 / denom).square().sum().sqrt()
        gn = float(gnorm)
        del acc
        if finite:
            clip = engine.gradient_clipping()
            combined = denom
            if clip and clip > 0 and gn > clip:
                combined *= gn / clip
            t1 = time.perf_counter()
            host.step(st.grads_flat_all(), engine._offload_lr(), combined)
            if timing is not None:
                timing["host_step_s"] = time.perf_counter() - t1
        else:
            engine.skipped_steps += 1
    st.timing = None
    if timing is not None:
        timing["update_s"] = time.perf_counter() - t0
        for kind in ("d2h", "h2d"):
            evs = timing.pop(f"{kind}_events")
            timing[f"{kind}_s"] = sum(a.elapsed_time(b) for a, b in evs) / 1e3
    return {"grad_norm": gn, "finite": finite, "loss": metrics["loss"]}
