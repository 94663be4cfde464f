"""ZeRO-Offload / ZeRO-Infinity: the optimizer state in host DRAM or on NVMe.

Counterpart of ``deepspeed_tpu/runtime/zero/offload.py``. Reference
analogues:
  * ZeRO-Offload: grads stream to the host, CPU-Adam steps the fp32 master
    partition, the updated 16-bit params stream back
    (``runtime/zero/stage_1_and_2.py:1014`` async grad offload +
    ``ops/adam/cpu_adam.py`` + the step-tail all-gather);
  * ZeRO-Infinity: optimizer state tiered to NVMe with windowed
    swap-in / step / swap-out overlap
    (``swap_tensor/pipelined_optimizer_swapper.py:61``), and the param tier
    (``swap_tensor/partitioned_param_swapper.py:37``).

Here every host buffer is a flat CPU tensor. Each process is one dp rank
and owns, per leaf, the contiguous slice ``dp_shard=(rank_start,
rank_count, world)`` names, the layout of the port's ZeRO partitions
(``runtime/sharding.py``). The native SIMD Adam (``ops/cpu_adam.py``)
steps master and moments and, for a bf16 model, writes the bf16 mirror the
card reads back. The mirror and the grad staging the card writes into are
page-locked (``ops/aio.aligned_empty(pin=True)``), so both copies run
asynchronously at the link's rate.

Memory model per parameter on this rank's slice:
  * device=cpu : master (4B) + moments (8B) in DRAM, plus the 16-bit
    mirror (2B) and the fp32 grad staging (4B), both pinned;
  * device=nvme: master and moments (12B) live in per-leaf files; DRAM holds
    the mirror, the staging and a window of swap buffers sized by the
    largest leaf (``NVMeLeafSwapper``). With the param tier
    (``mirror_nvme_path``) the mirrors move to files too.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...checkpoint import zero_to_fp32
from ...convert import FlaxLeaf
from ...ops.aio import AsyncIOHandle, aligned_empty, padded_nbytes
from ...ops.cpu_adam import DeepSpeedCPUAdam, f32_to_bf16_bits
from ...utils.logging import log_dist
from .partition_params import (DEFAULT_INIT_RULES, fill_param_slice,
                               fill_pool)

MOMENTS = ("exp_avg", "exp_avg_sq")


def _flat_views(buf: torch.Tensor, sizes: Sequence[int]) -> List[torch.Tensor]:
    out, at = [], 0
    for n in sizes:
        out.append(buf[at:at + n])
        at += n
    return out


def to_mirror(master: torch.Tensor, out: torch.Tensor) -> None:
    """The 16-bit (or f32) mirror of an f32 master, rounded as the native
    step rounds it (round to nearest even)."""
    if out.dtype == torch.bfloat16:
        f32_to_bf16_bits(master, out=out)
    else:
        out.copy_(master)


class _Leaf:
    """Host bookkeeping of this rank's slice of one parameter leaf: the
    flattened leaf is zero-padded to a multiple of ``world`` and this rank
    owns ``numel`` elements from ``offset`` (the reference's flat-partition
    scheme, stage_1_and_2.py:228-254). In DRAM mode it owns the master and
    moment tensors of the slice; in NVMe mode master and moments live in the
    swap file, staged through the swapper's slots."""

    def __init__(self, path: str, shape, shard):
        self.path = path
        self.shape = tuple(shape)
        self.global_numel = int(np.prod(self.shape)) if self.shape else 1
        rank_start, rank_count, world = shard
        self.shard_len = -(-self.global_numel // world)  # ceil
        self.padded = self.shard_len * world
        self.offset = rank_start * self.shard_len
        self.numel = rank_count * self.shard_len          # local numel
        self.valid = max(min(self.numel, self.global_numel - self.offset), 0)
        self.master: Optional[torch.Tensor] = None
        self.exp_avg: Optional[torch.Tensor] = None
        self.exp_avg_sq: Optional[torch.Tensor] = None
        self.mirror: Optional[torch.Tensor] = None   # DRAM mirror view

    def meta(self) -> Dict:
        return {"path": self.path, "offset": int(self.offset),
                "numel": int(self.numel), "padded": int(self.padded),
                "global_numel": int(self.global_numel),
                "shape": list(self.shape)}


class MirrorNVMeStore:
    """ZeRO-Infinity's PARAM tier (reference
    swap_tensor/partitioned_param_swapper.py:37): the 16-bit mirrors live in
    per-leaf files; DRAM holds ONE staging buffer sized to the largest leaf
    slice, page-locked when the card reads from it. With
    offload_optimizer=nvme as well, host DRAM is O(largest leaf)."""

    def __init__(self, path: str, max_nbytes: int, aio_cfg=None,
                 pin: bool = False):
        os.makedirs(path, exist_ok=True)
        self.path = path
        kw = {}
        if aio_cfg is not None:
            kw = dict(block_size=aio_cfg.block_size,
                      queue_depth=aio_cfg.queue_depth,
                      num_threads=aio_cfg.thread_count)
        self.handle = AsyncIOHandle(**kw)
        # DIRECT_ALIGN-aligned so every transfer can run O_DIRECT
        self._staging = aligned_empty(max_nbytes, torch.uint8, pin=pin)

    def _file(self, idx: int) -> str:
        return os.path.join(self.path, f"mirror_{idx}.bin")

    def staging_view(self, nbytes: int) -> torch.Tensor:
        return self._staging[:nbytes]

    def write_staged(self, idx: int, nbytes: int) -> None:
        """Write the first ``nbytes`` of the staging buffer to leaf idx."""
        padded = padded_nbytes(nbytes)
        self._staging[nbytes:padded].zero_()   # no stale bytes on disk
        self.handle.sync_pwrite(self._staging[:padded], self._file(idx),
                                direct=True)

    def read(self, idx: int, nbytes: int) -> torch.Tensor:
        """Leaf idx's bytes in the staging buffer (valid until the next
        read or write)."""
        view = self._staging[:padded_nbytes(nbytes)]
        self.handle.sync_pread(view, self._file(idx), direct=True)
        return view[:nbytes]

    def start_read(self, idx: int, nbytes: int, dst: torch.Tensor,
                   handle: AsyncIOHandle) -> torch.Tensor:
        """Start reading leaf idx's bytes into ``dst`` (a uint8 view of an
        :func:`aligned_empty` buffer, at least ``padded_nbytes(nbytes)``
        long, at an aligned offset) on ``handle``; the bytes are there after
        ``handle.wait()``. Returns their view."""
        handle.async_pread(dst[:padded_nbytes(nbytes)], self._file(idx),
                           direct=True)
        return dst[:nbytes]

    def close(self) -> None:
        self.handle.close()


class NVMeLeafSwapper:
    """Per-leaf [master | exp_avg | exp_avg_sq] files with windowed async
    swap (reference PipelinedOptimizerSwapper:61). DRAM footprint is
    ``num_slots`` buffers of 3x the largest leaf: 1 (the leaf being
    stepped) + the prefetch depth (from ``stage3_prefetch_bucket_size``) +
    1 draining slot, so read(i+depth) ∥ step(i) ∥ write(i-1) never stalls.
    Each slot owns its own read and write handle, so waiting for leaf i's
    data never blocks on the deeper prefetches still in flight."""

    @staticmethod
    def slot_count(depth: int) -> int:
        return depth + 2

    @staticmethod
    def window_depth(max_numel: int, prefetch_numel: int = 0) -> int:
        """How many leaves ride ahead of the one being stepped (1 without
        a budget; capped at 7 = 9 slots)."""
        if not prefetch_numel:
            return 1
        return max(1, min(int(prefetch_numel) // max(max_numel, 1), 7))

    def __init__(self, nvme_path: str, max_numel: int, aio_cfg=None,
                 prefetch_numel: int = 0):
        self.dir = os.path.join(nvme_path, "zero_offload_swap")
        os.makedirs(self.dir, exist_ok=True)
        bs = getattr(aio_cfg, "block_size", 1 << 20)
        qd = getattr(aio_cfg, "queue_depth", 8)
        depth = self.window_depth(max_numel, prefetch_numel)
        if prefetch_numel and depth == 1 and prefetch_numel < max_numel:
            log_dist(
                f"stage3_prefetch_bucket_size={prefetch_numel:,} is smaller "
                f"than the largest optimizer leaf ({max_numel:,} elements); "
                f"the swap window stays at the default depth of 1", ranks=[0])
        self.prefetch_depth = depth
        self.num_slots = self.slot_count(depth)
        # one op in flight per handle -> a single IO thread each
        self.read_handles = [AsyncIOHandle(block_size=bs, queue_depth=qd,
                                           num_threads=1)
                             for _ in range(self.num_slots)]
        self.write_handles = [AsyncIOHandle(block_size=bs, queue_depth=qd,
                                            num_threads=1)
                              for _ in range(self.num_slots)]
        # aligned + padded-record I/O => every swap can run O_DIRECT
        self.slots = [aligned_empty(3 * max_numel, torch.float32)
                      for _ in range(self.num_slots)]

    @property
    def handles(self) -> List[AsyncIOHandle]:
        return self.read_handles + self.write_handles

    @staticmethod
    def _rec_f32(numel: int) -> int:
        """float32 length of one padded [master|m|v] record."""
        return padded_nbytes(3 * numel * 4) // 4

    def _file(self, idx: int) -> str:
        return os.path.join(self.dir, f"leaf_{idx}.bin")

    def write_init(self, idx: int, master: torch.Tensor) -> None:
        """The leaf's first record: ``master`` and zero moments."""
        n = master.numel()
        rec = self.slots[0][:self._rec_f32(n)]
        rec.zero_()
        rec[:n].copy_(master)
        self.write_handles[0].sync_pwrite(rec, self._file(idx), direct=True)

    def start_read(self, idx: int, numel: int, slot: int) -> None:
        # the slot's previous occupant must be flushed before overwriting
        self.write_handles[slot].wait()
        view = self.slots[slot][:self._rec_f32(numel)]
        self.read_handles[slot].async_pread(view, self._file(idx),
                                            direct=True)

    def finish_read(self, slot: int) -> None:
        self.read_handles[slot].wait()

    def views(self, numel: int, slot: int):
        buf = self.slots[slot]
        return (buf[:numel], buf[numel:2 * numel], buf[2 * numel:3 * numel])

    def start_write(self, idx: int, numel: int, slot: int) -> None:
        rec = self._rec_f32(numel)
        # zero the alignment tail: never persist stale bytes of a prior
        # (larger) occupant of this slot
        self.slots[slot][3 * numel:rec].zero_()
        self.write_handles[slot].async_pwrite(
            self.slots[slot][:rec], self._file(idx), direct=True)

    def finish_writes(self) -> None:
        for h in self.write_handles:
            h.wait()

    def read_sync(self, idx: int, numel: int, slot: int = 0):
        self.start_read(idx, numel, slot)
        self.finish_read(slot)
        return self.views(numel, slot)

    def write_sync(self, idx: int, numel: int, slot: int = 0) -> None:
        self.start_write(idx, numel, slot)
        self.write_handles[slot].wait()

    def close(self) -> None:
        for h in self.handles:
            h.close()


class HostOffloadOptimizer:
    """Flat per-leaf host master + Adam moments of this rank's slices;
    optional NVMe tiers for the optimizer state and for the mirrors.

    ``params``: ``(name, tensor)`` pairs in the model's order. A real
    tensor's slice is copied in; a meta tensor's is generated by the
    counter fill at the flax element indices of ``flax_leaves[name]``
    (``partition_params.flax_leaves``), so only this rank's slice is ever
    allocated. ``mirror_dtype`` is the compute dtype; ``pin`` page-locks the
    mirror and the grad staging (the card copies them)."""

    STATE = MOMENTS

    def __init__(self, params: Sequence[Tuple[str, torch.Tensor]], *,
                 lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw: bool = True,
                 mirror_dtype=torch.bfloat16,
                 nvme_path: Optional[str] = None, aio_cfg=None,
                 dp_shard=(0, 1, 1), init_seed: Optional[int] = None,
                 flax_leaves: Optional[Dict[str, FlaxLeaf]] = None,
                 mirror_nvme_path: Optional[str] = None, init_rules=None,
                 prefetch_numel: int = 0, pin: bool = False):
        """``dp_shard=(rank_start, rank_count, dp_world)``: this process
        owns the contiguous dp-rank range [rank_start, rank_start +
        rank_count) of every flat-partitioned leaf."""
        self.opt = DeepSpeedCPUAdam(lr=lr, betas=betas, eps=eps,
                                    weight_decay=weight_decay,
                                    adamw_mode=adamw)
        self.step_count = 0
        self.adam_s = 0.0            # the last step's time in the native step
        self.nvme = nvme_path is not None
        self.dp_shard = tuple(dp_shard)
        self.mirror_dtype = mirror_dtype
        params = list(params)
        self.leaves: List[_Leaf] = [
            _Leaf(name, t.shape, self.dp_shard) for name, t in params]
        sizes = [l.numel for l in self.leaves]
        # the grad staging and the mirror: one page-locked buffer each
        self._staging = aligned_empty(sum(sizes), torch.float32, pin=pin)
        self._staging.zero_()         # the slices' padding stays zero
        self.grad_staging = _flat_views(self._staging, sizes)
        f32_mirror = mirror_dtype == torch.float32
        self._mirror = None
        if not mirror_nvme_path and not (f32_mirror and not self.nvme):
            self._mirror = aligned_empty(sum(sizes), mirror_dtype, pin=pin)
            for leaf, view in zip(self.leaves,
                                  _flat_views(self._mirror, sizes)):
                leaf.mirror = view
        self.swapper = None
        if self.nvme:
            self.swapper = NVMeLeafSwapper(nvme_path, max(sizes), aio_cfg,
                                           prefetch_numel=prefetch_numel)
        self.mirror_store = None
        if mirror_nvme_path:
            itemsize = torch.empty(0, dtype=mirror_dtype).element_size()
            self.mirror_store = MirrorNVMeStore(
                mirror_nvme_path, max(sizes) * itemsize, aio_cfg, pin=pin)
        rules = init_rules or DEFAULT_INIT_RULES
        seed = 0 if init_seed is None else init_seed
        with fill_pool() as pool:
            for i, (leaf, (name, t)) in enumerate(zip(self.leaves, params)):
                master = torch.zeros(leaf.numel, dtype=torch.float32)
                if leaf.valid:
                    if t.is_meta:
                        fill_param_slice(flax_leaves[name], leaf.offset,
                                         leaf.offset + leaf.valid,
                                         master[:leaf.valid], seed=seed,
                                         rules=rules, pool=pool)
                    else:
                        # a copy: the native step writes through raw
                        # pointers and must not alias the caller's tensor
                        master[:leaf.valid].copy_(t.detach().reshape(-1)[
                            leaf.offset:leaf.offset + leaf.valid])
                if self.nvme:
                    self.swapper.write_init(i, master)
                else:
                    leaf.master = master
                    leaf.exp_avg = torch.zeros_like(master)
                    leaf.exp_avg_sq = torch.zeros_like(master)
                self._sync_mirror(i, master)
        if self.nvme:
            log_dist(
                f"NVMe offload: master+moments for {len(self.leaves)} leaves "
                f"({self.numel():,} params, {12 * self.numel() / 1e9:.2f} GB)"
                f" swapped to {self.swapper.dir}; DRAM window = "
                f"{self.swapper.num_slots} x {3 * max(sizes) * 4 / 1e6:.1f} "
                f"MB (prefetch depth {self.swapper.prefetch_depth})",
                ranks=[0])

    # ------------------------------------------------------------- views
    @property
    def count(self) -> int:
        return self.step_count

    def numel(self) -> int:
        """LOCAL element count (this rank's slices)."""
        return sum(l.numel for l in self.leaves)

    def global_numel(self) -> int:
        return sum(l.global_numel for l in self.leaves)

    def handles(self) -> List[AsyncIOHandle]:
        """Every aio handle (for byte counts and O_DIRECT modes)."""
        out = [] if self.swapper is None else self.swapper.handles
        if self.mirror_store is not None:
            out.append(self.mirror_store.handle)
        return out

    def host_bytes(self) -> Dict[str, int]:
        """DRAM this rank's optimizer holds, by role."""
        n = self.numel()
        out = {"grad_staging": n * 4}
        if self._mirror is not None:
            out["mirror"] = self._mirror.numel() * self._mirror.element_size()
        if self.swapper is None:
            out["master_and_moments"] = 12 * n
        else:
            out["swap_slots"] = sum(s.numel() * 4 for s in self.swapper.slots)
        return out

    @property
    def mirror_itemsize(self) -> int:
        return torch.empty(0, dtype=self.mirror_dtype).element_size()

    def mirror_tree(self) -> Dict[str, torch.Tensor]:
        """Every leaf's mirror as a host tensor of its shape, in the compute
        dtype, by parameter name (a copy; this rank must hold whole leaves,
        as at dp 1)."""
        if self.dp_shard != (0, 1, 1):
            raise ValueError("mirror_tree needs whole leaves (dp 1)")
        return {leaf.path: self.mirror_flat(i)[:leaf.global_numel]
                .reshape(leaf.shape).clone()
                for i, leaf in enumerate(self.leaves)}

    def start_mirror_reads(self, indices: Sequence[int],
                           staging: torch.Tensor, handle: AsyncIOHandle
                           ) -> List[torch.Tensor]:
        """The NVMe param tier: start reading leaves ``indices``' mirror
        files into consecutive aligned slices of ``staging`` (uint8, from
        :func:`aligned_empty`, at least :meth:`staging_bytes` of them long)
        on ``handle``. Returns each leaf's flat mirror view, valid after
        ``handle.wait()``."""
        out, at = [], 0
        for i in indices:
            nbytes = self.leaves[i].numel * self.mirror_itemsize
            raw = self.mirror_store.start_read(i, nbytes, staging[at:],
                                               handle)
            out.append(raw.view(self.mirror_dtype))
            at += padded_nbytes(nbytes)
        return out

    def staging_bytes(self, indices: Sequence[int]) -> int:
        """The staging bytes :meth:`start_mirror_reads` needs for
        ``indices``."""
        return sum(padded_nbytes(self.leaves[i].numel * self.mirror_itemsize)
                   for i in indices)

    def mirror_flat(self, i: int) -> torch.Tensor:
        """Leaf i's flat mirror slice in the compute dtype. In the NVMe
        param tier it is read back into the store's staging buffer: valid
        until the next read (copy it out first)."""
        leaf = self.leaves[i]
        if self.mirror_store is not None:
            itemsize = torch.empty(0, dtype=self.mirror_dtype).element_size()
            raw = self.mirror_store.read(i, leaf.numel * itemsize)
            return raw.view(self.mirror_dtype)
        if leaf.mirror is not None:
            return leaf.mirror
        return leaf.master                      # an f32 model: the master

    def _sync_mirror(self, i: int, master: torch.Tensor) -> None:
        leaf = self.leaves[i]
        if self.mirror_store is not None:
            itemsize = torch.empty(0, dtype=self.mirror_dtype).element_size()
            nbytes = leaf.numel * itemsize
            to_mirror(master, self.mirror_store.staging_view(nbytes)
                      .view(self.mirror_dtype))
            self.mirror_store.write_staged(i, nbytes)
        elif leaf.mirror is not None:
            to_mirror(master, leaf.mirror)

    def _state(self, i: int, slot: int = 0):
        """(master, exp_avg, exp_avg_sq) of leaf i: the DRAM tensors, or
        the swapper slot's views after a synchronous read."""
        leaf = self.leaves[i]
        if self.swapper is not None:
            return self.swapper.read_sync(i, leaf.numel, slot)
        return leaf.master, leaf.exp_avg, leaf.exp_avg_sq

    def _write_back(self, i: int) -> None:
        if self.swapper is not None:
            self.swapper.write_sync(i, self.leaves[i].numel)

    def shard_state(self, i: int) -> Dict[str, torch.Tensor]:
        """Copies of leaf i's master and moments (this rank's slice)."""
        master, m, v = self._state(i)
        return {"master": master.clone(), "exp_avg": m.clone(),
                "exp_avg_sq": v.clone()}

    # ------------------------------------------------------------- step
    def step(self, grads: Sequence[torch.Tensor], lr: float,
             combined_scale: float = 1.0, on_leaf=None) -> None:
        """One optimizer step over all leaves. ``grads[i]`` is leaf i's
        flat f32 grad slice (indexing may block until it has arrived);
        ``combined_scale`` divides the grads (loss-scale unscaling x grad
        clipping). Grads in :attr:`grad_staging` are scaled in place, others
        are copied first. ``on_leaf(i)`` runs after leaf i's step (the
        engine starts that leaf's mirror upload there)."""
        self.step_count += 1
        self.adam_s = 0.0
        inv = (np.float32(1.0 / combined_scale)
               if combined_scale != 1.0 else None)
        n = len(self.leaves)
        if self.swapper is not None:
            sw, ns = self.swapper, self.swapper.num_slots
            # prime the prefetch window, then keep `prefetch_depth` leaves
            # in flight ahead of the one being stepped
            for j in range(min(sw.prefetch_depth, n)):
                sw.start_read(j, self.leaves[j].numel, slot=j % ns)
            for i, leaf in enumerate(self.leaves):
                slot = i % ns
                sw.finish_read(slot)
                nxt = i + sw.prefetch_depth
                if nxt < n:
                    sw.start_read(nxt, self.leaves[nxt].numel, slot=nxt % ns)
                master, m, v = sw.views(leaf.numel, slot)
                self._step_leaf(i, master, m, v, grads[i], lr, inv)
                sw.start_write(i, leaf.numel, slot)
                if on_leaf is not None:
                    on_leaf(i)
            sw.finish_writes()
            return
        for i, leaf in enumerate(self.leaves):
            self._step_leaf(i, leaf.master, leaf.exp_avg, leaf.exp_avg_sq,
                            grads[i], lr, inv)
            if on_leaf is not None:
                on_leaf(i)

    def _step_leaf(self, i, master, m, v, grad, lr, inv) -> None:
        leaf = self.leaves[i]
        g = grad.reshape(-1)
        if g.numel() != leaf.numel:
            raise ValueError(
                f"leaf {leaf.path}: grad shard has {g.numel()} elements, "
                f"this rank owns {leaf.numel}")
        if inv is not None:
            if g.data_ptr() == self.grad_staging[i].data_ptr():
                g.mul_(float(inv))
            else:
                g = g * float(inv)
        g = g.to(torch.float32).contiguous()
        bf16 = (leaf.mirror if leaf.mirror is not None
                and leaf.mirror.dtype == torch.bfloat16 else None)
        t0 = time.perf_counter()
        self.opt.step(master, g, m, v, params_bf16=bf16, lr=lr,
                      step=self.step_count)
        self.adam_s += time.perf_counter() - t0
        if bf16 is None:
            self._sync_mirror(i, master)

    # ------------------------------------------------ per-rank shard files
    def shard_arrays(self):
        """This rank's ``<i>:master`` / ``<i>:exp_avg`` / ``<i>:exp_avg_sq``
        numpy slices and the per-leaf metadata of the host-shard files,
        which ``checkpoint/saving.save_host_sharded_dir`` writes (the JAX
        ``save_shard``; reference zero_pp_rank_X_mp_rank_XX_optim_states.pt,
        engine.py:3076)."""
        arrays: Dict[str, np.ndarray] = {}
        for i in range(len(self.leaves)):
            for key, t in self.shard_state(i).items():
                arrays[f"{i}:{key}"] = t.numpy()
        return arrays, [l.meta() for l in self.leaves]

    def load_shards(self, ckpt_dir: str, load_optimizer_states: bool = True
                    ) -> None:
        """Fill this rank's slices from whatever host-shard files overlap
        them, leaf by leaf (any dp the files were written at: offsets below
        ``global_numel`` mean the same element whatever padding the writing
        world used, so ranges are clamped there and intersected)."""
        metas, infos = zero_to_fp32._load_shard_metas(ckpt_dir)
        if len(infos) != len(self.leaves):
            raise ValueError(f"checkpoint has {len(infos)} leaves, the "
                             f"model has {len(self.leaves)}")
        self.step_count = int(metas[0]["step"])
        pool = zero_to_fp32._ShardPool([m["_npz"] for m in metas])
        try:
            for i, leaf in enumerate(self.leaves):
                if tuple(infos[i]["shape"]) != leaf.shape:
                    raise ValueError(
                        f"leaf {i} ({leaf.path}): checkpoint shape "
                        f"{infos[i]['shape']} vs model {list(leaf.shape)}")
                master, m, v = self._state(i)
                targets = {"master": master}
                if load_optimizer_states:
                    targets.update(exp_avg=m, exp_avg_sq=v)
                my_lo, my_hi = leaf.offset, leaf.offset + leaf.valid
                for k, src_meta in enumerate(metas):
                    li = src_meta["leaves"][i]
                    src_lo = li["offset"]
                    src_hi = min(src_lo + li["numel"], li["global_numel"])
                    lo, hi = max(my_lo, src_lo), min(my_hi, src_hi)
                    if lo >= hi:
                        continue
                    for key, dst in targets.items():
                        src = pool[k][f"{i}:{key}"]
                        dst[lo - my_lo:hi - my_lo].copy_(torch.from_numpy(
                            np.ascontiguousarray(src[lo - src_lo:
                                                     hi - src_lo])))
                self._sync_mirror(i, master)
                self._write_back(i)
        finally:
            pool.close()
        log_dist(f"loaded host shard: ranks {self.dp_shard} from "
                 f"{len(metas)} shard file(s)", ranks=[0])

    def load_state(self, master: Sequence[np.ndarray],
                   opt_state: Optional[Dict[str, Sequence[np.ndarray]]] = None,
                   step: Optional[int] = None) -> None:
        """Whole leaves (numpy, the model's order) -> this rank's slices of
        the master and, with ``opt_state`` ({"exp_avg": [...],
        "exp_avg_sq": [...]}), of the moments."""
        if step is not None:
            self.step_count = int(step)
        for i, leaf in enumerate(self.leaves):
            mine = self._state(i)
            sources = [master[i]]
            if opt_state is not None:
                sources += [opt_state[k][i] for k in MOMENTS]
            for dst, src in zip(mine, sources):
                flat = np.asarray(src, np.float32).reshape(-1)
                dst.zero_()
                dst[:leaf.valid].copy_(torch.from_numpy(np.ascontiguousarray(
                    flat[leaf.offset:leaf.offset + leaf.valid])))
            self._sync_mirror(i, mine[0])
            self._write_back(i)

    def close(self) -> None:
        """Stop the aio threads (the swap files stay)."""
        if self.swapper is not None:
            self.swapper.close()
        if self.mirror_store is not None:
            self.mirror_store.close()
