"""ZeRO memory models for autotuning and user-facing estimation.

Counterpart of ``deepspeed_tpu/autotuning/memory.py`` (reference
``autotuning/autotuner.py:261-285`` and the
``estimate_zero{2,3}_model_states_mem_needs`` helpers). The arithmetic is
the ZeRO paper's: with Adam, 16-bit params (2N) + grads + fp32
master+momentum+variance (12N), divided over the dp world by stage; grads
are accumulated in fp32 (4N), as both engines accumulate them.

The TPU package's per-generation HBM and host tables are TPU numbers and
have no place here: a function that needs a card's or a host's size takes
it as an argument, or reads this machine (:func:`chip_memory_bytes` the
card, :func:`host_resources` the host).

    python -m deepspeed_tpu_torch.autotuning.memory --model gpt2_1_3b --chips 8

prints the per-stage table and the ZeRO-Infinity plan for a named model.
"""

from __future__ import annotations

from typing import Dict, Optional


def chip_memory_bytes(default: Optional[float] = None,
                      device: Optional[int] = None) -> float:
    """The card's memory in bytes (``torch.cuda.get_device_properties``);
    ``default`` on a host without CUDA, which raises when it is None."""
    import torch
    if not torch.cuda.is_available():
        if default is None:
            raise RuntimeError("chip_memory_bytes: no CUDA device; pass "
                               "default=")
        return float(default)
    idx = torch.cuda.current_device() if device is None else device
    return float(torch.cuda.get_device_properties(idx).total_memory)


def model_states_memory_per_chip(num_params: int, *, zero_stage: int,
                                 dp: int = 1, mp: int = 1,
                                 half_precision: bool = True,
                                 optimizer_factor: int = 12) -> float:
    """Bytes a card for params + grads + optimizer states (no
    activations). ``optimizer_factor``: bytes a parameter of optimizer state
    at fp32 master: 12 for Adam (master + m + v), 8 for momentum SGD, 4 for
    master only."""
    p_bytes = 2 if half_precision else 4
    params = num_params * p_bytes
    grads = num_params * 4          # grads accumulated in fp32
    optim = num_params * optimizer_factor
    if zero_stage >= 1:
        optim /= dp
    if zero_stage >= 2:
        grads /= dp
    if zero_stage >= 3:
        params /= dp
    return (params + grads + optim) / mp


def activation_memory_per_chip(*, micro_batch: int, seq_len: int,
                               hidden: int, layers: int,
                               dp_shard: bool = False, bytes_per_el: int = 2,
                               checkpoint_activations: bool = False) -> float:
    """Transformer activation estimate a card: B*S*H*layers*C, C about 16
    without remat and 2 with full remat (only the layer inputs kept)."""
    c = 2 if checkpoint_activations else 16
    return micro_batch * seq_len * hidden * layers * c * bytes_per_el


def max_micro_batch_for_budget(budget_bytes: float, *, num_params: int,
                               zero_stage: int, dp: int, mp: int,
                               seq_len: int, hidden: int, layers: int,
                               checkpoint_activations: bool = False) -> int:
    """The largest micro-batch whose states + activations fit in
    ``budget_bytes``."""
    states = model_states_memory_per_chip(
        num_params, zero_stage=zero_stage, dp=dp, mp=mp)
    if states >= budget_bytes:
        return 0
    per_sample = activation_memory_per_chip(
        micro_batch=1, seq_len=seq_len, hidden=hidden, layers=layers,
        checkpoint_activations=checkpoint_activations)
    if per_sample <= 0:
        return 1
    return max(0, int((budget_bytes - states) // per_sample))


def host_resources(nvme_path: str = "/tmp") -> Dict[str, float]:
    """This host's available DRAM (``MemAvailable``) and the free bytes of
    ``nvme_path``'s file system."""
    import shutil
    with open("/proc/meminfo") as fh:
        host = int(fh.read().split("MemAvailable:")[1].split()[0]) * 1024
    return {"host_dram": float(host),
            "nvme_free": float(shutil.disk_usage(nvme_path).free)}


def capacity_tiers(hbm: float, host_dram: float,
                   nvme_free: float) -> Dict[str, float]:
    """The most parameters a card trains on each offload tier.

    Bytes a parameter: ZeRO-1/2/3 on the card alone at dp 1 keeps the fp32
    master, moments and accumulator and a 16-bit compute copy (18); host
    offload keeps the 16-bit params and the fp32 accumulator on the card (6)
    and master + moments on the host (12); NVMe offload keeps the 16-bit
    mirrors on disk too (14 there); layer streaming
    (``runtime/zero/layer_stream.py``) lifts the card's bound: the host holds
    master + moments + grads (16), or, with the optimizer state on NVMe,
    only the grad buffers (4) while the disk holds 14."""
    hbm_usable = hbm * 0.92 - 2e9
    return {
        "hbm_only": hbm_usable / 18,
        "host_offload": min(hbm_usable / 6, host_dram * 0.9 / 12),
        "nvme_offload": min(hbm_usable / 6, nvme_free * 0.9 / 14),
        "streamed_host": host_dram * 0.9 / 16,
        "streamed_nvme": min(nvme_free * 0.9 / 14, host_dram * 0.9 / 4),
    }


def plan_infinity(leaf_numels, *, chips: int, hosts: int,
                  hbm_per_chip: float, host_dram_per_host: float,
                  nvme_per_host: float, micro_batch: int = 1,
                  seq_len: int = 2048, hidden: int = 12288,
                  layers: int = 96, prefetch_numel: int = 0,
                  mirror_on_nvme: bool = True,
                  headroom: float = 0.10) -> Dict[str, object]:
    """Capacity plan of the ZeRO-Infinity tier (offload_optimizer nvme +
    offload_param nvme), each budget from what the runtime allocates:

      * NVMe a host: the per-leaf [master | m | v] fp32 swap files (12 B a
        local parameter, ``NVMeLeafSwapper.write_init``) and the 16-bit
        mirrors (2 B, ``MirrorNVMeStore``);
      * DRAM a host: the swapper's slot windows (``slot_count`` buffers of
        3 x the largest leaf slice, fp32), one full set of local grad
        slices (the engine streams every grad to the host before the leaf
        loop) and one mirror staging window (the largest slice, 2 B);
      * card: the transient 16-bit compute params, the fp32 accumulator and
        the remat activations.

    Leaves are split over dp as ``offload._Leaf`` splits them. ``plan["fits"]``
    is True only when every tier fits within ``1 - headroom`` of its
    budget."""
    from ..runtime.zero.offload import NVMeLeafSwapper

    dp = chips
    ranks_per_host = max(1, chips // hosts)
    n_global = int(sum(leaf_numels))
    shard_lens = [-(-int(n) // dp) for n in leaf_numels]       # ceil
    local_numel = sum(s * ranks_per_host for s in shard_lens)  # a host
    max_shard = max(shard_lens)

    depth = NVMeLeafSwapper.window_depth(max_shard, prefetch_numel)
    slots = NVMeLeafSwapper.slot_count(depth)
    nvme = local_numel * 12.0 + (local_numel * 2.0 if mirror_on_nvme else 0.0)
    dram = (slots * 3 * max_shard * 4.0      # swapper slot windows
            + local_numel * 4.0              # grad slices (fp32)
            + max_shard * 2.0)               # mirror staging
    acts = activation_memory_per_chip(
        micro_batch=micro_batch, seq_len=seq_len, hidden=hidden,
        layers=layers, checkpoint_activations=True)
    hbm = n_global * 2.0 / chips + n_global * 4.0 / chips + acts

    def fit(used, budget):
        return used <= budget * (1.0 - headroom)

    plan = {
        "params": n_global, "chips": chips, "hosts": hosts,
        "swap_window_slots": slots,
        "nvme_bytes_per_host": nvme, "nvme_budget": nvme_per_host,
        "dram_bytes_per_host": dram, "dram_budget": host_dram_per_host,
        "hbm_bytes_per_chip": hbm, "hbm_budget": hbm_per_chip,
        "fits_nvme": fit(nvme, nvme_per_host),
        "fits_dram": fit(dram, host_dram_per_host),
        "fits_hbm": fit(hbm, hbm_per_chip),
    }
    plan["fits"] = bool(plan["fits_nvme"] and plan["fits_dram"]
                        and plan["fits_hbm"])
    return plan


def estimate_zero_model_states_mem_needs(num_params: int,
                                         num_chips_per_host: int = 4,
                                         num_hosts: int = 1
                                         ) -> Dict[int, float]:
    """Bytes a card for each ZeRO stage over the whole world (the
    reference's ``estimate_zero*_mem_needs`` helpers)."""
    world = num_chips_per_host * num_hosts
    return {stage: model_states_memory_per_chip(
        num_params, zero_stage=stage, dp=world)
        for stage in (0, 1, 2, 3)}


def _plan_cli(argv=None) -> int:
    """Print the per-stage table and the Infinity plan of a named model
    (a ``models.gpt`` factory) over ``--chips`` cards; card, host DRAM and
    NVMe sizes default to this machine's."""
    import argparse
    import json
    ap = argparse.ArgumentParser(prog="deepspeed_tpu_torch.autotuning.memory")
    ap.add_argument("--model", default="gpt3_175b",
                    help="factory name in deepspeed_tpu_torch.models.gpt "
                         "(gpt2_125m, gpt2_1_3b, gpt_neox_20b, gpt3_175b...)")
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--hosts", type=int, default=1)
    ap.add_argument("--hbm-per-chip", type=float, default=None,
                    help="bytes (default: this machine's card)")
    ap.add_argument("--host-dram-per-host", type=float, default=None,
                    help="bytes (default: this host's MemAvailable)")
    ap.add_argument("--nvme-per-host", type=float, default=None,
                    help="bytes (default: free bytes of --nvme-path)")
    ap.add_argument("--nvme-path", default="/tmp")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--micro-batch", type=int, default=1)
    args = ap.parse_args(argv)

    from ..models import gpt as gpt_mod
    from ..runtime.zero.partition_params import abstract_init
    factory = getattr(gpt_mod, args.model, None)
    if factory is None:
        raise SystemExit(f"unknown model {args.model!r}")
    cfg = factory()
    model = abstract_init(gpt_mod.GPT, cfg)
    numels = [p.numel() for p in model.parameters()]
    n = sum(numels)
    res = host_resources(args.nvme_path)
    hbm = (args.hbm_per_chip if args.hbm_per_chip is not None
           else chip_memory_bytes())
    dram = (args.host_dram_per_host if args.host_dram_per_host is not None
            else res["host_dram"])
    nvme = (args.nvme_per_host if args.nvme_per_host is not None
            else res["nvme_free"])
    print(f"{args.model}: {n / 1e9:.2f}B params on {args.chips} cards "
          f"({args.hosts} hosts, {hbm / 1e9:.1f} GB a card)")
    print(f"{'stage':<8}{'bytes/chip':>14}")
    for stage in (0, 1, 2, 3):
        b = model_states_memory_per_chip(n, zero_stage=stage, dp=args.chips)
        fits = "OK" if b < hbm * 0.9 else "OOM"
        print(f"z{stage:<7}{b / 1e9:>11.1f}GB  {fits}")
    plan = plan_infinity(
        numels, chips=args.chips, hosts=args.hosts, hbm_per_chip=hbm,
        host_dram_per_host=dram, nvme_per_host=nvme,
        micro_batch=args.micro_batch, seq_len=args.seq, hidden=cfg.d_model,
        layers=cfg.num_layers,
        prefetch_numel=2 * max(-(-x // args.chips) for x in numels))
    print("infinity plan: " + json.dumps(
        {k: (round(v / 1e9, 1) if isinstance(v, float) and v > 1e6 else v)
         for k, v in plan.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(_plan_cli())
