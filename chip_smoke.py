#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the result lines):
  1. the card's name and power limit; build both CUDA kernels from csrc/;
  2. decode attention kernel vs its plain version at GPT-2 125M decode
     geometry (b=8, S=1024, h=12, d=64, bf16, mixed per-row fills plus a
     retired-lane sentinel row), s_q = 1 and 4, max abs err <= 2e-2;
  3. sampling kernel vs its plain version at b=8, V=50304: greedy tokens
     equal, top-k=50 filtered logits bitwise equal, top-p=0.9 kept sets
     equal up to f32 rounding of the probability mass, temperature draws
     inside the filter;
  4. the main path: ServingEngine(megakernel=True) serving GPT-2 125M at
     full width (random weights from --seed) to 16 greedy requests, with the
     kernels' launch counts reset just before and read just after; then the
     same requests on the plain versions (megakernel=False) for the share of
     greedy tokens that agree, one decode step's logits through the kernels
     vs through the plain versions, a rerun with every served logits
     tensor checked finite, and two steady decode chunks: one timed
     unprofiled, one under torch.profiler (device time by kernel; idle
     share = 1 - device busy / unprofiled chunk wall);
  5. per-kernel device times (torch.profiler) beside the plain version, the
     PyTorch library call for the same function and the card's lower bound.

Prints the kernel summary JSON, the card line and, last,
{"ok": true, "device": {...}}. Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

DECODE_ATOL = 2e-2       # bf16 cache: probabilities rounded differently
TOP_P_MASS_TOL = 1e-5    # top-p: f32 mass sums in another order
LOGITS_ATOL = 5e-2       # bf16 model, 12 layers of differently rounded
#                          attention outputs


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, n_inputs: int = 1, kernel: str = "", iters: int = 50,
              warmup: int = 5) -> float:
    """Device time per call in ms: the kernels' durations under
    torch.profiler (CUPTI), summed over ``iters`` calls. Host launch
    overhead is excluded, so small kernels are not timed at the launch rate.
    ``kernel``: count only kernels whose name contains it (else all the
    call's kernels). ``fn(i)`` cycles over ``n_inputs`` input copies so a
    working set larger than L2 is read cold."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i % n_inputs)
        torch.cuda.synchronize()
    total_us = sum(_device_us(e) for e in prof.key_averages()
                   if kernel in e.key)
    if total_us <= 0:
        fail(f"no device time recorded for {kernel or 'the call'}")
    return total_us / 1e3 / iters


def _device_us(event) -> float:
    if "CUDA" not in str(getattr(event, "device_type", "")):
        return 0.0
    return float(getattr(event, "self_device_time_total", 0.0))


def phase_decode_attention(torch, da, dev, gen):
    b, S, h, d = 8, 1024, 12, 64
    fills = [1, 17, 512, 1024, 300, 64, 777]
    errs = {}
    inputs = {}
    for s_q in (1, 4):
        clen = torch.tensor(fills + [S + s_q], dtype=torch.int32,
                            device=dev)        # last row: the sentinel
        q = torch.randn(b, s_q, h, d, device=dev, generator=gen).bfloat16()
        k = torch.randn(b, S, h * d, device=dev, generator=gen).bfloat16()
        v = torch.randn(b, S, h * d, device=dev, generator=gen).bfloat16()
        out = da.decode_attention(q, k, v, clen)
        torch.cuda.synchronize()
        ref = da.decode_attention_reference(q, k, v, clen, 1 / 8)
        if not torch.isfinite(out).all():
            fail(f"decode_attention s_q={s_q}: non-finite output")
        errs[s_q] = (out.float() - ref.float()).abs().max().item()
        print(f"phase2 decode_attention s_q={s_q} max_abs_err={errs[s_q]} "
              f"(tol {DECODE_ATOL})", flush=True)
        if not errs[s_q] <= DECODE_ATOL:
            fail(f"decode_attention s_q={s_q} disagrees: {errs[s_q]}")
        inputs[s_q] = (q, k, v, clen)
    return max(errs.values()), inputs[1]


def phase_sampling(torch, sp, dev, gen):
    b, V = 8, 50304
    x = torch.randn(b, V, device=dev, generator=gen) * 3
    greedy = sp.fused_sample(x, None, 0.0, None)
    torch.cuda.synchronize()
    if not torch.equal(greedy, sp.fused_sample_reference(x, None, None,
                                                         None)):
        fail("greedy tokens differ from the plain version")
    topk = sp.threshold_filter_logits(x, 1.0, 50)
    topk_ref = sp.filter_rows_reference(x, 50, None)
    if not torch.equal(topk, topk_ref):
        fail("top-k=50 filtered logits are not bitwise equal")
    err = (topk - topk_ref).abs().max().item()
    topp = sp.threshold_filter_logits(x, 1.0, None, 0.9) > -1e9
    topp_ref = sp.filter_rows_reference(x, None, 0.9) > -1e9
    n_diff = int((topp != topp_ref).sum())
    if n_diff:
        # a token may flip only where the mass strictly above it sits at
        # p * Z within the f32 rounding of the mass sums
        p = torch.softmax(x.double(), dim=-1)
        for row, idx in (topp != topp_ref).nonzero().tolist():
            above = p[row][p[row] > p[row, idx]].sum().item()
            if abs(above - 0.9) > TOP_P_MASS_TOL:
                fail(f"top-p kept sets differ beyond rounding at "
                     f"row {row} token {idx}: mass above {above}")
    gum = -torch.log(-torch.log(
        torch.rand(b, V, device=dev, generator=gen).clamp_min(1e-30)))
    drawn = sp.fused_sample(x, gum, 0.8, 50, 0.9).long()
    kept = sp.filter_rows_reference(x / 0.8, 50, 0.9) > -1e9
    if not kept[torch.arange(b, device=dev), drawn].all():
        fail("a temperature draw fell outside the filter")
    print(f"phase3 sampling greedy=equal top_k50=bitwise top_p0.9 "
          f"differing_tokens={n_diff} draws=inside_filter", flush=True)
    return x, err


def phase_serving(torch, np, dev, seed, card):
    from deepspeed_tpu_torch import InferenceEngine, ServingEngine
    from deepspeed_tpu_torch.models.gpt import GPT, gpt2_125m
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.serving.kv_cache import SlotKVCacheManager

    cfg = gpt2_125m(max_seq_len=1024, dtype=torch.bfloat16)
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    ie = InferenceEngine(model, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(16, 129, 16)]
    kw = dict(max_batch=8, decode_chunk=8, max_prompt_len=128)
    n_new = 64

    ServingEngine(engine=ie, megakernel=True, **kw).run(
        [p.copy() for p in prompts[:2]], max_new_tokens=4)   # warm-up
    mega = ServingEngine(engine=ie, megakernel=True, **kw)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = mega.run([p.copy() for p in prompts], max_new_tokens=n_new)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for name in ("decode_attention", "sampling"):
        if not launches.get(name):
            fail(f"the main path never launched the {name} kernel")
    for r in out:
        if r.status != "done" or len(r.tokens) != n_new:
            fail(f"request {r.uid}: status {r.status}, "
                 f"{len(r.tokens)} tokens")
    n_tokens = sum(len(r.tokens) for r in out)
    tok_s = n_tokens / seconds
    chunk_ms = mega.metrics.mean_decode_chunk_s * 1e3
    print(f"phase4 serving gpt2_125m requests=16 tokens={n_tokens} "
          f"launches={launches}", flush=True)
    print(f"serving_tokens_per_s={tok_s} card={card}", flush=True)
    print(f"serving_mean_decode_chunk_ms={chunk_ms} (K=8, batch 8) "
          f"card={card}", flush=True)

    # the same requests again with every logits tensor of the served path
    # (prefill and each decode step) checked for non-finite values; off the
    # timed run, since the check adds a reduction per call
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    module = ie.module
    unchecked = module.logits

    def checked_logits(hidden):
        out = unchecked(hidden)
        bad.logical_or_(~torch.isfinite(out).all())
        return out

    module.logits = checked_logits
    try:
        again = ServingEngine(engine=ie, megakernel=True, **kw).run(
            [p.copy() for p in prompts], max_new_tokens=n_new)
    finally:
        del module.logits
    if bool(bad):
        fail("non-finite logits while serving through the kernels")
    if [r.tokens for r in again] != [r.tokens for r in out]:
        fail("a second megakernel run served different greedy tokens")
    print("phase4 served logits all finite; rerun tokens identical",
          flush=True)

    plain = ServingEngine(engine=ie, megakernel=False, **kw).run(
        [p.copy() for p in prompts], max_new_tokens=n_new)
    agree = sum(int(a == b) for r, s in zip(out, plain)
                for a, b in zip(r.tokens, s.tokens))
    if any(r.tokens[0] != s.tokens[0] for r, s in zip(out, plain)):
        fail("prefill's greedy first tokens differ between the engines")
    print(f"phase4 greedy tokens agreeing with the plain engine: "
          f"{agree}/{n_tokens} = {agree / n_tokens}", flush=True)

    # one decode step through the kernels vs through the plain versions,
    # from the same prefilled arena
    with torch.inference_mode():
        lens = np.array([len(p) for p in prompts[:8]])
        ids = np.zeros((8, 128), np.int64)
        for i, p in enumerate(prompts[:8]):
            ids[i, :len(p)] = p
        hidden, keys, values = model.prefill(torch.from_numpy(ids).to(dev))
        lens_t = torch.from_numpy(lens).to(dev)
        first = model.logits(hidden[torch.arange(8, device=dev),
                                    lens_t - 1]).argmax(-1)
        kv = SlotKVCacheManager(cfg, 8, dev)
        kv.insert_batch(keys, values, range(8))
        logits = {}
        for impl in ("auto", "einsum"):
            logits[impl] = model.decode(
                first[:, None], lens_t[:, None], kv.cache_k.clone(),
                kv.cache_v.clone(), lens_t, decode_impl=impl)[:, 0].float()
    if not torch.isfinite(logits["auto"]).all():
        fail("non-finite logits through the kernels")
    err = (logits["auto"] - logits["einsum"]).abs().max().item()
    same = int((logits["auto"].argmax(-1)
                == logits["einsum"].argmax(-1)).sum())
    print(f"phase4 first decode step logits max_abs_err={err} "
          f"(tol {LOGITS_ATOL}) argmax_equal_rows={same}/8", flush=True)
    if not err <= LOGITS_ATOL:
        fail(f"decode-step logits disagree: {err}")
    phase_profile(torch, ie, prompts[:8], kw, card)
    return launches


def phase_profile(torch, ie, prompts, kw, card):
    """Two steady decode chunks (8 live lanes, K=8 steps each): the first
    timed without the profiler, the second under torch.profiler for device
    kernel time by name. The device's idle share is one minus the profiled
    chunk's device busy time over the unprofiled chunk's wall time (the
    profiler inflates the wall time of the chunk it records)."""
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch import ServingEngine
    eng = ServingEngine(engine=ie, megakernel=True, **kw)
    for p in prompts:
        eng.submit(p.copy(), max_new_tokens=1 + 3 * kw["decode_chunk"])
    eng.step()                       # admission, prefill, first chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()                       # one pure decode chunk, unprofiled
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()                   # the next one, profiled
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(_device_us(e) / 1e3, e.count, e.key)
            for e in prof.key_averages() if _device_us(e) > 0]
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        fail("the profiler recorded no device time for a decode chunk")
    print(f"phase6 profile decode chunk wall_ms={wall_ms} (unprofiled) "
          f"profiled_wall_ms={profiled_wall_ms} device_busy_ms={busy_ms} "
          f"idle_share={1 - busy_ms / wall_ms} card={card}", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:10]:
        print(f"phase6 kernel ms={ms} count={count} {key[:90]}", flush=True)


def phase_timing(torch, da, sp, dev, gen, decode_inputs, logits, card):
    import torch.nn.functional as F
    q, k, v, clen = decode_inputs
    b, s_q, h, d = q.shape
    S = k.shape[1]
    # 8 cache copies (8 x 25 MB) so each call reads its K/V cold from HBM,
    # as a layer's call does in the model
    copies = [(k.clone(), v.clone()) for _ in range(8)]
    mask = (torch.arange(S, device=dev)[None, :]
            < clen.clamp(max=S)[:, None])[:, None, None, :]

    def kernel(i):
        da.decode_attention(q, copies[i][0], copies[i][1], clen)

    def plain(i):
        da.decode_attention_reference(q, copies[i][0], copies[i][1], clen,
                                      1 / 8)

    def library(i):
        kk = copies[i][0].view(b, S, h, d).transpose(1, 2)
        vv = copies[i][1].view(b, S, h, d).transpose(1, 2)
        F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv,
                                       attn_mask=mask, scale=1 / 8)

    live = clen.clamp(max=S).sum().item()
    item = k.element_size()
    da_bytes = 2 * live * h * d * item + 2 * q.numel() * item + 4 * b
    da_flops = 4 * live * h * d * s_q
    da_bound = 1e3 * max(da_bytes / HBM_BYTES_PER_S, da_flops / BF16_FLOPS)
    da_t = {"ms": device_ms(kernel, 8, "decode_attention_kernel"),
            "plain_ms": device_ms(plain, 8),
            "library_ms": device_ms(library, 8)}

    x = logits
    B, V = x.shape
    sp_t = {
        "ms": device_ms(lambda i: sp.fused_sample(x, None, 0.0, None),
                        kernel="sampling_kernel"),
        "plain_ms": device_ms(lambda i: sp.fused_sample_reference(
            x, None, None, None)),
        "library_ms": device_ms(lambda i: torch.argmax(x, dim=-1)),
    }
    filt_ms = device_ms(lambda i: sp.threshold_filter_logits(x, 1.0, 50, 0.9),
                        kernel="sampling_kernel")
    sp_bytes = B * V * 4 + B * 4
    sp_bound = 1e3 * max(sp_bytes / HBM_BYTES_PER_S, B * V / F32_FLOPS)
    for name, t, bound in (("decode_attention", da_t, da_bound),
                           ("sampling", sp_t, sp_bound)):
        for key, val in t.items():
            print(f"{name}_{key}={val} card={card}", flush=True)
        print(f"{name}_bound_ms={bound} card={card}", flush=True)
    print(f"sampling_top_k50_top_p0.9_filter_ms={filt_ms} card={card}",
          flush=True)
    return (da_t, da_bound, "bytes" if da_bytes / HBM_BYTES_PER_S
            >= da_flops / BF16_FLOPS else "operations"), \
        (sp_t, sp_bound, "bytes" if sp_bytes / HBM_BYTES_PER_S
         >= B * V / F32_FLOPS else "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import sampling as sp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    print(f"phase1 kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    da_err, decode_inputs = phase_decode_attention(torch, da, dev, gen)
    logits, sp_err = phase_sampling(torch, sp, dev, gen)
    launches = phase_serving(torch, np, dev, args.seed, card)
    (da_t, da_bound, da_by), (sp_t, sp_bound, sp_by) = phase_timing(
        torch, da, sp, dev, gen, decode_inputs, logits, card)

    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/decode_attention.cu",
         "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:74",
         "launches": launches["decode_attention"], "max_abs_err": da_err,
         **da_t, "bound_ms": da_bound, "bound_by": da_by},
        {"name": "sampling", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/sampling.cu",
         "replaces": "deepspeed_tpu/ops/pallas/sampling.py:132",
         "launches": launches["sampling"], "max_abs_err": sp_err,
         **sp_t, "bound_ms": sp_bound, "bound_by": sp_by},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
