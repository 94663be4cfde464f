#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the result lines):
  1. the card's name and power limit; build the CUDA kernels from csrc/;
     count the wgmma (SASS HGMMA) instructions of each 16-bit flash kernel
     and the TMA (UTMALDG, or UBLKCP for a plain bulk copy) instructions of
     each decode kernel in the built library (cuobjdump; fails if one has
     none), and the HGMMA, UTMALDG and HMMA instructions of each 16-bit
     sparse backward kernel (fails without the first two or with an HMMA);
     the registers a thread of each LayerNorm and softmax forward kernel
     and of each 16-bit sparse backward kernel (cuobjdump
     --dump-resource-usage; fails on a sparse backward kernel with local
     memory or a stack frame);
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
     vs through the plain versions, and a rerun with every served logits
     tensor checked finite;
  6. two steady decode chunks: one timed unprofiled, one under
     torch.profiler (device time by kernel; idle share = 1 - device busy /
     unprofiled chunk wall);
  5. per-kernel device times (torch.profiler) beside the plain version, the
     PyTorch library call for the same function and the card's lower bound;
     B2 also at phase 2's fills with s_q = 4 and with every row full;
  7. flash attention kernels (forward, dq, dk/dv) vs their plain versions at
     the training shape (B=8, S=1024, H=12, D=64, bf16, causal) and at a
     non-causal shape whose S (1000) is not a multiple of the 128-row
     block: out, lse, and dq/dk/dv from one random dO; then over bf16 and
     fp16 x D 32/64/96/128 x causal or not x S 1024/1000/77 (B=2, H=3);
     a second backward at the training shape must give bitwise the same
     grads;
  8. the training path: initialize() + DeepSpeedEngine.train_batch on
     GPT-2 125M at full width and depth (12 layers, d_model 768, 12 x 64
     heads, vocab 50304, seq 1024, bf16 over fp32 masters, remat with the
     default policy, random weights from --seed) with bench.py's
     gpt2_125m_zero1 config (micro 8 x gas 16, AdamW lr 1e-4, ZeRO-1):
     2 warm-up + 3 timed steps on one repeated batch, counts reset just
     before and read just after; fails on a non-finite or non-falling loss,
     a non-finite grad norm, or flash launch counts other than 12 layers x
     16 micro-batches per step (x2 for the forward: remat recomputes it);
  9. one micro-batch of the trained model forward+backward through the
     kernels (attention_impl="auto") vs the masked einsum ("xla"): loss and
     global grad norm;
 10. one training micro-step after a warm-up one, unprofiled (host issue
     time and wall), then under torch.profiler (device time by kernel,
     kernel count; idle share = 1 - device busy / unprofiled wall);
 11. the flash kernels' device times at the training shape beside their
     plain versions, scaled_dot_product_attention forward / its autograd
     backward (a yardstick, never called by the port) and their bounds;
     the same at the transformer layer's unmasked shape (B=8, S=512, H=16,
     D=64, not causal) and at the training shape in fp16 and at D=96
     (H=8); the host time to issue one forward and one backward call;
 12. block-sparse kernels (forward, dq, dk/dv) vs their plain versions:
     bf16, fp16 and f32 x layout blocks 16/32/64/128 x causal or not x with
     or without a key-padding mask (BigBird, per-head layouts, B=2, H=4,
     D=64, S=480 or 512, q/k/v views of a fused qkv), D=96 (block 32,
     S=480, causal or not), a layout with dead query rows and key tiles no
     query reaches (zeros checked), and the training
     shape B=1, S=32768, H=12, D=64 with bench.py's BigBird layout, causal,
     where a second backward must give bitwise the same grads;
 13. the long-context training path: bench.py's long_context_sparse case
     (bench.py:344-399): GPT-2 125M at seq 32768 (full width and depth,
     bf16 over fp32 masters, remat with the default policy) through
     attention_impl="sparse" (BigBird block 64, 3 random, 3 window,
     1 global), micro 1 x gas 1, ZeRO-1, AdamW lr 1e-4: 1 warm-up + 3 timed
     steps, counts reset just before and read after each step; fails on a
     non-finite or non-falling loss, a non-finite grad norm, sparse launch
     counts other than 24 / 12 / 12 per step or any flash launch; prints
     step time, tokens/s and peak device memory;
 14. one step of the trained long-context model (seq 32768) through the
     kernels vs through the plain versions: loss and global grad norm;
 15. one warmed long-context step unprofiled (wall), then under
     torch.profiler (device time by kernel; idle share);
 16. the sparse kernels' device times at the training shape beside their
     plain versions, scaled_dot_product_attention with the expanded boolean
     mask (dense work; at the largest S that fits, stated) and their
     bounds (live (q, k) pairs of the layout, causal), each time also as a
     multiple of its bound;
 17. sparse BERT: BertForMaskedLM at bert_base width, max_seq_len 4096,
     bf16, BigBird block 64 (bidirectional), batch 4 of real lengths 4096,
     3000, 1500, 40 padded by pad_to_block_size with a batch-wide
     key-padding mask: MLM loss and grads through the kernels vs the plain
     versions (finite, within bounds, 12 launches of each kernel), and the
     kernels at that shape vs their plain versions with dk/dv exactly zero
     at padded keys. This one comparison scales the bf16 rtol by each
     row's largest |ref| (the 40-token row's 4056 padded queries pour their
     attention into 40 keys: sums of thousands of bf16-rounded terms that
     cancel); it prints the elementwise reading beside it. Every other
     sparse comparison is elementwise;
 18. paged decode attention (B3) and the int8 branches of B2 and B3 vs their
     plain versions at GPT-2 125M decode geometry (b=8, h=12, d=64,
     S=1024, block 16, so T=64), bf16, fp16 and f32, s_q 1 and 4, fills 0,
     1, 17, 512, 1024, 300, 777 and the retired-lane sentinel, over a random
     permutation of the pool blocks with sentinel table entries past each
     row's fill: max abs err <= 2e-2, the fill-0 row exactly zero, and B3
     over the permuted table, the in-order table and the sentinel table
     bitwise B2 (int8: B3-int8 bitwise B2-int8);
 19. the paged main path: ServingEngine(paged=True, megakernel=True,
     kv_block_size=16) serving GPT-2 125M (full width and depth, random
     weights from --seed) to 16 greedy requests of 64 new tokens, four of
     them exact repeats of earlier prompts, with the counts reset just
     before and read just after: fails on no B3 or sampling launch or any
     B2 launch, on prefix-cache hits/misses other than 4/12, on prefill
     prompt tokens other than the 12 distinct prompts' sum, on a hit whose
     tokens differ from its twin's, or on tokens that differ from the dense
     megakernel engine's on the same requests; prints tokens/s, the mean
     chunk time and a steady chunk's idle share;
 20. int8 serving: the same 16 requests through kv_dtype="int8", dense and
     paged, counts reset before and read after each run: fails on no int8
     launch (or any other decode kernel's), on dense and paged int8 tokens
     that differ, on a non-finite served logits tensor, or on an int8
     payload above half the compute dtype's bytes (arena_report); prints
     the share of tokens equal to the bf16 engine's;
 21. device times of B3, B2-int8 and B3-int8 at phase 2's inputs (B2's
     fills, bf16, s_q 1) beside B2's, their plain versions', a gather +
     scaled_dot_product_attention yardstick (a dequantize between them for
     int8) and their byte bounds; the three also at s_q = 4 and with every
     row full;
 22. the row-wise kernels vs their plain versions, bf16 and f32: LayerNorm
     (B6) forward and dx at [8*512, 1024] (gamma/beta in the element type
     and in f32), [37, 1000], the forward's path edges [37, 1016 / 1032 /
     2048] and [37, 1024] one element off a 16-byte boundary; bias-GELU
     (B7) forward and backward at [8*512, 4096] and [37, 1001]; softmax
     (B8) forward and backward at [8, 16, 512, 512], [2, 3, 77, 4099] (a
     block per row), the path edges [1, 2, 5, 1023 / 1024 / 1025 / 2048]
     and [2, 3, 77, 1024] one element off a 16-byte boundary, causal and
     not, and masked_softmax with a scale and an additive key mask; then
     B7's op entry (ops.transformer.bias_gelu + gelu, forward and backward
     at [8, 512, 4096] bf16, counts reset just before and read just after:
     two launches of each kernel);
 23. the layer path: 24 DeepSpeedTransformerLayers at bert_large width
     (hidden 1024, 16 heads, intermediate 4096, pre-LN, eps 1e-12, no
     dropout, random weights from --seed) with a fixed key-padding mask
     (lengths 512 .. 64) trained through initialize() + train_batch (bf16
     over fp32 masters, AdamW lr 1e-4, ZeRO-1, micro 8 x seq 512 x gas 1,
     the mean squared output as the loss): 1 warm-up + 3 timed steps,
     counts reset just before and read after each step; fails on a
     non-finite or non-falling loss or on launches per step other than
     48 / 48 LayerNorm, 24 / 24 softmax and no flash; prints step s,
     tokens/s, peak memory and a warmed step's idle share; then one
     forward+backward without the mask (flash 24 / 24 / 24, no softmax),
     and the trained weights through the kernels vs the plain versions
     (loss and grad norm);
 24. the six row-wise kernels' device times at phase 22's shapes (bf16;
     softmax also f32, the layer's logits) beside their plain versions,
     F.layer_norm / F.gelu(x + b, approximate="tanh") / torch.softmax and
     their autograd backwards (yardsticks) and their bounds; warm (the same
     inputs each call: the kernels line) and cold (input copies of at least
     64 MiB read in turn, past L2), the kernel and its yardstick each.

Prints the kernel summary JSON, the card line and, last,
{"ok": true, "device": {...}}. Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

DECODE_ATOL = 2e-2       # bf16 cache: probabilities rounded differently
DECODE_INT8_RTOL = 2e-2  # int8 cache in bf16: the plain version rounds the
#                          dequantized cache to bf16, the kernels keep f32
TOP_P_MASS_TOL = 1e-5    # top-p: f32 mass sums in another order
LOGITS_ATOL = 5e-2       # bf16 model, 12 layers of differently rounded
#                          attention outputs
FLASH_TOL = (2e-2, 2e-2)  # (atol, rtol) of bf16 out/dq/dk/dv: both round
#                          their f32 result to bf16 (2^-8 relative), and the
#                          kernels round p and ds to bf16 for the tensor cores
LSE_ATOL = 1e-3          # f32 lse: summation order over the live keys
LOSS_ATOL = 2e-2         # model check: the einsum rounds attention
GRAD_NORM_RTOL = 5e-2    # probabilities to bf16, the kernels keep f32
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_HEAD_DIMS = (32, 64, 96, 128)
SPARSE = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")
SPARSE_F32_TOL = (1e-4, 1e-4)  # f32: CUDA-core FMAs, summation order only
# bench.py's long_context_sparse configuration (bench.py:344-399)
LONG_SEQ = 32768
LONG_CONFIG = {"train_micro_batch_size_per_gpu": 1,
               "gradient_accumulation_steps": 1,
               "bf16": {"enabled": True},
               "zero_optimization": {"stage": 1},
               "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
               "steps_per_print": 100_000}
BERT_LENGTHS = (4096, 3000, 1500, 40)
# bench.py's gpt2_125m_zero1 configuration (bench.py:156-160)
TRAIN_MICRO, TRAIN_GAS, TRAIN_SEQ = 8, 16, 1024
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": TRAIN_MICRO,
                "gradient_accumulation_steps": TRAIN_GAS,
                "bf16": {"enabled": True},
                "zero_optimization": {"stage": 1},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                "steps_per_print": 100_000}


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
    # a profiler session late in a long process can come back without
    # kernel records (CUPTI); the window is measured once more before the
    # run fails
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i % n_inputs)
            torch.cuda.synchronize()
        total_us = sum(_device_us(e) for e in prof.key_averages()
                       if kernel in e.key)
        if total_us > 0:
            return total_us / 1e3 / iters
        print(f"device_ms: no device time recorded for "
              f"{kernel or 'the call'} (attempt {attempt + 1})", flush=True)
    fail(f"no device time recorded for {kernel or 'the call'}")


def _device_us(event) -> float:
    if "CUDA" not in str(getattr(event, "device_type", "")):
        return 0.0
    return float(getattr(event, "self_device_time_total", 0.0))


def phase_decode_attention(torch, da, dev, gen):
    errs = {}
    inputs = {}
    for s_q in (1, 4):
        q, k, v, clen = decode_case_inputs(torch, dev, gen, s_q, full=False)
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


def phase_profile(torch, ie, prompts, kw, card, tag="phase6"):
    """Two steady decode chunks (8 live lanes, K=8 steps each): the first
    timed without the profiler, the second under torch.profiler for device
    kernel time by name. The device's idle share is one minus the profiled
    chunk's device busy time over the unprofiled chunk's wall time (the
    profiler inflates the wall time of the chunk it records)."""
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch import ServingEngine
    eng = ServingEngine(engine=ie, **{"megakernel": True, **kw})
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
    print(f"{tag} profile decode chunk wall_ms={wall_ms} (unprofiled) "
          f"profiled_wall_ms={profiled_wall_ms} device_busy_ms={busy_ms} "
          f"idle_share={1 - busy_ms / wall_ms} card={card}", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:10]:
        print(f"{tag} kernel ms={ms} count={count} {key[:90]}", flush=True)


def phase_timing(torch, da, qz, sp, dev, gen, decode_inputs, logits,
                 card):
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
    print_decode_cases(torch, da, qz, dev, gen, ("decode_attention",),
                       "phase5", card)
    return (da_t, da_bound, "bytes" if da_bytes / HBM_BYTES_PER_S
            >= da_flops / BF16_FLOPS else "operations"), \
        (sp_t, sp_bound, "bytes" if sp_bytes / HBM_BYTES_PER_S
         >= B * V / F32_FLOPS else "operations")


def _close(got, ref, atol, rtol, rows=False) -> float:
    """max |got - ref| after checking |got - ref| <= atol + rtol |ref|;
    with ``rows``, rtol scales the largest |ref| of the element's row (the
    last dim) instead: a sum over thousands of bf16-rounded terms errs with
    the size of its terms, which a row's largest entry tracks and a
    cancelled small entry does not (used only at sparse BERT's padded
    shape, phase 17)."""
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        fail("non-finite kernel output")
    diff = (got - ref).abs()
    scale = ref.abs().amax(-1, keepdim=True) if rows else ref.abs()
    bad = diff > atol + rtol * scale
    if bool(bad.any()):
        at = tuple(bad.nonzero()[0].tolist())
        fail(f"kernel disagrees with its plain version: max abs err "
             f"{diff.max().item()}; first violation at {at}: "
             f"{got[at].item()} vs {ref[at].item()}")
    return diff.max().item()


def _qkv(torch, dev, gen, B, S, H, D):
    """bf16 q, k, v as views of one fused [B, S, 3*H*D] projection output
    (the model's layout) and a random dO."""
    qkv = torch.randn(B, S, 3 * H * D, device=dev, generator=gen).bfloat16()
    q, k, v = (t.view(B, S, H, D) for t in qkv.split(H * D, -1))
    do = torch.randn(B, S, H, D, device=dev, generator=gen).bfloat16()
    return q, k, v, do


def _flash_pair(torch, fa, q, k, v, do, causal):
    """The three flash kernels once each against the plain versions:
    (max abs errs, (plain out, plain lse))."""
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_attention_forward(q, k, v, causal, scale)
    ro, rl = fa.flash_attention_forward_reference(q, k, v, causal, scale)
    grads = fa.flash_attention_backward(q, k, v, ro, rl, do, causal, scale)
    refs = fa.flash_attention_backward_reference(q, k, v, ro, rl, do, causal,
                                                 scale)
    torch.cuda.synchronize()
    if out.dtype != q.dtype or any(g.dtype != q.dtype for g in grads):
        fail("a flash kernel returned another dtype than its inputs'")
    e = {"flash_fwd": _close(out, ro, *FLASH_TOL),
         "lse": _close(lse, rl, LSE_ATOL, 0.0),
         "flash_bwd_dq": _close(grads[0], refs[0], *FLASH_TOL),
         "flash_bwd_dkv": max(_close(grads[1], refs[1], *FLASH_TOL),
                              _close(grads[2], refs[2], *FLASH_TOL))}
    return e, (ro, rl)


def phase_flash_parity(torch, fa, dev, gen):
    errs, train_inputs = {}, None
    for tag, (B, S, H, D, causal) in (("train", (8, 1024, 12, 64, True)),
                                      ("tail", (2, 1000, 12, 64, False))):
        q, k, v, do = _qkv(torch, dev, gen, B, S, H, D)
        e, (ro, rl) = _flash_pair(torch, fa, q, k, v, do, causal)
        print(f"phase7 flash {tag} B={B} S={S} H={H} D={D} causal={causal} "
              f"bf16 max_abs_err out={e['flash_fwd']} lse={e['lse']} "
              f"dq={e['flash_bwd_dq']} dk_dv={e['flash_bwd_dkv']} (tol "
              f"atol {FLASH_TOL[0]} + rtol {FLASH_TOL[1]}, lse {LSE_ATOL})",
              flush=True)
        if tag == "train":
            errs, train_inputs = e, (q, k, v, do, ro, rl)
    # the Hopper kernels over their dtypes and head dims, S a multiple of
    # the 128-row block, a ragged tail, and shorter than one block
    worst = {}
    for dtype in (torch.bfloat16, torch.float16):
        for D in FLASH_HEAD_DIMS:
            for causal in (True, False):
                for S in (1024, 1000, 77):
                    q, k, v, do = (t.to(dtype) for t in _qkv(
                        torch, dev, gen, 2, S, 3, D))
                    e, _ = _flash_pair(torch, fa, q, k, v, do, causal)
                    for key, val in e.items():
                        worst[key] = max(worst.get(key, 0.0), val)
                    print(f"phase7 flash {str(dtype)[6:]} B=2 S={S} H=3 "
                          f"D={D} causal={causal} max_abs_err " + " ".join(
                              f"{k_}={v_:.3g}" for k_, v_ in e.items()),
                          flush=True)
    print(f"phase7 flash grid (bf16/fp16 x D {FLASH_HEAD_DIMS} x causal x "
          f"S 1024/1000/77) worst max_abs_err {worst} (tol atol "
          f"{FLASH_TOL[0]} + rtol {FLASH_TOL[1]} |ref|, lse {LSE_ATOL})",
          flush=True)
    # no atomics: a second backward gives bitwise the same grads
    q, k, v, do, ro, rl = train_inputs
    first, again = (fa.flash_attention_backward(q, k, v, ro, rl, do, True,
                                                64 ** -0.5)
                    for _ in range(2))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail("a second flash backward gave different grads")
    print("phase7 flash train: a second backward bitwise equal", flush=True)
    return errs, train_inputs


def phase_training(torch, np, dev, seed, card):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import (GPT, gpt2_125m,
                                                gpt_flops_per_token,
                                                lm_loss_fn)
    from deepspeed_tpu_torch.ops.cuda import _build
    cfg = gpt2_125m(max_seq_len=TRAIN_SEQ, dtype=torch.bfloat16)
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    engine, *_ = dst.initialize(model=model, loss_fn=lm_loss_fn,
                                config=TRAIN_CONFIG)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_MICRO, TRAIN_SEQ)).astype(np.int32)
    losses, norms, secs = [], [], []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for _ in range(5):                 # 2 warm-up + 3 timed steps
        t0 = time.perf_counter()
        loss = engine.train_batch(iter([{"input_ids": ids}] * TRAIN_GAS))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(engine.get_global_grad_norm())
    launches = {name: _build.LAUNCHES[name] for name in FLASH}
    print(f"phase8 training gpt2_125m losses={losses} grad_norms={norms} "
          f"step_s={secs} launches={launches}", flush=True)
    if not all(np.isfinite(losses + norms)):
        fail("non-finite loss or grad norm while training")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall over 5 steps: {losses}")
    per_step = cfg.num_layers * TRAIN_GAS
    want = {"flash_fwd": 5 * 2 * per_step, "flash_bwd_dq": 5 * per_step,
            "flash_bwd_dkv": 5 * per_step}
    if launches != want:
        fail(f"flash launch counts {launches}, expected {want}")
    step_s = sum(secs[2:]) / 3
    tok_s = TRAIN_MICRO * TRAIN_SEQ * TRAIN_GAS / step_s
    mfu = gpt_flops_per_token(cfg, TRAIN_SEQ) * tok_s / BF16_FLOPS
    print(f"train_step_s={step_s} card={card}", flush=True)
    print(f"train_tokens_per_s={tok_s} card={card}", flush=True)
    print(f"train_mfu={mfu} (vs 989 TFLOP/s bf16) card={card}", flush=True)
    return engine, cfg, torch.from_numpy(ids).long().to(dev), launches


def phase_model_check(torch, dev, engine, cfg, ids):
    """One micro-batch of the trained weights through the kernels and
    through the masked einsum, both bf16."""
    import dataclasses
    from deepspeed_tpu_torch.models.gpt import GPT, lm_loss_fn
    result = {}
    for impl in ("auto", "xla"):
        m = GPT(dataclasses.replace(cfg, attention_impl=impl),
                device=dev).to(torch.bfloat16)
        m.load_state_dict(engine.module.state_dict())
        loss = lm_loss_fn(m(ids), {"input_ids": ids})
        loss.backward()
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.float().norm() for p in m.parameters()]))
        result[impl] = (loss.item(), norm.item())
        del m
    (lk, nk), (lx, nx) = result["auto"], result["xla"]
    print(f"phase9 model check loss kernels={lk} einsum={lx} (atol "
          f"{LOSS_ATOL}); grad norm kernels={nk} einsum={nx} (rtol "
          f"{GRAD_NORM_RTOL})", flush=True)
    if not (abs(lk - lx) <= LOSS_ATOL and abs(nk - nx) <= GRAD_NORM_RTOL * nx):
        fail("the model through the kernels disagrees with the einsum path")


def phase_train_profile(torch, engine, ids, card):
    """One micro-step (forward + backward of one micro-batch) after a
    warm-up one, timed without the profiler (host issue time: until the
    calls return; wall: until the device is done), then one under it; idle
    share against the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    batch = {"input_ids": ids}
    engine.backward(engine(batch))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.backward(engine(batch))
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.backward(engine(batch))
        torch.cuda.synchronize()
    rows = [(_device_us(e) / 1e3, e.count, e.key)
            for e in prof.key_averages() if _device_us(e) > 0]
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        fail("the profiler recorded no device time for a training micro-step")
    print(f"phase10 profile train micro-step wall_ms={wall_ms} (unprofiled) "
          f"host_issue_ms={issue_ms} device_busy_ms={busy_ms} "
          f"idle_share={1 - busy_ms / wall_ms} "
          f"device_kernels={sum(r[1] for r in rows)} card={card}", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"phase10 kernel ms={ms} count={count} {key[:90]}", flush=True)


def _flash_times(torch, fa, q, k, v, do, out, lse, causal):
    """Device ms per call of the three kernels, their plain versions and
    scaled_dot_product_attention (forward, and its autograd backward: a
    yardstick, never called by the port), with each kernel's bound."""
    import torch.nn.functional as F
    B, S, H, D = q.shape
    scale = D ** -0.5
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    do_t = do.transpose(1, 2).contiguous()

    def backward(i):
        fa.flash_attention_backward(q, k, v, out, lse, do, causal, scale)

    def plain_backward(i):
        fa.flash_attention_backward_reference(q, k, v, out, lse, do, causal,
                                              scale)

    def sdpa_backward(i):
        torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t, retain_graph=True)

    plain_bwd = device_ms(plain_backward, iters=10)
    sdpa_bwd = device_ms(sdpa_backward)
    t = {
        "flash_fwd": {
            "ms": device_ms(lambda i: fa.flash_attention_forward(
                q, k, v, causal, scale), kernel="flash_fwd"),
            "plain_ms": device_ms(
                lambda i: fa.flash_attention_forward_reference(
                    q, k, v, causal, scale), iters=10),
            "library_ms": device_ms(lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))},
        # the plain and library backward compute dq, dk and dv together:
        # their times stand beside both kernels
        "flash_bwd_dq": {"ms": device_ms(backward, kernel="flash_bwd_dq"),
                         "plain_ms": plain_bwd, "library_ms": sdpa_bwd},
        "flash_bwd_dkv": {"ms": device_ms(backward, kernel="flash_bwd_dkv"),
                          "plain_ms": plain_bwd, "library_ms": sdpa_bwd},
    }
    # bytes: each input read once, each output written once; operations: 2
    # per multiply-add over the visible (q, k) pairs, at the 16-bit peak
    item = q.element_size()
    n = B * S * H * D * item                 # one [B, S, H, D] tensor
    stat = B * H * S * 4                     # one f32 [B, H, S] vector
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    work = {"flash_fwd": (4 * n + stat, 4 * D * pairs),
            "flash_bwd_dq": (5 * n + 2 * stat, 6 * D * pairs),
            "flash_bwd_dkv": (6 * n + 2 * stat, 8 * D * pairs)}
    for name, (nbytes, flops) in work.items():
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        t[name]["bound_ms"] = 1e3 * max(tb, tf)
        t[name]["bound_by"] = "bytes" if tb >= tf else "operations"
    return t


def _issue_us(torch, fn, n: int = 100) -> float:
    """Host time to issue one call (until it returns), over n calls in a
    row after a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def phase_flash_timing(torch, fa, dev, gen, inputs, card):
    """The training shape (its entries feed the kernels line), then the
    layer's unmasked shape and the training shape in fp16 and at d = 96;
    the host issue time of one forward and one backward call."""
    q, k, v, do, out, lse = inputs
    t = _flash_times(torch, fa, q, k, v, do, out, lse, True)
    for name, vals in t.items():
        for key, val in vals.items():
            print(f"{name}_{key}={val} card={card}", flush=True)
    for tag, (B, S, H, D, causal, dtype) in (
            ("layer", (8, 512, 16, 64, False, torch.bfloat16)),
            ("train_fp16", (8, 1024, 12, 64, True, torch.float16)),
            ("train_d96", (8, 1024, 8, 96, True, torch.bfloat16))):
        xs = [x.to(dtype) for x in _qkv(torch, dev, gen, B, S, H, D)]
        o, l = fa.flash_attention_forward(*xs[:3], causal, D ** -0.5)
        extra = _flash_times(torch, fa, *xs, o, l, causal)
        for name, vals in extra.items():
            print(f"phase11 {tag} B={B} S={S} H={H} D={D} causal={causal} "
                  f"{str(dtype)[6:]} {name} " + " ".join(
                      f"{key}={val}" for key, val in vals.items())
                  + f" card={card}", flush=True)
        del xs, o, l, extra
    scale = q.shape[-1] ** -0.5
    fwd_us = _issue_us(torch, lambda: fa.flash_attention_forward(
        q, k, v, True, scale))
    bwd_us = _issue_us(torch, lambda: fa.flash_attention_backward(
        q, k, v, out, lse, do, True, scale))
    print(f"phase11 host issue us per call: forward={fwd_us} "
          f"backward (delta, dq, dk/dv)={bwd_us} card={card}", flush=True)
    return t


def bench_sparsity(heads: int = 12):
    """bench.py's long-context layout (bench.py:365-371)."""
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    return BigBirdSparsityConfig(num_heads=heads, block=64,
                                 different_layout_per_head=False,
                                 num_random_blocks=3,
                                 num_sliding_window_blocks=3,
                                 num_global_blocks=1)


def live_causal_pairs(sparsity, S: int, batch: int) -> int:
    """The (query, key) pairs a causal layout at S lets attend, over heads
    and batch rows, counted from the fine layout: block^2 per live block
    below the diagonal, block (block + 1) / 2 per diagonal block (the work
    of one call, for the bounds)."""
    import numpy as np
    lay = np.asarray(sparsity.make_layout(S), bool)
    b = sparsity.block
    below = int(np.tril(lay, -1).sum())
    diagonal = int(np.trace(lay, axis1=1, axis2=2).sum())
    return batch * (below * b * b + diagonal * b * (b + 1) // 2)


def _layout(cfg, S, causal, dev):
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import compiled_layout
    return compiled_layout(cfg, S, causal).on(dev)


@contextlib.contextmanager
def plain_sparse(sa):
    """Route the SparseAttention autograd function through the plain
    versions (on the card they are reached only here, for comparison)."""
    saved = sa.sparse_attention_forward, sa.sparse_attention_backward
    sa.sparse_attention_forward = sa.sparse_attention_forward_reference
    sa.sparse_attention_backward = sa.sparse_attention_backward_reference
    try:
        yield
    finally:
        sa.sparse_attention_forward, sa.sparse_attention_backward = saved


def _over_bound(got, ref, atol, rtol):
    """(largest |got - ref| / (atol + rtol |ref|), elements above 1): the
    elementwise reading where the check uses the row-scaled bound."""
    ratio = (got.float() - ref.float()).abs() / (atol + rtol
                                                 * ref.float().abs())
    return ratio.max().item(), int((ratio > 1).sum())


def _sparse_pair(torch, sa, layout, q, k, v, do, kvm, tol, rows=False):
    """Kernels vs plain versions on one input (elementwise bound; ``rows``:
    the row-scaled one, and the elementwise reading printed beside it): max
    abs errs, and the plain forward's out/lse and the kernels' grads."""
    scale = q.shape[-1] ** -0.5
    out, lse = sa.sparse_attention_forward(q, k, v, layout, scale, kvm)
    ro, rl = sa.sparse_attention_forward_reference(q, k, v, layout, scale,
                                                   kvm)
    grads = sa.sparse_attention_backward(q, k, v, ro, rl, do, layout, scale,
                                         kvm)
    refs = sa.sparse_attention_backward_reference(q, k, v, ro, rl, do,
                                                  layout, scale, kvm)
    torch.cuda.synchronize()
    if rows:
        print("phase17 elementwise reading (largest |err| / (atol + rtol "
              "|ref|), elements above 1): " + " ".join(
                  f"{name}={_over_bound(g, r, *tol)}" for name, g, r in
                  zip(("out", "dq", "dk", "dv"), (out, *grads),
                      (ro, *refs))), flush=True)
    e = {"sparse_fwd": _close(out, ro, *tol, rows=rows),
         "lse": _close(lse, rl, LSE_ATOL, 0.0),
         "sparse_bwd_dq": _close(grads[0], refs[0], *tol, rows=rows),
         "sparse_bwd_dkv": max(_close(grads[1], refs[1], *tol, rows=rows),
                               _close(grads[2], refs[2], *tol, rows=rows))}
    return e, (out, lse, ro, rl, grads)


class _HoleyLayout:
    """Windows of 2 blocks of 16, no global block; key blocks 8.. are seen
    by no query (empty column LUTs) and query blocks 8.. see nothing."""
    block, attention = 16, "bidirectional"

    def __init__(self, heads):
        self.heads = heads

    def make_layout(self, seq_len):
        import numpy as np
        nb = seq_len // 16
        lay = np.zeros((self.heads, nb, nb), np.int64)
        for i in range(nb):
            lay[:, i, (i // 2) * 2:(i // 2) * 2 + 2] = 1
        lay[:, :, 8:] = 0
        return lay


def phase_sparse_parity(torch, sa, dev, gen):
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    worst = {}
    for dtype, tol in ((torch.bfloat16, FLASH_TOL),
                       (torch.float16, FLASH_TOL),
                       (torch.float32, SPARSE_F32_TOL)):
        # d = 96 (gpt_neox_20b's head dim), block 32, S a partial tile
        cfg = BigBirdSparsityConfig(num_heads=4, block=32,
                                    different_layout_per_head=True,
                                    num_random_blocks=2)
        for causal in (True, False):
            q, k, v, do = (t.to(dtype) for t in _qkv(torch, dev, gen, 2, 480,
                                                      4, 96))
            e, _ = _sparse_pair(torch, sa, _layout(cfg, 480, causal, dev),
                                q, k, v, do, None, tol)
            print(f"phase12 sparse {str(dtype)[6:]} D=96 block=32 S=480 "
                  f"causal={causal} max_abs_err " + " ".join(
                      f"{k_}={v_:.3g}" for k_, v_ in e.items()), flush=True)
        for block in (16, 32, 64, 128):
            S = 480 if block == 16 else 512     # 480: a partial last tile
            cfg = BigBirdSparsityConfig(num_heads=4, block=block,
                                        different_layout_per_head=True,
                                        num_random_blocks=2)
            for causal in (True, False):
                for masked in (False, True):
                    q, k, v, do = _qkv(torch, dev, gen, 2, S, 4, 64)
                    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
                    kvm = None
                    if masked:
                        kvm = torch.ones(2, S, device=dev)
                        kvm[0, 300:] = 0
                    e, (*_, grads) = _sparse_pair(
                        torch, sa, _layout(cfg, S, causal, dev), q, k, v,
                        do, kvm, tol)
                    if masked and (grads[1][0, 300:].any()
                                   or grads[2][0, 300:].any()):
                        fail("non-zero dk/dv at masked keys")
                    for key, val in e.items():
                        worst[key] = max(worst.get(key, 0.0), val)
                    print(f"phase12 sparse {str(dtype)[6:]} block={block} "
                          f"S={S} causal={causal} masked={masked} "
                          f"max_abs_err " + " ".join(
                              f"{k_}={v_:.3g}" for k_, v_ in e.items()),
                          flush=True)
        # dead query rows and key tiles no query reaches
        q, k, v, do = (t.to(dtype) for t in _qkv(torch, dev, gen, 2, 256,
                                                  2, 64))
        kvm = torch.ones(2, 256, device=dev)
        kvm[1, 40:] = 0
        _, (out, lse, *_, (dq, dk, dv)) = _sparse_pair(
            torch, sa, _layout(_HoleyLayout(2), 256, False, dev), q, k, v,
            do, kvm, tol)
        if (out[:, 128:].any() or out[1, 64:].any() or dq[:, 128:].any()
                or dk[:, 128:].any() or dv[:, 128:].any()
                or not bool((lse[:, :, 128:] == -1e30).all())):
            fail("dead rows / unreached key tiles are not zero")
        print(f"phase12 sparse {str(dtype)[6:]} dead rows and unreached key "
              f"tiles: zeros, lse -1e30", flush=True)
    print(f"phase12 sparse grid worst max_abs_err {worst} (tol bf16 and "
          f"fp16 atol {FLASH_TOL[0]} + rtol {FLASH_TOL[1]} |ref|, f32 "
          f"{SPARSE_F32_TOL})", flush=True)
    # the training shape with the bench's layout; its global key tile is
    # split over 512 / DKV_CHUNK dk/dv items, whose partials are summed in a
    # fixed order: a second backward gives bitwise the same grads
    layout = _layout(bench_sparsity(12), LONG_SEQ, True, dev)
    q, k, v, do = _qkv(torch, dev, gen, 1, LONG_SEQ, 12, 64)
    e, (_, _, ro, rl, grads) = _sparse_pair(torch, sa, layout, q, k, v, do,
                                            None, FLASH_TOL)
    again = sa.sparse_attention_backward(q, k, v, ro, rl, do, layout,
                                         64 ** -0.5)
    if not all(torch.equal(a, g) for a, g in zip(again, grads)):
        fail("a second sparse backward gave different grads")
    print(f"phase12 sparse train B=1 S={LONG_SEQ} H=12 D=64 bf16 causal "
          f"BigBird block 64 max_abs_err " + " ".join(
              f"{k_}={v_}" for k_, v_ in e.items())
          + "; a second backward bitwise equal", flush=True)
    return e, (q, k, v, do, ro, rl, layout)


def phase_long_training(torch, np, dev, seed, card):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, gpt2_125m, lm_loss_fn
    from deepspeed_tpu_torch.ops.cuda import _build
    cfg = gpt2_125m(max_seq_len=LONG_SEQ, dtype=torch.bfloat16,
                    attention_impl="sparse",
                    sparse_attention=bench_sparsity(12))
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    engine, *_ = dst.initialize(model=model, loss_fn=lm_loss_fn,
                                config=LONG_CONFIG)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, LONG_SEQ)).astype(np.int32)
    losses, norms, secs, per_step = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    for _ in range(4):                 # 1 warm-up + 3 timed steps
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        loss = engine.train_batch(iter([{"input_ids": ids}]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(engine.get_global_grad_norm())
        per_step.append({n: _build.LAUNCHES[n] - before.get(n, 0)
                         for n in SPARSE + FLASH})
    launches = {name: _build.LAUNCHES[name] for name in SPARSE}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase13 long-context training gpt2_125m seq={LONG_SEQ} "
          f"losses={losses} grad_norms={norms} step_s={secs} "
          f"launches_per_step={per_step}", flush=True)
    if not all(np.isfinite(losses + norms)):
        fail("non-finite loss or grad norm while training at seq 32768")
    if not losses[-1] < losses[0]:
        fail(f"the long-context loss did not fall: {losses}")
    want = {"sparse_fwd": 2 * cfg.num_layers,
            "sparse_bwd_dq": cfg.num_layers,
            "sparse_bwd_dkv": cfg.num_layers,
            **{n: 0 for n in FLASH}}
    if any(step != want for step in per_step):
        fail(f"launches per step {per_step}, expected {want}")
    step_s = sum(secs[1:]) / 3
    print(f"long_context_sparse_step_s={step_s} card={card}", flush=True)
    print(f"long_context_sparse_seq32k_tokens_s={LONG_SEQ / step_s} "
          f"card={card}", flush=True)
    print(f"long_context_sparse_peak_memory_gib={peak_gb} card={card}",
          flush=True)
    return engine, cfg, torch.from_numpy(ids).long().to(dev), launches


def phase_long_model_check(torch, sa, dev, engine, cfg, ids):
    """One step's loss and global grad norm of the trained long-context
    model through the kernels and through the plain versions, both bf16."""
    from deepspeed_tpu_torch.models.gpt import GPT, lm_loss_fn
    from deepspeed_tpu_torch.ops.cuda import _build
    result = {}
    for impl in ("kernels", "plain"):
        m = GPT(cfg, device=dev).to(torch.bfloat16)
        m.load_state_dict(engine.module.state_dict())
        before = sum(_build.LAUNCHES[n] for n in SPARSE)
        with (plain_sparse(sa) if impl == "plain"
              else contextlib.nullcontext()):
            loss = lm_loss_fn(m(ids), {"input_ids": ids})
            loss.backward()
        launched = sum(_build.LAUNCHES[n] for n in SPARSE) - before
        if (impl == "plain") != (launched == 0):
            fail(f"the {impl} model check launched {launched} kernels")
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.float().norm() for p in m.parameters()]))
        result[impl] = (loss.item(), norm.item())
        del m, loss
        torch.cuda.empty_cache()
    (lk, nk), (lp, np_) = result["kernels"], result["plain"]
    print(f"phase14 long-context model check seq={LONG_SEQ} loss "
          f"kernels={lk} plain={lp} (atol {LOSS_ATOL}); grad norm "
          f"kernels={nk} plain={np_} (rtol {GRAD_NORM_RTOL})", flush=True)
    if not (abs(lk - lp) <= LOSS_ATOL and abs(nk - np_) <= GRAD_NORM_RTOL
            * np_):
        fail("the long-context model through the kernels disagrees with "
             "the plain versions")


def phase_long_profile(torch, engine, ids, card):
    """One warmed long-context step (micro 1 x gas 1) timed without the
    profiler, then one under it; idle share against the unprofiled wall.
    Returns the step's wall, device busy ms, idle share and device ms by
    sparse kernel."""
    from torch.profiler import ProfilerActivity, profile
    batch = [{"input_ids": ids}]
    engine.train_batch(iter(batch))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_batch(iter(batch))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.train_batch(iter(batch))
        torch.cuda.synchronize()
    rows = [(_device_us(e) / 1e3, e.count, e.key)
            for e in prof.key_averages() if _device_us(e) > 0]
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        fail("the profiler recorded no device time for a sparse step")
    print(f"phase15 profile long-context step wall_ms={wall_ms} "
          f"(unprofiled) device_busy_ms={busy_ms} "
          f"idle_share={1 - busy_ms / wall_ms} "
          f"device_kernels={sum(r[1] for r in rows)} card={card}", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"phase15 kernel ms={ms} count={count} {key[:90]}", flush=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "sparse_ms": {key: ms for ms, _, key in rows
                          if "sparse_" in key}}


def _sdpa_with_mask(torch, dev, gen, S):
    """scaled_dot_product_attention at [1, 12, S, 64] bf16 with the bench
    layout (causal) expanded to a boolean [S, S] mask: forward and backward
    calls, or None when it does not fit on the card."""
    import torch.nn.functional as F
    lay = torch.from_numpy(bench_sparsity(12).make_layout(S)[0]).to(dev)
    try:
        mask = lay.bool().repeat_interleave(64, 0).repeat_interleave(64, 1)
        mask &= torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        qt, kt, vt, do = (torch.randn(1, 12, S, 64, device=dev,
                                      generator=gen).bfloat16()
                          for _ in range(4))
        qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        torch.autograd.grad(out, (qt, kt, vt), do, retain_graph=True)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None
    return (lambda i: F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=mask),
            lambda i: torch.autograd.grad(out, (qt, kt, vt), do,
                                          retain_graph=True))


def phase_sparse_timing(torch, sa, dev, gen, inputs, card):
    q, k, v, do, out, lse, layout = inputs
    B, S, H, D = q.shape
    scale = D ** -0.5

    def backward(i):
        sa.sparse_attention_backward(q, k, v, out, lse, do, layout, scale)

    plain_bwd = device_ms(lambda i: sa.sparse_attention_backward_reference(
        q, k, v, out, lse, do, layout, scale), iters=3, warmup=1)
    lib_s = S
    lib = _sdpa_with_mask(torch, dev, gen, lib_s)
    while lib is None and lib_s > 1024:
        lib_s //= 2
        lib = _sdpa_with_mask(torch, dev, gen, lib_s)
    lib_fwd = device_ms(lib[0], iters=5, warmup=1)
    lib_bwd = device_ms(lib[1], iters=5, warmup=1)
    del lib
    torch.cuda.empty_cache()
    print(f"phase16 library yardstick: scaled_dot_product_attention with "
          f"the expanded boolean mask at S={lib_s} (dense work), fwd "
          f"{lib_fwd} ms, bwd {lib_bwd} ms card={card}", flush=True)
    t = {
        "sparse_fwd": {
            "ms": device_ms(lambda i: sa.sparse_attention_forward(
                q, k, v, layout, scale), kernel="sparse_fwd", iters=20),
            "plain_ms": device_ms(
                lambda i: sa.sparse_attention_forward_reference(
                    q, k, v, layout, scale), iters=3, warmup=1),
            "library_ms": lib_fwd},
        # the plain and library backward compute dq, dk and dv together:
        # their times stand beside both kernels
        "sparse_bwd_dq": {"ms": device_ms(backward, kernel="sparse_bwd_dq",
                                          iters=20),
                          "plain_ms": plain_bwd, "library_ms": lib_bwd},
        "sparse_bwd_dkv": {"ms": device_ms(backward,
                                           kernel="sparse_bwd_dkv",
                                           iters=20),
                           "plain_ms": plain_bwd, "library_ms": lib_bwd},
    }
    # bytes: each input read once, each output written once, of the LUTs
    # the counts and the live entries (a tile index and a mask each; the
    # rows' padding is never read); operations: 2 per multiply-add over the
    # layout's live causal (q, k) pairs, at the bf16 peak
    item = q.element_size()
    n = B * S * H * D * item
    stat = B * H * S * 4
    lut_k = 4 * layout.cnt_k.numel() + 12 * int(layout.cnt_k.sum())
    lut_q = (4 * layout.cnt_q.numel() + 12 * int(layout.cnt_q.sum())
             + 4 * layout.dkv_items.numel())
    pairs = live_causal_pairs(bench_sparsity(H), S, B)
    print(f"phase16 live causal (q, k) pairs {pairs} of {B * H * S * S} "
          f"({pairs / (B * H * S * S)}); LUT bytes read: row {lut_k}, "
          f"column {lut_q}", flush=True)
    work = {"sparse_fwd": (4 * n + stat + lut_k, 4 * D * pairs),
            "sparse_bwd_dq": (5 * n + 2 * stat + lut_k, 6 * D * pairs),
            "sparse_bwd_dkv": (6 * n + 2 * stat + lut_q, 8 * D * pairs)}
    for name, (nbytes, flops) in work.items():
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        t[name]["bound_ms"] = 1e3 * max(tb, tf)
        t[name]["bound_by"] = "bytes" if tb >= tf else "operations"
        for key, val in t[name].items():
            print(f"{name}_{key}={val} card={card}", flush=True)
        print(f"phase16 {name} {t[name]['ms']} ms = "
              f"{t[name]['ms'] / t[name]['bound_ms']} x its bound "
              f"({t[name]['bound_by']}); plain {t[name]['plain_ms']} ms, "
              f"SDPA with the mask {t[name]['library_ms']} ms card={card}",
              flush=True)
    return t


def phase_sparse_bert(torch, np, sa, dev, gen, seed):
    from deepspeed_tpu_torch.models.bert import BertForMaskedLM, bert_base
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, SparseAttentionUtils)
    sparsity = BigBirdSparsityConfig(num_heads=12, block=64)
    cfg = bert_base(max_seq_len=4096, dtype=torch.bfloat16,
                    hidden_dropout=0.0, attention_impl="sparse",
                    sparse_attention=sparsity)
    model = BertForMaskedLM(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed)
    b, S = len(BERT_LENGTHS), max(BERT_LENGTHS)
    ids = np.zeros((b, S), np.int64)
    mask = np.zeros((b, S), np.int64)
    for i, n in enumerate(BERT_LENGTHS):
        ids[i, :n] = rng.integers(1, cfg.vocab_size, n)
        mask[i, :n] = 1
    pad_len, ids_t, mask_t, _ = SparseAttentionUtils.pad_to_block_size(
        sparsity.block, torch.from_numpy(ids).to(dev),
        attention_mask=torch.from_numpy(mask).to(dev))
    picked = torch.from_numpy((rng.random((b, S)) < 0.15) * mask).to(dev)
    result = {}
    for impl in ("kernels", "plain"):
        model.zero_grad(set_to_none=True)
        before = {n: _build.LAUNCHES[n] for n in SPARSE}
        with (plain_sparse(sa) if impl == "plain"
              else contextlib.nullcontext()):
            logits = model(ids_t, attention_mask=mask_t).float()
            nll = torch.logsumexp(logits, -1) - torch.gather(
                logits, -1, ids_t[..., None])[..., 0]
            loss = (nll * picked).sum() / picked.sum()
            loss.backward()
        torch.cuda.synchronize()
        launched = {n: _build.LAUNCHES[n] - before[n] for n in SPARSE}
        want = cfg.num_layers if impl == "kernels" else 0
        if any(v != want for v in launched.values()):
            fail(f"sparse BERT ({impl}) launches {launched}, expected "
                 f"{want} each")
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if not (torch.isfinite(loss) and all(
                bool(torch.isfinite(g).all()) for g in grads)):
            fail(f"sparse BERT ({impl}): non-finite loss or grads")
        norm = torch.linalg.vector_norm(torch.stack(
            [g.float().norm() for g in grads]))
        result[impl] = (loss.item(), norm.item())
        del logits, nll, loss
    (lk, nk), (lp, np_) = result["kernels"], result["plain"]
    print(f"phase17 sparse BERT bert_base S={S} batch lengths "
          f"{BERT_LENGTHS} pad_len={pad_len} MLM loss kernels={lk} "
          f"plain={lp} (atol {LOSS_ATOL}); grad norm kernels={nk} "
          f"plain={np_} (rtol {GRAD_NORM_RTOL})", flush=True)
    if not (abs(lk - lp) <= LOSS_ATOL and abs(nk - np_) <= GRAD_NORM_RTOL
            * np_):
        fail("sparse BERT through the kernels disagrees with the plain "
             "versions")
    del model
    torch.cuda.empty_cache()
    # the kernels at BERT's shape with its key-padding mask
    q, k, v, do = _qkv(torch, dev, gen, b, S, 12, 64)
    kvm = mask_t.float().contiguous()
    e, (*_, (dq, dk, dv)) = _sparse_pair(
        torch, sa, _layout(sparsity, S, False, dev), q, k, v, do, kvm,
        FLASH_TOL, rows=True)
    padded = ~mask_t.bool()
    if dk[padded].any() or dv[padded].any():
        fail("sparse BERT: non-zero dk/dv at padded keys")
    print(f"phase17 sparse kernels at B={b} S={S} H=12 D=64 bf16 "
          f"bidirectional with key padding: dk/dv zero at padded keys, "
          f"max_abs_err " + " ".join(f"{k_}={v_}" for k_, v_ in e.items())
          + f" (tol atol {FLASH_TOL[0]} + rtol {FLASH_TOL[1]} x the row's "
          f"largest |ref|)", flush=True)


PAGED_BS = 16
INT8_KERNELS = ("decode_attention_int8", "paged_decode_attention_int8")
DECODE_KERNELS = ("decode_attention", "paged_decode_attention") \
    + INT8_KERNELS


def _to_pool(x, perm, bs):
    """A dense cache [b, S, ...] laid out as a block pool [b*T, bs, ...]
    whose block perm[j] holds the cache's j-th block (rows in order): read
    back through the tables perm.view(b, T)."""
    b, S = x.shape[:2]
    blocks = x.reshape(b * S // bs, bs, *x.shape[2:])
    pool = blocks.new_empty(blocks.shape)
    pool[perm] = blocks
    return pool


def _quantize(qz, x):
    """quantize_kv over the last dim: (int8 payload, f32 scales [..])."""
    q, s = qz.quantize_kv(x)
    return q, s[..., 0].contiguous()


def _decode_err(torch, got, ref, what, rtol=0.0) -> float:
    """max |got - ref| after checking |got - ref| <= DECODE_ATOL + rtol
    |ref| elementwise."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite output")
    diff = (got.float() - ref.float()).abs()
    if bool((diff > DECODE_ATOL + rtol * ref.float().abs()).any()):
        fail(f"{what} disagrees with its plain version: {diff.max().item()}")
    return diff.max().item()


def phase_paged_parity(torch, da, qz, dev, gen):
    b, S, h, d, bs = 8, 1024, 12, 64, PAGED_BS
    T, hd = S // bs, h * d
    errs = {name: 0.0 for name in ("paged_decode_attention",)
            + INT8_KERNELS}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for s_q in (1, 4):
            clen = torch.tensor([0, 1, 17, 512, 1024, 300, 777, S + s_q],
                                dtype=torch.int32, device=dev)
            q = torch.randn(b, s_q, h, d, device=dev, generator=gen).to(dtype)
            k = torch.randn(b, S, hd, device=dev, generator=gen).to(dtype)
            v = torch.randn(b, S, hd, device=dev, generator=gen).to(dtype)
            perm = torch.randperm(b * T, device=dev, generator=gen)
            tables = perm.view(b, T).int().contiguous()
            in_order = torch.arange(b * T, dtype=torch.int32,
                                    device=dev).view(b, T)
            live = (clen.clamp(max=S) + bs - 1) // bs
            sentinel = torch.where(
                torch.arange(T, device=dev)[None, :] >= live[:, None],
                b * T, tables).int().contiguous()
            kp, vp = _to_pool(k, perm, bs), _to_pool(v, perm, bs)
            dense = da.decode_attention(q, k, v, clen)
            outs = {"permuted": da.paged_decode_attention(q, kp, vp, tables,
                                                          clen),
                    "in-order": da.paged_decode_attention(
                        q, k.view(b * T, bs, hd), v.view(b * T, bs, hd),
                        in_order, clen),
                    "sentinel": da.paged_decode_attention(q, kp, vp,
                                                          sentinel, clen)}
            torch.cuda.synchronize()
            for name, out in outs.items():
                if not torch.equal(out, dense):
                    fail(f"B3 over the {name} table is not bitwise B2 "
                         f"({dtype}, s_q={s_q})")
            got = outs["sentinel"]
            ref = da.paged_decode_attention_reference(q, kp, vp, sentinel,
                                                      clen, 1 / 8)
            e3 = _decode_err(torch, got, ref, "paged_decode_attention")
            if got[0].any():
                fail("paged_decode_attention: the fill-0 row is not zero")
            (kq, ks), (vq, vs) = _quantize(qz, k), _quantize(qz, v)
            d8 = da.decode_attention(q, kq, vq, clen, k_scale=ks, v_scale=vs)
            p8 = da.paged_decode_attention(
                q, _to_pool(kq, perm, bs), _to_pool(vq, perm, bs), sentinel,
                clen, k_scale=_to_pool(ks, perm, bs),
                v_scale=_to_pool(vs, perm, bs))
            torch.cuda.synchronize()
            rtol = DECODE_INT8_RTOL if dtype != torch.float32 else 0.0
            e2q = _decode_err(torch, d8, da.decode_attention_reference(
                q, kq, vq, clen, 1 / 8, ks, vs), "decode_attention_int8",
                rtol)
            e3q = _decode_err(torch, p8, da.paged_decode_attention_reference(
                q, _to_pool(kq, perm, bs), _to_pool(vq, perm, bs), sentinel,
                clen, 1 / 8, _to_pool(ks, perm, bs), _to_pool(vs, perm, bs)),
                "paged_decode_attention_int8", rtol)
            if not torch.equal(p8, d8):
                fail(f"B3-int8 is not bitwise B2-int8 ({dtype}, s_q={s_q})")
            if d8[0].any() or p8[0].any():
                fail("int8 decode: the fill-0 row is not zero")
            for name, e in zip(errs, (e3, e2q, e3q)):
                errs[name] = max(errs[name], e)
            print(f"phase18 {str(dtype)[6:]} s_q={s_q} b={b} S={S} h={h} "
                  f"d={d} block={bs}: B3 bitwise B2 over permuted, in-order "
                  f"and sentinel tables; max_abs_err B3={e3} B2-int8={e2q} "
                  f"B3-int8={e3q} (tol {DECODE_ATOL}, int8 in 16 bits + "
                  f"{DECODE_INT8_RTOL} |ref|); fill-0 row zeros; "
                  f"B3-int8 bitwise B2-int8", flush=True)
    return errs


def _checked_logits(torch, module, dev):
    """Wrap ``module.logits`` so every served logits tensor is checked
    finite; returns the flag that turns True on a non-finite one."""
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    unchecked = module.logits

    def checked(hidden):
        out = unchecked(hidden)
        bad.logical_or_(~torch.isfinite(out).all())
        return out

    module.logits = checked
    return bad


def _serve(torch, eng, prompts, n_new):
    """One timed main-path run with the counts reset just before and read
    just after: (requests, seconds, launches)."""
    from deepspeed_tpu_torch.ops.cuda import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run([p.copy() for p in prompts], max_new_tokens=n_new)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    for r in out:
        if r.status != "done" or len(r.tokens) != n_new:
            fail(f"request {r.uid}: status {r.status}, {len(r.tokens)} "
                 f"tokens")
    return out, seconds, launches


def _want_launches(launches, kernel, what):
    if not launches.get(kernel) or not launches.get("sampling"):
        fail(f"{what} never launched {kernel} and sampling: {launches}")
    other = [k for k in DECODE_KERNELS if k != kernel and launches.get(k)]
    if other:
        fail(f"{what} launched {other}: {launches}")


def phase_paged_serving(torch, np, dev, seed, card):
    from deepspeed_tpu_torch import InferenceEngine, ServingEngine
    from deepspeed_tpu_torch.models.gpt import GPT, gpt2_125m
    cfg = gpt2_125m(max_seq_len=1024, dtype=torch.bfloat16)
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    ie = InferenceEngine(model, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(seed + 1)
    distinct = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
                for n in rng.integers(16, 129, 12)]
    # the repeats follow the first round of 8 admissions, whose prompts
    # are in the prefix cache by then
    twins = {12: 0, 13: 2, 14: 5, 15: 7}
    prompts = distinct + [distinct[j].copy() for j in twins.values()]
    kw = dict(max_batch=8, decode_chunk=8, max_prompt_len=128,
              megakernel=True)
    paged_kw = dict(kw, paged=True, kv_block_size=PAGED_BS)
    n_new = 64
    ServingEngine(engine=ie, **paged_kw).run(
        [p.copy() for p in prompts[:2]], max_new_tokens=4)    # warm-up
    eng = ServingEngine(engine=ie, **paged_kw)
    out, seconds, launches = _serve(torch, eng, prompts, n_new)
    print(f"phase19 paged serving gpt2_125m requests=16 block={PAGED_BS} "
          f"launches={launches}", flush=True)
    _want_launches(launches, "paged_decode_attention", "the paged main path")
    m = eng.metrics
    distinct_tokens = sum(len(p) for p in distinct)
    print(f"phase19 prefix cache hits={m.n_prefix_hits} "
          f"misses={m.n_prefix_misses} cow_forks={m.n_cow_forks} "
          f"prefill_prompt_tokens={m.prefill_prompt_tokens} (distinct "
          f"prompts {distinct_tokens})", flush=True)
    if (m.n_prefix_hits, m.n_prefix_misses) != (4, 12):
        fail("prefix-cache hits/misses are not 4/12")
    if m.prefill_prompt_tokens != distinct_tokens:
        fail("prefill ran over other prompts than the 12 distinct ones")
    for i, j in twins.items():
        if out[i].tokens != out[j].tokens:
            fail(f"prefix-cache hit {i} served other tokens than its twin "
                 f"{j}")
    n_tokens = sum(len(r.tokens) for r in out)
    print(f"paged_serving_tokens_per_s={n_tokens / seconds} card={card}",
          flush=True)
    print(f"paged_serving_mean_decode_chunk_ms="
          f"{m.mean_decode_chunk_s * 1e3} (K=8, batch 8) card={card}",
          flush=True)
    rep = eng.kv.arena_report()
    print(f"phase19 arena blocks_total={rep['blocks_total']} "
          f"blocks_peak_used={rep['blocks_peak_used']} "
          f"prefix_cache_blocks={rep['prefix_cache_blocks']} "
          f"kv_bytes={rep['kv_bytes']}", flush=True)
    dense, dense_s, dense_launches = _serve(
        torch, ServingEngine(engine=ie, **kw), prompts, n_new)
    _want_launches(dense_launches, "decode_attention", "the dense engine")
    print(f"dense_serving_tokens_per_s={n_tokens / dense_s} (the same 16 "
          f"requests) card={card}", flush=True)
    diff = [i for i, (r, s) in enumerate(zip(out, dense))
            if r.tokens != s.tokens]
    if diff:
        i = diff[0]
        at = next(t for t, (a, b) in enumerate(zip(out[i].tokens,
                                                   dense[i].tokens)) if a != b)
        fail(f"paged tokens differ from the dense engine's in requests "
             f"{diff} (request {i} from token {at})")
    print("phase19 paged tokens equal the dense megakernel engine's; hits "
          "equal their twins", flush=True)
    phase_profile(torch, ie, prompts[:8], paged_kw, card, tag="phase19")
    return launches, ie, prompts, [r.tokens for r in dense]


def phase_int8_serving(torch, np, dev, ie, prompts, bf16_tokens, card):
    from deepspeed_tpu_torch import ServingEngine
    kw = dict(max_batch=8, decode_chunk=8, max_prompt_len=128,
              megakernel=True, kv_dtype="int8")
    n_new = 64
    tokens, launches = {}, {}
    for name, extra, kernel in (
            ("dense", {}, "decode_attention_int8"),
            ("paged", dict(paged=True, kv_block_size=PAGED_BS),
             "paged_decode_attention_int8")):
        ServingEngine(engine=ie, **kw, **extra).run(
            [p.copy() for p in prompts[:2]], max_new_tokens=4)   # warm-up
        eng = ServingEngine(engine=ie, **kw, **extra)
        bad = _checked_logits(torch, eng.module, dev)
        out, seconds, launched = _serve(torch, eng, prompts, n_new)
        print(f"phase20 int8 {name} serving launches={launched}", flush=True)
        _want_launches(launched, kernel, f"int8 {name} serving")
        if bool(bad):
            fail(f"non-finite logits while serving int8 {name}")
        rep = eng.kv.arena_report()
        share = rep["int8_payload_bytes"] / rep["kv_bytes_fp_equiv"]
        print(f"phase20 int8 {name} arena int8_payload_bytes="
              f"{rep['int8_payload_bytes']} scale_bytes={rep['scale_bytes']} "
              f"kv_bytes_fp_equiv={rep['kv_bytes_fp_equiv']} payload share "
              f"{share} kv_bytes/fp {rep['kv_bytes'] / rep['kv_bytes_fp_equiv']}"
              f" prefix hits={eng.metrics.n_prefix_hits}", flush=True)
        if not share <= 0.5:
            fail(f"int8 {name} payload is {share} of the fp bytes")
        n_tokens = sum(len(r.tokens) for r in out)
        print(f"int8_{name}_serving_tokens_per_s={n_tokens / seconds} (every "
              f"served logits tensor checked finite) card={card}", flush=True)
        tokens[name] = [r.tokens for r in out]
        launches[kernel] = launched[kernel]
    if tokens["dense"] != tokens["paged"]:
        fail("dense and paged int8 serving gave different greedy tokens")
    agree = sum(int(a == b) for r, s in zip(tokens["dense"], bf16_tokens)
                for a, b in zip(r, s))
    total = sum(len(r) for r in bf16_tokens)
    print(f"phase20 dense and paged int8 tokens equal; tokens equal to the "
          f"bf16 engine's: {agree}/{total} = {agree / total}", flush=True)
    return launches


# tools/time_decode.py's cases at phase 2's geometry (bf16): phase 2's mixed
# fills (and the sentinel row) with s_q 1 and 4, and every row full
DECODE_FILLS = (1, 17, 512, 1024, 300, 64, 777)
DECODE_TIME_CASES = {"mixed_sq1": (1, False), "mixed_sq4": (4, False),
                     "full_sq1": (1, True)}


def decode_case_inputs(torch, dev, gen, s_q, full):
    """(q, k, v, cache_len) at GPT-2 125M decode geometry (b 8, S 1024,
    h 12, d 64, bf16): phase 2's fills plus the retired-lane sentinel row,
    or every row at S."""
    b, S, h, d = 8, 1024, 12, 64
    fills = [S] * b if full else list(DECODE_FILLS) + [S + s_q]
    clen = torch.tensor(fills, dtype=torch.int32, device=dev)
    q = torch.randn(b, s_q, h, d, device=dev, generator=gen).bfloat16()
    k = torch.randn(b, S, h * d, device=dev, generator=gen).bfloat16()
    v = torch.randn(b, S, h * d, device=dev, generator=gen).bfloat16()
    return q, k, v, clen


def decode_copies(torch, da, qz, dev, gen, inputs):
    """8 copies of the cache in each layout (dense; paged over a random
    block order, block PAGED_BS; int8 dense and paged) so each call reads
    its K/V cold from HBM, as a layer's call does in the model; the block
    tables; and a call of each decode kernel on one copy."""
    q, k, v, clen = inputs
    b, S = k.shape[:2]
    bs = PAGED_BS
    T = S // bs
    perm = torch.randperm(b * T, device=dev, generator=gen)
    tables = perm.view(b, T).int().contiguous()
    copies = []
    for _ in range(8):
        (kq, ks), (vq, vs) = _quantize(qz, k), _quantize(qz, v)
        copies.append({
            "dense": (k.clone(), v.clone()),
            "paged": (_to_pool(k, perm, bs), _to_pool(v, perm, bs)),
            "dense8": (kq, vq, ks, vs),
            "paged8": tuple(_to_pool(t, perm, bs) for t in (kq, vq, ks, vs))})
    calls = {
        "decode_attention":
            lambda c: da.decode_attention(q, *c["dense"], clen),
        "paged_decode_attention":
            lambda c: da.paged_decode_attention(q, *c["paged"], tables, clen),
        "decode_attention_int8":
            lambda c: da.decode_attention(q, *c["dense8"][:2], clen,
                                          k_scale=c["dense8"][2],
                                          v_scale=c["dense8"][3]),
        "paged_decode_attention_int8":
            lambda c: da.paged_decode_attention(
                q, *c["paged8"][:2], tables, clen, k_scale=c["paged8"][2],
                v_scale=c["paged8"][3]),
    }
    return copies, tables, calls


def print_decode_cases(torch, da, qz, dev, gen, names, tag, card):
    """The named kernels' device ms at the s_q = 4 and full-fill cases."""
    for case in ("mixed_sq4", "full_sq1"):
        s_q, full = DECODE_TIME_CASES[case]
        copies, _, calls = decode_copies(
            torch, da, qz, dev, gen,
            decode_case_inputs(torch, dev, gen, s_q, full))
        for name in names:
            ms = device_ms(lambda i: calls[name](copies[i]), 8,
                           "decode_attention_kernel")
            print(f"{tag} {name} {case} ms={ms} card={card}", flush=True)


def phase_paged_timing(torch, da, qz, dev, gen, decode_inputs, card):
    import torch.nn.functional as F
    q, k, v, clen = decode_inputs              # bf16, s_q 1, B2's fills
    b, s_q, h, d = q.shape
    S, hd, bs = k.shape[1], h * d, PAGED_BS
    T = S // bs
    copies, tables, kernels = decode_copies(torch, da, qz, dev, gen,
                                            decode_inputs)
    p = torch.arange(S, device=dev)
    flat = (tables.long()[:, p // bs] * bs + p % bs).reshape(-1)
    mask = (p[None, :] < clen.clamp(max=S)[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)

    def sdpa(kk, vv):
        return F.scaled_dot_product_attention(
            qt, kk.view(b, S, h, d).transpose(1, 2),
            vv.view(b, S, h, d).transpose(1, 2), attn_mask=mask, scale=1 / 8)

    def gather(pool):
        return pool.reshape(b * T * bs, -1).index_select(0, flat)

    def dequant(x, s):
        return (x.float() * s.reshape(*x.shape[:-1], 1)).bfloat16()

    calls = {
        "decode_attention": (kernels["decode_attention"], None, None),
        "paged_decode_attention": (
            kernels["paged_decode_attention"],
            lambda c: da.paged_decode_attention_reference(
                q, *c["paged"], tables, clen, 1 / 8),
            lambda c: sdpa(gather(c["paged"][0]), gather(c["paged"][1]))),
        "decode_attention_int8": (
            kernels["decode_attention_int8"],
            lambda c: da.decode_attention_reference(q, *c["dense8"][:2],
                                                    clen, 1 / 8,
                                                    *c["dense8"][2:]),
            lambda c: sdpa(dequant(c["dense8"][0], c["dense8"][2]),
                           dequant(c["dense8"][1], c["dense8"][3]))),
        "paged_decode_attention_int8": (
            kernels["paged_decode_attention_int8"],
            lambda c: da.paged_decode_attention_reference(
                q, *c["paged8"][:2], tables, clen, 1 / 8, *c["paged8"][2:]),
            lambda c: sdpa(dequant(gather(c["paged8"][0]),
                                   gather(c["paged8"][2])),
                           dequant(gather(c["paged8"][1]),
                                   gather(c["paged8"][3])))),
    }
    live = clen.clamp(max=S).sum().item()
    blocks = ((clen.clamp(max=S) + bs - 1) // bs).sum().item()
    item = q.element_size()
    qo = 2 * q.numel() * item + 4 * b          # q, out, cache_len
    nbytes = {"decode_attention": 2 * live * hd * item + qo,
              "paged_decode_attention": 2 * live * hd * item + qo + 4 * blocks,
              "decode_attention_int8": 2 * live * (hd + 4) + qo,
              "paged_decode_attention_int8": 2 * live * (hd + 4) + qo
              + 4 * blocks}
    flops = 4 * live * hd * s_q
    b2_ms = None
    t = {}
    for name, (kernel, plain, lib) in calls.items():
        ms = device_ms(lambda i: kernel(copies[i]), 8,
                       "decode_attention_kernel")
        if name == "decode_attention":
            b2_ms = ms
            print(f"phase21 B2 at the same fills {ms} ms card={card}",
                  flush=True)
            continue
        tb, tf = nbytes[name] / HBM_BYTES_PER_S, flops / BF16_FLOPS
        t[name] = {"ms": ms,
                   "plain_ms": device_ms(lambda i: plain(copies[i]), 8),
                   "library_ms": device_ms(lambda i: lib(copies[i]), 8),
                   "bound_ms": 1e3 * max(tb, tf),
                   "bound_by": "bytes" if tb >= tf else "operations"}
        for key, val in t[name].items():
            print(f"{name}_{key}={val} card={card}", flush=True)
        print(f"phase21 {name}: {ms / b2_ms} x B2's time at the same fills",
              flush=True)
    print("phase21 library_ms of B3 is a yardstick of two calls: "
          "index_select gathers of K and V through the table, then "
          "scaled_dot_product_attention with a boolean mask; int8 adds a "
          "dequantize (payload x scale, to bf16) between them (dense int8: "
          "dequantize + SDPA)", flush=True)
    print_decode_cases(torch, da, qz, dev, gen, DECODE_KERNELS[1:],
                       "phase21", card)
    return t

# ---------------------------------------------------------------------------
# Slice 5: the fused transformer ops (B6, B7, B8) and DeepSpeedTransformerLayer
# ---------------------------------------------------------------------------

ROWWISE = ("layer_norm_fwd", "layer_norm_dx", "bias_gelu_fwd",
           "bias_gelu_bwd", "softmax_fwd", "softmax_bwd")
# (atol, rtol) of a row-wise kernel vs its plain version: both compute in
# f32 and round once to the element type, so bf16 agrees within one ulp
# (2^-7 relative) and f32 within summation order and the rsqrtf / tanhf /
# expf roundings; gradients sum rows of products (1e-4 absolute)
ROW_FWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2 ** -7)}
ROW_GRAD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 2 ** -7)}
# bert_large widths (deepspeed_tpu/models/bert.py:69-71), pre-LN, BERT's eps
LAYER_KW = dict(hidden_size=1024, heads=16, intermediate_size=4096,
                num_hidden_layers=24, pre_layer_norm=True,
                layer_norm_eps=1e-12)
LAYER_MICRO, LAYER_SEQ = 8, 512
LAYER_LENGTHS = (512, 448, 384, 320, 256, 192, 128, 64)
LAYER_CONFIG = {"train_micro_batch_size_per_gpu": LAYER_MICRO,
                "gradient_accumulation_steps": 1,
                "bf16": {"enabled": True},
                "zero_optimization": {"stage": 1},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                "steps_per_print": 100_000}
# model check, bf16 body through 24 layers: the kernels and the plain
# versions round the same f32 values, apart by one ulp where summation
# order moves a value across a rounding boundary
LAYER_LOSS_RTOL = 1e-2
LAYER_GRAD_NORM_RTOL = 5e-2


# the forwards' path edges (csrc/layer_norm.cu, csrc/softmax.cu): the widest
# rows a warp holds (1016 and 1024 elements; 1023 takes one element a pack),
# the narrowest a block holds (1025, 1032) and a block of two warps (2048)
ROW_EDGE_WIDTHS = (1016, 1032, 2048)
ROW_EDGE_SEQS = (1023, 1024, 1025, 2048)


def _misaligned(torch, t):
    """A contiguous copy of t that starts one element past a 16-byte
    boundary (the row-wise forwards then take one element a pack)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _row_close(got, ref, grad=False) -> float:
    atol, rtol = (ROW_GRAD_TOL if grad else ROW_FWD_TOL)[_dtype_name(ref)]
    return _close(got, ref, atol, rtol)


def phase_rowwise_parity(torch, ln, gl, sm, dev, gen):
    """Each row-wise kernel vs its plain version at the layer's shapes
    (BERT-large width, micro 8 x seq 512), bf16 and f32, and one odd
    shape each. Returns the max abs err per kernel and the bf16 / f32
    inputs that phase 24 times."""
    errs = {name: 0.0 for name in ROWWISE}
    inputs = {}

    def note(name, err):
        errs[name] = max(errs[name], err)

    N = LAYER_MICRO * LAYER_SEQ
    for dtype in (torch.bfloat16, torch.float32):
        for tag, (n, d) in (("layer", (N, 1024)), ("odd", (37, 1000)),
                            *(("edge", (37, d)) for d in ROW_EDGE_WIDTHS),
                            ("misaligned", (37, 1024))):
            x = (torch.randn(n, d, device=dev, generator=gen) * 2 + 1
                 ).to(dtype)
            dy = torch.randn(n, d, device=dev, generator=gen).to(dtype)
            if tag == "misaligned":
                x = _misaligned(torch, x)
            for pdt in (dtype, torch.float32):
                g = (1 + 0.3 * torch.randn(d, device=dev, generator=gen)
                     ).to(pdt)
                b = (0.3 * torch.randn(d, device=dev, generator=gen)).to(pdt)
                if tag == "misaligned":
                    g, b = _misaligned(torch, g), _misaligned(torch, b)
                y, mean, rstd = ln.layer_norm_forward(x, g, b, 1e-12)
                ry, rm, rr = ln.layer_norm_forward_reference(x, g, b, 1e-12)
                dx = ln.layer_norm_dx(x, g, rm, rr, dy)
                rdx = ln.layer_norm_backward_reference(x, g, rm, rr, dy)
                torch.cuda.synchronize()
                note("layer_norm_fwd", max(_row_close(y, ry),
                                           _close(mean, rm, 1e-5, 1e-5),
                                           _close(rstd, rr, 1e-5, 1e-5)))
                note("layer_norm_dx", _row_close(dx, rdx, grad=True))
                if tag == "layer" and pdt == dtype:
                    inputs[("ln", _dtype_name(x))] = (x, g, b, rm, rr, dy)
        for tag, (n, d) in (("ffn", (N, 4096)), ("odd", (37, 1001))):
            x = (2 * torch.randn(n, d, device=dev, generator=gen)).to(dtype)
            b = (0.5 * torch.randn(d, device=dev, generator=gen)).to(dtype)
            dy = torch.randn(n, d, device=dev, generator=gen).to(dtype)
            y = gl.bias_gelu_forward(x, b)
            dx = gl.bias_gelu_backward(x, b, dy)
            torch.cuda.synchronize()
            note("bias_gelu_fwd",
                 _row_close(y, gl.bias_gelu_forward_reference(x, b)))
            note("bias_gelu_bwd", _row_close(
                dx, gl.bias_gelu_backward_reference(x, b, dy), grad=True))
            if tag == "ffn":
                inputs[("gelu", _dtype_name(x))] = (x, b, dy)
        for tag, shape in (("scores", (LAYER_MICRO, 16, LAYER_SEQ,
                                       LAYER_SEQ)),
                           ("odd", (2, 3, 77, 4099)),
                           *(("edge", (1, 2, 5, S)) for S in ROW_EDGE_SEQS),
                           ("misaligned", (2, 3, 77, 1024))):
            x = (3 * torch.randn(shape, device=dev, generator=gen)).to(dtype)
            dy = torch.randn(shape, device=dev, generator=gen).to(dtype)
            if tag == "misaligned":
                x, dy = _misaligned(torch, x), _misaligned(torch, dy)
            sq, S = shape[-2:]
            x2, dy2 = x.view(-1, S), dy.view(-1, S)
            for causal in (False, True):
                y = sm.softmax_forward(x2, sq, causal)
                ry = sm.softmax_forward_reference(x2, sq, causal)
                dx = sm.softmax_backward(ry, dy2)
                rdx = sm.softmax_backward_reference(ry, dy2)
                torch.cuda.synchronize()
                note("softmax_fwd", _row_close(y, ry))
                note("softmax_bwd", _row_close(dx, rdx, grad=True))
            if tag == "scores":
                inputs[("softmax", _dtype_name(x))] = (x2, ry, dy2)
                if dtype == torch.float32:
                    mask = torch.where(torch.rand(
                        LAYER_MICRO, 1, 1, LAYER_SEQ, device=dev,
                        generator=gen) < 0.25, -10000.0, 0.0)
                    got = sm.masked_softmax(x, mask, scale=0.125)
                    ref = sm.softmax_forward_reference(
                        (x * 0.125 + mask).view(-1, S), sq, False)
                    torch.cuda.synchronize()
                    note("softmax_fwd", _row_close(got.view(-1, S), ref))
        print(f"phase22 row-wise kernels vs plain {_dtype_name(x)}: "
              f"LayerNorm [{N}, 1024], [37, 1000], [37, d] for d in "
              f"{ROW_EDGE_WIDTHS} and [37, 1024] misaligned (gamma in the "
              f"element type and f32), bias-GELU [{N}, 4096] and [37, 1001], "
              f"softmax [{LAYER_MICRO}, 16, {LAYER_SEQ}, {LAYER_SEQ}], "
              f"[2, 3, 77, 4099], [1, 2, 5, S] for S in {ROW_EDGE_SEQS} and "
              f"[2, 3, 77, 1024] misaligned, causal and not, masked_softmax; "
              f"max_abs_err so far {errs}", flush=True)
    return errs, inputs


def phase_gelu_entry(torch, dev, gen):
    """The op entry of B7 (the layer's GELU is the erf GELU, so B7 is on no
    layer path): ``ops.transformer.bias_gelu`` and ``gelu`` forward and
    backward through autograd at the FFN activation of BERT-large width
    (micro 8 x seq 512 x 4096, bf16), counts reset just before and read
    just after."""
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.transformer import bias_gelu, gelu
    x = torch.randn(LAYER_MICRO, LAYER_SEQ, 4096, device=dev,
                    generator=gen).bfloat16().requires_grad_()
    b = torch.randn(4096, device=dev, generator=gen).bfloat16() \
        .requires_grad_()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    y = bias_gelu(x, b) + gelu(x)
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    launches = {n: _build.LAUNCHES[n] for n in ("bias_gelu_fwd",
                                                 "bias_gelu_bwd")}
    print(f"phase22 op entry bias_gelu + gelu fwd/bwd launches={launches}",
          flush=True)
    if launches != {"bias_gelu_fwd": 2, "bias_gelu_bwd": 2}:
        fail(f"the bias-GELU op entry launched {launches}, expected 2 / 2")
    if not (bool(x.grad.isfinite().all()) and bool(b.grad.isfinite().all())):
        fail("non-finite bias-GELU gradients")
    return launches


def _layer_stack(torch, dev, gen):
    """24 DeepSpeedTransformerLayers at bert_large width and the fixed
    key-padding mask of the phase as an integer buffer (the engine hands
    the module only the batch's inputs)."""
    from torch import nn
    import deepspeed_tpu_torch as dst
    cfg = dst.DeepSpeedTransformerConfig(**LAYER_KW)

    class LayerStack(nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = nn.ModuleList(
                dst.DeepSpeedTransformerLayer(cfg, device=dev, generator=gen)
                for _ in range(cfg.num_hidden_layers))
            lengths = torch.tensor(LAYER_LENGTHS, device=dev)
            self.register_buffer("mask", (torch.arange(
                LAYER_SEQ, device=dev)[None, :] < lengths[:, None]).int())
            self.use_mask = True

        def forward(self, x):
            mask = self.mask if self.use_mask else None
            for layer in self.layers:
                x = layer(x, mask, deterministic=True)
            return x
    return cfg, LayerStack()


def l2_loss(out, batch):
    """The TPU layer test's objective: the mean of the squared output."""
    return out.float().square().mean()


def phase_layer_training(torch, np, dev, gen, card):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.ops.cuda import _build
    cfg, stack = _layer_stack(torch, dev, gen)
    n_params = sum(p.numel() for p in stack.parameters())
    engine, *_ = dst.initialize(model=stack, loss_fn=l2_loss,
                                config=LAYER_CONFIG)
    x = torch.randn(LAYER_MICRO, LAYER_SEQ, cfg.hidden_size, device=dev,
                    generator=gen)
    batch = {"inputs": x}
    losses, norms, secs, per_step = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    for _ in range(4):                 # 1 warm-up + 3 timed steps
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        loss = engine.train_batch(iter([batch]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(engine.get_global_grad_norm())
        per_step.append({n: _build.LAUNCHES[n] - before.get(n, 0)
                         for n in ROWWISE + FLASH})
    launches = {name: _build.LAUNCHES[name] for name in ROWWISE}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase23 layer training {cfg.num_hidden_layers} x "
          f"DeepSpeedTransformerLayer(hidden {cfg.hidden_size}, heads "
          f"{cfg.heads}, intermediate {cfg.intermediate_size}, pre-LN) "
          f"params={n_params} micro={LAYER_MICRO} seq={LAYER_SEQ} "
          f"lengths={LAYER_LENGTHS} losses={losses} grad_norms={norms} "
          f"step_s={secs} launches_per_step={per_step}", flush=True)
    if not all(np.isfinite(losses + norms)):
        fail("non-finite loss or grad norm while training the layer stack")
    if not losses[-1] < losses[0]:
        fail(f"the layer stack's loss did not fall: {losses}")
    L = cfg.num_hidden_layers
    want = {"layer_norm_fwd": 2 * L, "layer_norm_dx": 2 * L,
            "softmax_fwd": L, "softmax_bwd": L, "bias_gelu_fwd": 0,
            "bias_gelu_bwd": 0, **{n: 0 for n in FLASH}}
    if any(step != want for step in per_step):
        fail(f"launches per step {per_step}, expected {want}")
    step_s = sum(secs[1:]) / 3
    print(f"layer_stack_step_s={step_s} card={card}", flush=True)
    print(f"layer_stack_tokens_per_s={LAYER_MICRO * LAYER_SEQ / step_s} "
          f"card={card}", flush=True)
    print(f"layer_stack_peak_memory_gib={peak_gib} card={card}", flush=True)
    return engine, batch, launches


def phase_layer_profile(torch, engine, batch, card):
    """One warmed step unprofiled (wall), then one under torch.profiler
    (device time by kernel; idle share against the unprofiled wall)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_batch(iter([batch]))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.train_batch(iter([batch]))
        torch.cuda.synchronize()
    rows = [(_device_us(e) / 1e3, e.count, e.key)
            for e in prof.key_averages() if _device_us(e) > 0]
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        fail("the profiler recorded no device time for a layer-stack step")
    print(f"phase23 profile layer-stack step wall_ms={wall_ms} (unprofiled) "
          f"device_busy_ms={busy_ms} idle_share={1 - busy_ms / wall_ms} "
          f"device_kernels={sum(r[1] for r in rows)} card={card}", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:14]:
        print(f"phase23 kernel ms={ms} count={count} {key[:90]}", flush=True)


def phase_layer_unmasked(torch, engine, batch):
    """One forward and backward of the stack without the mask: attention
    takes the flash kernels (B1, B1b), the softmax kernel is not launched."""
    from deepspeed_tpu_torch.ops.cuda import _build
    stack = engine.compute_module
    stack.use_mask = False
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        loss = engine(batch)
        engine.backward(loss)
        torch.cuda.synchronize()
    finally:
        stack.use_mask = True
    L = len(stack.layers)
    got = {n: _build.LAUNCHES[n] for n in ROWWISE + FLASH}
    loss = float(loss.detach())
    print(f"phase23 unmasked forward+backward loss={loss} launches={got}",
          flush=True)
    want = {"layer_norm_fwd": 2 * L, "layer_norm_dx": 2 * L,
            "softmax_fwd": 0, "softmax_bwd": 0, "bias_gelu_fwd": 0,
            "bias_gelu_bwd": 0, **{n: L for n in FLASH}}
    if got != want or not math.isfinite(loss):
        fail(f"the unmasked stack launched {got}, expected {want}")


@contextlib.contextmanager
def plain_rowwise(ln, sm):
    """Route the LayerNorm and softmax autograd functions through their
    plain versions (on the card they are reached only here, for
    comparison)."""
    saved = (ln.layer_norm_forward, ln.layer_norm_dx, sm.softmax_forward,
             sm.softmax_backward)
    ln.layer_norm_forward = ln.layer_norm_forward_reference
    ln.layer_norm_dx = ln.layer_norm_backward_reference
    sm.softmax_forward = sm.softmax_forward_reference
    sm.softmax_backward = sm.softmax_backward_reference
    try:
        yield
    finally:
        (ln.layer_norm_forward, ln.layer_norm_dx, sm.softmax_forward,
         sm.softmax_backward) = saved


def phase_layer_model_check(torch, ln, sm, engine, batch):
    """The trained stack's bf16 weights and the batch through the kernels
    and through the plain versions: loss and global grad norm."""
    import copy
    from deepspeed_tpu_torch.ops.cuda import _build
    result = {}
    for impl in ("kernels", "plain"):
        m = copy.deepcopy(engine.module).to(torch.bfloat16)
        before = sum(_build.LAUNCHES[n] for n in ROWWISE)
        with (plain_rowwise(ln, sm) if impl == "plain"
              else contextlib.nullcontext()):
            loss = l2_loss(m(batch["inputs"]), batch)
            loss.backward()
        launched = sum(_build.LAUNCHES[n] for n in ROWWISE) - before
        if (impl == "plain") != (launched == 0):
            fail(f"the {impl} layer model check launched {launched} kernels")
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.float().norm() for p in m.parameters()]))
        result[impl] = (loss.item(), norm.item())
        del m, loss
        torch.cuda.empty_cache()
    (lk, nk), (lp, np_) = result["kernels"], result["plain"]
    print(f"phase23 layer model check loss kernels={lk} plain={lp} (rtol "
          f"{LAYER_LOSS_RTOL}); grad norm kernels={nk} plain={np_} (rtol "
          f"{LAYER_GRAD_NORM_RTOL})", flush=True)
    if not (abs(lk - lp) <= LAYER_LOSS_RTOL * abs(lp)
            and abs(nk - np_) <= LAYER_GRAD_NORM_RTOL * np_):
        fail("the layer stack through the kernels disagrees with the plain "
             "versions")


# operations per element of each kernel's f32 arithmetic (CUDA cores,
# F32_FLOPS): the statistics, normalise and affine of LayerNorm; the
# derivative's products and row sums; tanh-GELU with its tanh counted as
# 20 operations; softmax's max, exp, sum and divide
ROW_OPS_PER_ELEMENT = {"layer_norm_fwd": 8, "layer_norm_dx": 12,
                       "bias_gelu_fwd": 30, "bias_gelu_bwd": 40,
                       "softmax_fwd": 8, "softmax_bwd": 4}


# input copies a cold timing reads in turn: past the H100's 50 MB L2
COLD_BYTES = 64 * 2 ** 20


def rowwise_time_inputs(torch, ln, sm, dev, gen, dt):
    """The LayerNorm and softmax inputs of phase 22 at the layer's shapes
    (x [8 * 512, 1024] with gamma and beta in x's type; the scores [8 * 16 *
    512, 512], the plain forward's y and a cotangent), keyed as phase 22
    keys them."""
    dtype = getattr(torch, dt)
    n, d = LAYER_MICRO * LAYER_SEQ, LAYER_KW["hidden_size"]
    x = (torch.randn(n, d, device=dev, generator=gen) * 2 + 1).to(dtype)
    g = (1 + 0.3 * torch.randn(d, device=dev, generator=gen)).to(dtype)
    b = (0.3 * torch.randn(d, device=dev, generator=gen)).to(dtype)
    dy = torch.randn(n, d, device=dev, generator=gen).to(dtype)
    _, mean, rstd = ln.layer_norm_forward_reference(x, g, b, 1e-12)
    shape = (LAYER_MICRO * LAYER_KW["heads"] * LAYER_SEQ, LAYER_SEQ)
    xs = (3 * torch.randn(shape, device=dev, generator=gen)).to(dtype)
    dys = torch.randn(shape, device=dev, generator=gen).to(dtype)
    ys = sm.softmax_forward_reference(xs, LAYER_SEQ, False)
    return {("ln", dt): (x, g, b, mean, rstd, dy),
            ("softmax", dt): (xs, ys, dys)}


def _grad_state(torch, fn, *leaves):
    """(fn's output, its leaves) of a fresh graph over leaf copies."""
    leaves = tuple(t.detach().requires_grad_() for t in leaves)
    return fn(*leaves), leaves


def rowwise_time_cases(torch, ln, gl, sm, inputs, dt):
    """The row-wise kernels timed at inputs[(op, dt)]: name -> (args,
    kernel(args), plain(args), library state(args), library(state),
    elements, bytes moved, bytes read). The library call is one PyTorch
    call of the same function (a yardstick the port never calls); a
    backward's state is its autograd graph."""
    import torch.nn.functional as F
    cases = {}
    if ("ln", dt) in inputs:
        x, g, b, mean, rstd, dy = args = inputs[("ln", dt)]
        d, par = x.shape[-1], g.numel() * g.element_size()
        cases["layer_norm_fwd"] = (
            args, lambda a: ln.layer_norm_forward(*a[:3], 1e-12),
            lambda a: ln.layer_norm_forward_reference(*a[:3], 1e-12),
            lambda a: a, lambda a: F.layer_norm(a[0], (d,), a[1], a[2],
                                                1e-12),
            x.numel(), 2 * x.numel() * x.element_size() + 2 * par
            + 8 * x.shape[0], x.numel() * x.element_size() + 2 * par)
        cases["layer_norm_dx"] = (
            args, lambda a: ln.layer_norm_dx(a[0], a[1], a[3], a[4], a[5]),
            lambda a: ln.layer_norm_backward_reference(a[0], a[1], a[3],
                                                       a[4], a[5]),
            lambda a: (*_grad_state(torch, lambda x_, g_, b_: F.layer_norm(
                x_, (d,), g_, b_, 1e-12), *a[:3]), a[5]),
            lambda st: torch.autograd.grad(st[0], st[1], st[2],
                                           retain_graph=True),
            x.numel(), 3 * x.numel() * x.element_size() + par
            + 8 * x.shape[0], 2 * x.numel() * x.element_size() + par)
    if ("gelu", dt) in inputs:
        xg, bg, dyg = args = inputs[("gelu", dt)]
        nb = xg.numel() * xg.element_size()
        bb = bg.numel() * bg.element_size()
        cases["bias_gelu_fwd"] = (
            args, lambda a: gl.bias_gelu_forward(a[0], a[1]),
            lambda a: gl.bias_gelu_forward_reference(a[0], a[1]),
            lambda a: a, lambda a: F.gelu(a[0] + a[1], approximate="tanh"),
            xg.numel(), 2 * nb + bb, nb + bb)
        cases["bias_gelu_bwd"] = (
            args, lambda a: gl.bias_gelu_backward(*a),
            lambda a: gl.bias_gelu_backward_reference(*a),
            lambda a: (*_grad_state(torch, lambda x_, b_: F.gelu(
                x_ + b_, approximate="tanh"), a[0], a[1]), a[2]),
            lambda st: torch.autograd.grad(st[0], st[1], st[2],
                                           retain_graph=True),
            xg.numel(), 3 * nb + bb, 2 * nb + bb)
    if ("softmax", dt) in inputs:
        xs, ys, dys = args = inputs[("softmax", dt)]
        nb = xs.numel() * xs.element_size()
        cases["softmax_fwd"] = (
            args, lambda a: sm.softmax_forward(a[0], LAYER_SEQ, False),
            lambda a: sm.softmax_forward_reference(a[0], LAYER_SEQ, False),
            lambda a: a, lambda a: torch.softmax(a[0], -1),
            xs.numel(), 2 * nb, nb)
        cases["softmax_bwd"] = (
            args, lambda a: sm.softmax_backward(a[1], a[2]),
            lambda a: sm.softmax_backward_reference(a[1], a[2]),
            lambda a: (*_grad_state(torch, lambda x_: torch.softmax(x_, -1),
                                    a[0]), a[2]),
            lambda st: torch.autograd.grad(st[0], st[1], st[2],
                                           retain_graph=True),
            xs.numel(), 3 * nb, 2 * nb)
    return cases


def time_row_case(torch, name, case, cold):
    """(kernel ms, library ms) of one case: warm (the same inputs each
    call, as the layer stack's working set may sit in L2) or cold (input
    copies of at least COLD_BYTES together, read in turn)."""
    args, kernel, _, state, library, _, _, in_bytes = case
    copies = [args]
    if cold:
        copies = [tuple(t.clone() for t in args)
                  for _ in range(max(2, math.ceil(COLD_BYTES / in_bytes)))]
    states = [state(c) for c in copies]
    ms = device_ms(lambda i: kernel(copies[i]), len(copies),
                   kernel=name + "_")
    lib_ms = device_ms(lambda i: library(states[i]), len(copies))
    del copies, states
    torch.cuda.empty_cache()
    return ms, lib_ms


def phase_rowwise_timing(torch, ln, gl, sm, inputs, card):
    """Device ms of the six row-wise kernels at the layer's shapes (bf16;
    softmax also f32, the dtype of the layer's logits) beside their plain
    versions, one PyTorch library call each (a yardstick the port never
    calls) and their bounds; warm (the same inputs each call, the kernels
    line's numbers) and cold (input copies past L2, read in turn).
    Returns the kernels-line numbers: LayerNorm and GELU at bf16, softmax
    at f32."""
    out = {}
    for dt in ("bfloat16", "float32"):
        for name, case in rowwise_time_cases(torch, ln, gl, sm, inputs,
                                             dt).items():
            if dt == "float32" and not name.startswith("softmax"):
                continue
            args, _, plain, _, _, n_el, nbytes, _ = case
            tb = nbytes / HBM_BYTES_PER_S
            tf = ROW_OPS_PER_ELEMENT[name] * n_el / F32_FLOPS
            ms, lib_ms = time_row_case(torch, name, case, cold=False)
            cold_ms, lib_cold_ms = time_row_case(torch, name, case,
                                                 cold=True)
            t = {"ms": ms, "plain_ms": device_ms(lambda i: plain(args),
                                                 iters=10),
                 "library_ms": lib_ms, "bound_ms": 1e3 * max(tb, tf),
                 "bound_by": "bytes" if tb >= tf else "operations"}
            for key, val in {**t, "cold_ms": cold_ms,
                             "library_cold_ms": lib_cold_ms}.items():
                print(f"{name}_{dt}_{key}={val} card={card}", flush=True)
            print(f"phase24 {name} {dt}: warm {t['ms'] / t['bound_ms']} x "
                  f"its bound, {t['ms'] / t['library_ms']} x the library "
                  f"call; cold {cold_ms / t['bound_ms']} x its bound, "
                  f"{cold_ms / lib_cold_ms} x the library call", flush=True)
            if (dt == "float32") == name.startswith("softmax"):
                out[name] = t
    print("phase24 library calls (yardsticks, never called by the port): "
          "F.layer_norm and its autograd backward (dx, dgamma and dbeta "
          "together); F.gelu(x + b, approximate='tanh') (two kernels: the "
          "add, then the GELU) and its autograd backward (dx and dbias); "
          "torch.softmax and its autograd backward; cold: input copies of "
          f"at least {COLD_BYTES} bytes read in turn", flush=True)
    return out


def _cuobjdump():
    import glob
    import shutil
    return (shutil.which("cuobjdump")
            or next(iter(glob.glob("/usr/local/cuda/bin/cuobjdump")), None))


def row_registers(_build, names=("layer_norm_fwd", "softmax_fwd")):
    """{kernel: (registers a thread, local bytes)} of the kernels whose
    names hold one of ``names`` (default: the LayerNorm and softmax
    forwards) in the built library (cuobjdump --dump-resource-usage; local
    bytes count the stack frame, where spills go, and local memory), names
    demangled where c++filt is on PATH; None without cuobjdump."""
    import glob
    import re
    import shutil
    tool = _cuobjdump()
    if tool is None:
        return None
    lib = glob.glob(os.path.join(_build.BUILD_DIR, "*.so"))[0]
    usage = subprocess.run([tool, "--dump-resource-usage", lib],
                           capture_output=True, text=True, check=True,
                           timeout=300).stdout
    found = {}
    for m in re.finditer(r"Function (\S+):\s*([^\n]*)", usage):
        if any(n in m.group(1) for n in names):
            field = {k: int(v) for k, v in
                     re.findall(r"(REG|STACK|LOCAL):(\d+)", m.group(2))}
            found[m.group(1)] = (field["REG"], field.get("STACK", 0)
                                 + field.get("LOCAL", 0))
    if shutil.which("c++filt") and found:
        names = subprocess.run(["c++filt"], input="\n".join(found),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.split("\n")
        found = dict(zip(names, found.values()))
    return found


def phase_row_registers(_build):
    """Registers a thread (and spilled local bytes) of each LayerNorm and
    softmax forward kernel, and the warps an SM those registers allow
    (65536 registers, allocated 256 a warp, at most 64 warps)."""
    regs = row_registers(_build)
    if regs is None:
        print("phase1 row-wise registers: no cuobjdump, not measured",
              flush=True)
        return
    if not regs:
        fail("no LayerNorm or softmax forward kernel in the resource usage")
    short = {}
    for name, (reg, local) in sorted(regs.items()):
        per_warp = -(-reg * 32 // 256) * 256
        warps = min(64, 65536 // max(per_warp, 1))
        name = name.split("(anonymous namespace)::")[-1].split("(")[0]
        short[name.replace("__nv_bfloat16", "bf16")] = [reg, local, warps]
    print("phase1 row-wise forward kernels [registers a thread, local "
          f"bytes, warps an SM those registers allow]: {json.dumps(short)}",
          flush=True)


def phase_sparse_registers(_build):
    """Registers a thread and local bytes (stack and local memory) of each
    16-bit sparse backward kernel (B5b); fails on any local memory."""
    regs = row_registers(_build, ("sparse_bwd_dq_wgmma",
                                  "sparse_bwd_dkv_wgmma"))
    if regs is None:
        print("phase1 sparse backward registers: no cuobjdump, not "
              "measured", flush=True)
        return
    if len(regs) != 32:
        fail(f"expected 32 sparse backward wgmma kernels, found {len(regs)}")
    spilled = {n: r for n, r in regs.items() if r[1] > 0}
    if spilled:
        fail(f"sparse backward kernels with local memory: {spilled}")
    print(f"phase1 sparse backward wgmma kernels: {len(regs)}, registers a "
          f"thread {sorted({r[0] for r in regs.values()})} (the launch's; "
          "setmaxnreg moves them to 224 / 56), no local memory", flush=True)


def phase_sass(_build):
    """From the built library's SASS (cuobjdump, the toolkit's or on PATH):
    the HGMMA (wgmma) instructions of each 16-bit flash kernel, and the
    bulk-copy instructions (UBLKCP for cp.async.bulk, UTMALDG for a
    tensor-map load) of each decode kernel. Fails if one has none."""
    import glob
    import re
    tool = _cuobjdump()
    if tool is None:
        print("phase1 SASS: no cuobjdump, HGMMA and UTMALDG counts not "
              "measured", flush=True)
        return
    lib = glob.glob(os.path.join(_build.BUILD_DIR, "*.so"))[0]
    sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    flash, decode, name = {}, {}, None
    sparse = {}          # name: [HGMMA, UTMALDG, HMMA]
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            if "flash" in name and "wgmma" in name:
                flash[name] = 0
            elif "decode_attention_kernel" in name:
                decode[name] = 0
            elif "sparse_bwd_d" in name and "wgmma" in name:
                sparse[name] = [0, 0, 0]
        elif name in flash and "HGMMA" in line:
            flash[name] += 1
        elif name in decode and ("UBLKCP" in line or "UTMALDG" in line):
            decode[name] += 1
        elif name in sparse:
            for i, insn in enumerate((r"\bHGMMA", r"\bUTMALDG",
                                      r"\bHMMA\b")):
                sparse[name][i] += bool(re.search(insn, line))
    for what, counts, insn in (("16-bit flash", flash, "HGMMA"),
                               ("decode", decode, "UTMALDG")):
        if not counts or min(counts.values()) == 0:
            fail(f"{what} kernels without {insn} in the SASS: {counts}")
        print(f"phase1 {what} SASS: {len(counts)} kernels, "
              f"{sum(counts.values())} {insn} instructions "
              f"({min(counts.values())}-{max(counts.values())} each)",
              flush=True)
    if (len(sparse) != 32 or any(h == 0 or u == 0 or mma
                                 for h, u, mma in sparse.values())):
        fail("the 16-bit sparse backward kernels want HGMMA and UTMALDG and "
             f"no HMMA each: {sparse}")
    print(f"phase1 16-bit sparse backward SASS: {len(sparse)} kernels, "
          f"{sum(c[0] for c in sparse.values())} HGMMA and "
          f"{sum(c[1] for c in sparse.values())} UTMALDG instructions, "
          "no HMMA", flush=True)


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
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import gelu as gl
    from deepspeed_tpu_torch.ops.cuda import layer_norm as ln
    from deepspeed_tpu_torch.ops.cuda import sampling as sp
    from deepspeed_tpu_torch.ops.cuda import softmax as sm
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    from deepspeed_tpu_torch.ops import quantizer as qz

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    print(f"phase1 kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_sass(_build)
    phase_row_registers(_build)
    phase_sparse_registers(_build)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    da_err, decode_inputs = phase_decode_attention(torch, da, dev, gen)
    logits, sp_err = phase_sampling(torch, sp, dev, gen)
    flash_err, flash_inputs = phase_flash_parity(torch, fa, dev, gen)
    launches = phase_serving(torch, np, dev, args.seed, card)
    (da_t, da_bound, da_by), (sp_t, sp_bound, sp_by) = phase_timing(
        torch, da, qz, sp, dev, gen, decode_inputs, logits, card)
    engine, cfg, ids, launches_train = phase_training(torch, np, dev,
                                                      args.seed, card)
    phase_model_check(torch, dev, engine, cfg, ids)
    phase_train_profile(torch, engine, ids, card)
    del engine
    flash_t = phase_flash_timing(torch, fa, dev, gen, flash_inputs, card)
    del flash_inputs
    torch.cuda.empty_cache()

    sparse_err, sparse_inputs = phase_sparse_parity(torch, sa, dev, gen)
    engine, cfg, ids, launches_long = phase_long_training(torch, np, dev,
                                                          args.seed, card)
    phase_long_model_check(torch, sa, dev, engine, cfg, ids)
    phase_long_profile(torch, engine, ids, card)
    del engine
    torch.cuda.empty_cache()
    sparse_t = phase_sparse_timing(torch, sa, dev, gen, sparse_inputs, card)
    del sparse_inputs
    torch.cuda.empty_cache()
    phase_sparse_bert(torch, np, sa, dev, gen, args.seed)
    torch.cuda.empty_cache()

    paged_err = phase_paged_parity(torch, da, qz, dev, gen)
    launches_paged, ie, prompts, bf16_tokens = phase_paged_serving(
        torch, np, dev, args.seed, card)
    launches_int8 = phase_int8_serving(torch, np, dev, ie, prompts,
                                       bf16_tokens, card)
    del ie
    torch.cuda.empty_cache()
    paged_t = phase_paged_timing(torch, da, qz, dev, gen, decode_inputs,
                                 card)
    del decode_inputs
    torch.cuda.empty_cache()

    row_err, row_inputs = phase_rowwise_parity(torch, ln, gl, sm, dev, gen)
    launches_gelu = phase_gelu_entry(torch, dev, gen)
    torch.cuda.empty_cache()
    engine, batch, launches_layer = phase_layer_training(torch, np, dev, gen,
                                                         card)
    phase_layer_profile(torch, engine, batch, card)
    phase_layer_unmasked(torch, engine, batch)
    phase_layer_model_check(torch, ln, sm, engine, batch)
    del engine, batch
    torch.cuda.empty_cache()
    row_t = phase_rowwise_timing(torch, ln, gl, sm, row_inputs, card)

    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/decode_attention.cuh",
         "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:74",
         "launches": launches["decode_attention"], "max_abs_err": da_err,
         **da_t, "bound_ms": da_bound, "bound_by": da_by},
        {"name": "sampling", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/sampling.cu",
         "replaces": "deepspeed_tpu/ops/pallas/sampling.py:132",
         "launches": launches["sampling"], "max_abs_err": sp_err,
         **sp_t, "bound_ms": sp_bound, "bound_by": sp_by},
    ] + [
        {"name": name, "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/flash_attention.cu",
         "replaces": replaces, "launches": launches_train[name],
         "max_abs_err": flash_err[name], **flash_t[name]}
        for name, replaces in (
            ("flash_fwd", "deepspeed_tpu/ops/pallas/flash_attention.py:52"),
            ("flash_bwd_dq",
             "deepspeed_tpu/ops/pallas/flash_attention.py:140"),
            ("flash_bwd_dkv",
             "deepspeed_tpu/ops/pallas/flash_attention.py:175"))
    ] + [
        {"name": name, "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/sparse_attention.cu",
         "replaces": "deepspeed_tpu/ops/sparse_attention/"
                     f"sparse_self_attention.py:{line}",
         "launches": launches_long[name], "max_abs_err": sparse_err[name],
         **sparse_t[name]}
        for name, line in (("sparse_fwd", 72), ("sparse_bwd_dq", 122),
                           ("sparse_bwd_dkv", 166))
    ] + [
        {"name": name, "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/decode_attention.cuh",
         "replaces": f"deepspeed_tpu/ops/pallas/decode_attention.py:{line}",
         "launches": launches, "max_abs_err": paged_err[name],
         **paged_t[name]}
        for name, line, launches in (
            ("paged_decode_attention", 351,
             launches_paged["paged_decode_attention"]),
            ("decode_attention_int8", 74,
             launches_int8["decode_attention_int8"]),
            ("paged_decode_attention_int8", 351,
             launches_int8["paged_decode_attention_int8"]))
    ] + [
        {"name": name, "route": "cuda",
         "source": f"deepspeed_tpu_torch/ops/cuda/csrc/{source}",
         "replaces": f"deepspeed_tpu/ops/pallas/{replaces}",
         "launches": (launches_gelu if name.startswith("bias_gelu")
                      else launches_layer)[name],
         "max_abs_err": row_err[name], **row_t[name]}
        for name, source, replaces in (
            ("layer_norm_fwd", "layer_norm.cu", "layer_norm.py:22"),
            ("layer_norm_dx", "layer_norm.cu", "layer_norm.py:34"),
            ("bias_gelu_fwd", "gelu.cu", "gelu.py:34"),
            ("bias_gelu_bwd", "gelu.cu", "gelu.py:39"),
            ("softmax_fwd", "softmax.cu", "softmax.py:23"),
            ("softmax_bwd", "softmax.cu", "softmax.py:38"))
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
