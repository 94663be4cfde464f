#!/usr/bin/env python3
"""Time the block-sparse attention kernels of a checkout of this repository
on one NVIDIA GPU.

    python3 tools/time_sparse.py [--root DIR] [--build-only] [--no-step]

``--root`` names the checkout whose ``deepspeed_tpu_torch`` is imported
(default: the one holding this script), so two commits compare in one run
on one card: unpack the other into a directory and time both in turns.
At ``bench.py``'s long-context training shape (B=1, S=32768, H=12, D=64,
bf16, causal, BigBird block 64: chip_smoke.py phases 12 and 16) it prints
one JSON line: the device ms per call of the forward (B5), dq and dk/dv
(B5b) kernels (chip_smoke.py's ``device_ms``), of ``attention_delta``
(the rowsum(dO * out) that each backward call computes first) and the
host time to issue one backward call (100 calls in a row). A second line
does the same in fp16 at D=128. Then it trains chip_smoke.py phase 13's
model (GPT-2 125M at seq 32768 through the sparse kernels) for 1 warm-up
and 3 timed steps and profiles one warmed step: step wall, device busy
ms, idle share. The card's name and power limit come first.
``--build-only`` builds the checkout's kernels and exits; ``--no-step``
skips the training step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (dtype, D) of the two lines: the training shape, then fp16 at D = 128
CASES = (("bfloat16", 64), ("float16", 128))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--no-step", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_sparse: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import (LONG_SEQ, _issue_us,  # this checkout's
                            _layout, bench_sparsity, card_line, device_ms,
                            phase_long_profile, phase_long_training)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    from deepspeed_tpu_torch.ops.cuda.flash_attention import attention_delta
    if not os.path.abspath(sa.__file__).startswith(root):
        raise RuntimeError(f"imported {sa.__file__}, not from {root}")
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    if args.build_only:
        print(json.dumps({"root": root, "build_s": build_s}), flush=True)
        return 0
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, H = 1, LONG_SEQ, 12
    layout = _layout(bench_sparsity(H), S, True, dev)
    for dtype_name, D in CASES:
        dtype = getattr(torch, dtype_name)
        qkv = torch.randn(B, S, 3 * H * D, device=dev, generator=gen).to(dtype)
        q, k, v = (t.view(B, S, H, D) for t in qkv.split(H * D, -1))
        do = torch.randn(B, S, H, D, device=dev, generator=gen).to(dtype)
        scale = D ** -0.5
        out, lse = sa.sparse_attention_forward(q, k, v, layout, scale)

        def fwd(i=0):
            sa.sparse_attention_forward(q, k, v, layout, scale)

        def bwd(i=0):
            sa.sparse_attention_backward(q, k, v, out, lse, do, layout, scale)

        print(json.dumps({
            "root": root, "B": B, "S": S, "H": H, "D": D,
            "dtype": dtype_name, "causal": True, "layout": "BigBird block 64",
            "build_s": build_s,
            "sparse_fwd_ms": device_ms(fwd, kernel="sparse_fwd", iters=20),
            "sparse_bwd_dq_ms": device_ms(bwd, kernel="sparse_bwd_dq",
                                          iters=20),
            "sparse_bwd_dkv_ms": device_ms(bwd, kernel="sparse_bwd_dkv",
                                           iters=20),
            "attention_delta_ms": device_ms(
                lambda i: attention_delta(out, do), iters=20),
            "bwd_issue_us": _issue_us(torch, bwd), "card": card}),
            flush=True)
        del qkv, q, k, v, do, out, lse
        torch.cuda.empty_cache()
    if not args.no_step:
        engine, _, ids, _ = phase_long_training(torch, np, dev, 0, card)
        prof = phase_long_profile(torch, engine, ids, card)
        print(json.dumps({"root": root, "long_context_step": prof,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
