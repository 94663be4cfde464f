#!/usr/bin/env python3
"""Time the decode attention kernels (B2, B3 and their int8 branches) of a
checkout of this repository on one NVIDIA GPU.

    python3 tools/time_decode.py [--root DIR] [--build-only]

``--root`` names the checkout whose ``deepspeed_tpu_torch`` is imported
(default: the one holding this script), so two commits compare in one run
on one card: unpack the other into a directory and time both in turns.
At GPT-2 125M decode geometry (b 8, S 1024, h 12, d 64, bf16, paged block
16) it prints one JSON line per case: chip_smoke.py phase 2's mixed fills
(and the retired-lane sentinel row) with s_q 1, the same with s_q 4, and
every row at fill 1024 with s_q 1. Each line holds the device ms per call
of the four kernels (chip_smoke.py's ``device_ms``: kernels whose name
holds "decode_attention_kernel", 8 cache copies read in turn so each call
reads cold) and the host time to issue one B2 and one B3 call (until it
returns, 100 calls in a row). The card's name and power limit come first.
``--build-only`` builds the checkout's kernels and exits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_decode: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import (DECODE_TIME_CASES, _issue_us,   # this checkout's
                            card_line, decode_case_inputs, decode_copies,
                            device_ms)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from deepspeed_tpu_torch.ops import quantizer as qz
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    if not os.path.abspath(da.__file__).startswith(root):
        raise RuntimeError(f"imported {da.__file__}, not from {root}")
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
    for case, (s_q, full) in DECODE_TIME_CASES.items():
        inputs = decode_case_inputs(torch, dev, gen, s_q, full)
        copies, _, calls = decode_copies(torch, da, qz, dev, gen, inputs)
        row = {"root": root, "case": case, "s_q": s_q,
               "fills": inputs[3].tolist(), "build_s": build_s}
        for name, call in calls.items():
            row[f"{name}_ms"] = device_ms(lambda i: call(copies[i]), 8,
                                          "decode_attention_kernel")
        for name in ("decode_attention", "paged_decode_attention"):
            row[f"{name}_issue_us"] = _issue_us(
                torch, lambda: calls[name](copies[0]))
        print(json.dumps({**row, "card": card}), flush=True)
        del inputs, copies, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
