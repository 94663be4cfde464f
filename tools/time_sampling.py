#!/usr/bin/env python3
"""Time the sampling kernel (B4) of a checkout of this repository on one
NVIDIA GPU.

    python3 tools/time_sampling.py [--root DIR] [--build-only]

``--root`` names the checkout whose ``deepspeed_tpu_torch`` is imported
(default: the one holding this script), so two commits compare in one run
on one card: unpack the other into a directory and time both in turns.
Prints the card's name and power limit, then one JSON line per case of
chip_smoke.py's ``SAMPLING_TIME_CASES`` (this checkout's): greedy, the
filters (top_k 50 + top_p 0.9, top-p 0.9 alone, top-k 50 alone) and the
sampled draw at b 8, V 50304, the filters at b 64, V 131072, and the launch
floor (b 1, V 128, greedy); each with the kernel's device ms per call
(chip_smoke.py's ``device_ms``), its byte bound and its PyTorch yardstick.
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
        print("time_sampling: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import card_line, sampling_time_cases  # this checkout's
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import sampling as sp
    if not os.path.abspath(sp.__file__).startswith(root):
        raise RuntimeError(f"imported {sp.__file__}, not from {root}")
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
    for case, row in sampling_time_cases(torch, sp, dev, gen).items():
        print(json.dumps({"root": root, "case": case, **row,
                          "build_s": build_s, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
