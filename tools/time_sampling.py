#!/usr/bin/env python3
"""Time the sampling kernel (B4) of a checkout of this repository on one
NVIDIA GPU.

    python3 tools/time_sampling.py [--root DIR] [--build-only]

``--root`` names the checkout timed, ``--build-only`` only builds it
(``tools/_checkout.py``).
Prints the card's name and power limit, then one JSON line per case of
chip_smoke.py's ``SAMPLING_TIME_CASES`` (this checkout's): greedy, the
filters (top_k 50 + top_p 0.9, top-p 0.9 alone, top-k 50 alone) and the
sampled draw at b 8, V 50304, the filters at b 64, V 131072, and the launch
floor (b 1, V 128, greedy); each with the kernel's device ms per call
(chip_smoke.py's ``device_ms``), its byte bound and its PyTorch yardstick.
"""

from __future__ import annotations

import json
import sys

from _checkout import open_checkout


def main(argv=None) -> int:
    _, root, sp, build_s = open_checkout(
        "time_sampling", __doc__, argv, "ops.cuda.sampling")
    import torch
    from chip_smoke import card_line, sampling_time_cases
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
