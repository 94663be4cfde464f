#!/usr/bin/env python3
"""Time the dense training step of a checkout of this repository on one
NVIDIA GPU.

    python3 tools/time_train.py [--root DIR] [--build-only]

``--root`` names the checkout timed, ``--build-only`` only builds it
(``tools/_checkout.py``). It runs this checkout's ``chip_smoke.py``
phase 8 over that checkout's package: ``bench.py``'s ``gpt2_125m_zero1``
configuration (GPT-2 125M, seq 1024, bf16, micro 8 x gas 16, ZeRO-1) for
2 warm-up and 3 timed steps, printing its losses, step seconds and MFU
beside the card's name and power limit.
"""

from __future__ import annotations

import sys

from _checkout import open_checkout


def main(argv=None) -> int:
    _, root, _, _ = open_checkout("time_train", __doc__, argv,
                                  "runtime.engine")
    import numpy as np
    import torch
    import chip_smoke
    card = chip_smoke.card_line()
    print(f"root={root} card={card}", flush=True)
    chip_smoke.phase_training(torch, np, torch.device("cuda", 0), 0, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
