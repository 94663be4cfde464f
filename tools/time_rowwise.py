#!/usr/bin/env python3
"""Time the LayerNorm (B6) and softmax (B8) kernels of a checkout of this
repository on one NVIDIA GPU.

    python3 tools/time_rowwise.py [--root DIR] [--build-only]

``--root`` names the checkout timed, ``--build-only`` only builds it
(``tools/_checkout.py``).
At the shapes of the layer stack (chip_smoke.py phases 22-24: BERT-large
width, micro 8 x seq 512) it times the LayerNorm forward and dx at
[4096, 1024] bf16 and the softmax forward and backward at [8 * 16 * 512,
512] f32 (the layer's logits) and bf16, each beside its PyTorch call
(F.layer_norm, torch.softmax and their autograd backwards), and prints
one JSON line per case: device ms per call (chip_smoke.py's
``device_ms``) warm, the same inputs each call, and cold, input copies of
at least 64 MiB read in turn so each call reads past the 50 MB L2. The
card's name and power limit come first. Then it trains chip_smoke.py
phase 23's 24-layer stack through the checkout's kernels (1 warm-up + 3
timed steps, launch counts checked) and profiles one warmed step (device
busy ms and idle share).
"""

from __future__ import annotations

import json
import sys

from _checkout import open_checkout

CASES = (("bfloat16", ("layer_norm_fwd", "layer_norm_dx", "softmax_fwd",
                       "softmax_bwd")),
         ("float32", ("softmax_fwd", "softmax_bwd")))


def main(argv=None) -> int:
    _, root, ln, build_s = open_checkout(
        "time_rowwise", __doc__, argv, "ops.cuda.layer_norm")
    import numpy as np
    import torch
    from chip_smoke import (card_line, phase_layer_profile,
                            phase_layer_training, rowwise_time_cases,
                            rowwise_time_inputs, time_row_case)
    from deepspeed_tpu_torch.ops.cuda import softmax as sm
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dt, names in CASES:
        inputs = rowwise_time_inputs(torch, ln, sm, dev, gen, dt)
        cases = rowwise_time_cases(torch, ln, None, sm, inputs, dt)
        for name in names:
            case = cases[name]
            row = {"root": root, "case": name, "dtype": dt,
                   "shape": list(case[0][0].shape), "build_s": build_s}
            for regime in ("warm", "cold"):
                ms, lib_ms = time_row_case(torch, name, case,
                                           cold=regime == "cold")
                row[f"{regime}_ms"] = ms
                row[f"library_{regime}_ms"] = lib_ms
            print(json.dumps({**row, "card": card}), flush=True)
        del inputs, cases
        torch.cuda.empty_cache()
    print(f"layer stack through the kernels of {root}", flush=True)
    engine, batch, _ = phase_layer_training(torch, np, dev, gen, card)
    phase_layer_profile(torch, engine, batch, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
