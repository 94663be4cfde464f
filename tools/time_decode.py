#!/usr/bin/env python3
"""Time the decode attention kernels (B2, B3 and their int8 branches) of a
checkout of this repository on one NVIDIA GPU.

    python3 tools/time_decode.py [--root DIR] [--build-only]

``--root`` names the checkout timed, ``--build-only`` only builds it
(``tools/_checkout.py``).
At GPT-2 125M decode geometry (b 8, S 1024, h 12, d 64, bf16, paged block
16) it prints one JSON line per case: chip_smoke.py phase 2's mixed fills
(and the retired-lane sentinel row) with s_q 1, the same with s_q 4, and
every row at fill 1024 with s_q 1. Each line holds the device ms per call
of the four kernels (chip_smoke.py's ``device_ms``: kernels whose name
holds "decode_attention_kernel", 8 cache copies read in turn so each call
reads cold) and the host time to issue one B2 and one B3 call (until it
returns, 100 calls in a row). The card's name and power limit come first.
"""

from __future__ import annotations

import json
import sys

from _checkout import open_checkout


def main(argv=None) -> int:
    _, root, da, build_s = open_checkout(
        "time_decode", __doc__, argv, "ops.cuda.decode_attention")
    import torch
    from chip_smoke import (DECODE_TIME_CASES, _issue_us, card_line,
                            decode_case_inputs, decode_copies, device_ms)
    from deepspeed_tpu_torch.ops import quantizer as qz
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
