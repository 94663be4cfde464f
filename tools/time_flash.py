#!/usr/bin/env python3
"""Time the flash attention kernels of a checkout of this repository on one
NVIDIA GPU.

    python3 tools/time_flash.py [--root DIR] [--build-only]

``--root`` names the checkout timed, ``--build-only`` only builds it
(``tools/_checkout.py``).
For each shape (the ``gpt2_125m_zero1`` training shape B=8, S=1024, H=12,
D=64 causal; the transformer layer's unmasked shape B=8, S=512, H=16,
D=64), bf16, it prints one JSON line: the device ms per call of the three
kernels and the host time to issue one forward and one backward call
(until the call returns, 100 calls in a row), with chip_smoke.py's
timing functions. The card's name and power limit come first.
"""

from __future__ import annotations

import json
import sys

from _checkout import open_checkout

SHAPES = {"train": (8, 1024, 12, 64, True), "layer": (8, 512, 16, 64, False)}


def main(argv=None) -> int:
    _, root, fa, build_s = open_checkout(
        "time_flash", __doc__, argv, "ops.cuda.flash_attention")
    import torch
    from chip_smoke import _issue_us, card_line, device_ms
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, (B, S, H, D, causal) in SHAPES.items():
        qkv = torch.randn(B, S, 3 * H * D, device=dev,
                          generator=gen).bfloat16()
        q, k, v = (t.view(B, S, H, D) for t in qkv.split(H * D, -1))
        do = torch.randn(B, S, H, D, device=dev, generator=gen).bfloat16()
        scale = D ** -0.5
        out, lse = fa.flash_attention_forward(q, k, v, causal, scale)

        def fwd(i=0):
            fa.flash_attention_forward(q, k, v, causal, scale)

        def bwd(i=0):
            fa.flash_attention_backward(q, k, v, out, lse, do, causal, scale)

        print(json.dumps({
            "root": root, "shape": tag, "B": B, "S": S, "H": H, "D": D,
            "causal": causal, "build_s": build_s,
            "flash_fwd_ms": device_ms(fwd, kernel="flash_fwd"),
            "flash_bwd_dq_ms": device_ms(bwd, kernel="flash_bwd_dq"),
            "flash_bwd_dkv_ms": device_ms(bwd, kernel="flash_bwd_dkv"),
            "fwd_issue_us": _issue_us(torch, fwd),
            "bwd_issue_us": _issue_us(torch, bwd), "card": card}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
