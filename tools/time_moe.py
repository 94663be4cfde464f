#!/usr/bin/env python3
"""Serve and train GPT-MoE through a checkout of this repository on one
NVIDIA GPU, and run it over two expert-parallel ranks.

    python3 tools/time_moe.py [--root DIR] [--build-only] [--seed N]

``--root`` names the checkout run, ``--build-only`` only builds it
(``tools/_checkout.py``). It runs this checkout's ``chip_smoke.py`` phases
42 (gpt_moe_1_3b with 16 experts at full width, cut in depth, bf16, served
dense and fused through B1 / B2 / B4 with every call held to its plain
version, one layer's MoE against f32, the routing's capacity and drops, a
decode step's device time split, and B1 / B2 / B4 at its shapes timed),
43 (its width cut to 2 layers, trained) and 44 (ep 2 over two gloo ranks
against ep 1) over that checkout's package, on phase 4's 16 requests,
printing their numbers beside the card's name and power limit. Phase 44's
ranks run this checkout's package.
"""

from __future__ import annotations

import sys

from _checkout import open_checkout


def main(argv=None) -> int:
    args, root, _, build_s = open_checkout(
        "time_moe", __doc__, argv, "moe.layer", values=("--seed",))
    import numpy as np
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"root={root} build_s={build_s} card={card}", flush=True)
    seed = int(args.seed or 0)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)         # phase 4's requests
    prompts = [rng.integers(1, 50304, int(n)).astype(np.int32)
               for n in rng.integers(16, 129, 16)]
    kw = dict(max_batch=8, decode_chunk=8, max_prompt_len=128)
    cs.phase_moe_serving(torch, np, dev, seed, prompts, kw, card)
    cs.phase_moe_training(torch, np, dev, seed, card)
    cs.phase_ep(torch, np, dev, seed, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
