#!/usr/bin/env python3
"""Serve and train GPT-NeoX 20B at tensor-parallel degree 2 through a
checkout of this repository on one NVIDIA GPU.

    python3 tools/time_tp.py [--root DIR] [--build-only] [--seed N]
                             [--phases 45,46]

``--root`` names the checkout run, ``--build-only`` only builds it
(``tools/_checkout.py``). It runs this checkout's ``chip_smoke.py`` phases
45 (gpt_neox_20b at full width, cut to chip_smoke's NEOX_LAYERS layers,
bf16, split over two gloo ranks
sharing the card: its forward through B1, layer 0 and the width cut to 2
layers against tp 1, phase 4's requests served dense, paged, under
tp_overlap and fused with every B1 / B2 / B3 call and B4 draw held to its
plain version, int8 weights at the cut depth, and B1 / B1b, B2 / B3 and
B4 at its rank's shapes timed) and 46 (its width cut to 2 layers, trained
at tp 1 and tp 2, with and without partition_activations) over that
checkout's package, printing their numbers beside the card's name and
power limit (``--phases`` picks 45, 46 or both). The ranks run this
checkout's package.
"""

from __future__ import annotations

import sys

from _checkout import open_checkout


def main(argv=None) -> int:
    args, root, _, build_s = open_checkout(
        "time_tp", __doc__, argv, "module_inject.layers",
        values=("--seed", "--phases"))
    import numpy as np
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"root={root} build_s={build_s} card={card}", flush=True)
    seed = int(args.seed or 0)
    dev = torch.device("cuda", 0)
    torch.cuda.init()                  # the memory stats need a context
    phases = {int(p) for p in (args.phases or "45,46").split(",")}
    if 45 in phases:
        cs.phase_tp_serving(torch, np, dev, seed, card)
    if 46 in phases:
        cs.phase_tp_training(torch, np, dev, seed, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
