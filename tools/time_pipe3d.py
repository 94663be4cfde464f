#!/usr/bin/env python3
"""Run the 3D-parallel pipeline, the ZeRO-3 tile gather and the block-sparse
MatMul phases of chip_smoke.py alone, through a checkout of this repository
on one NVIDIA GPU.

    python3 tools/time_pipe3d.py [--root DIR] [--build-only] [--seed N]
                                 [--phases 54,55,56,57]

``--root`` names the checkout run, ``--build-only`` only builds it
(``tools/_checkout.py``). Phases 54-55 (run together): GPT-2 1.3B's width
cut to ``chip_smoke.PIPE3D_LAYERS`` layers, the dense engine here, then four
gloo ranks sharing the card train it at pp 2 x tp 2 and pp 2 x sp 2
(Ulysses, ring) with every gate, and B1 / B1b at the new stage shapes
against their plain versions, timed beside SDPA. Phase 56: two ranks run
ZeRO-3 over a ``TiledLinear(2048, 8192, 2, 4)`` gathered a tile at a time
against the whole gather. Phase 57: the block-sparse ``MatMul`` at seq 8192
against the dense masked product. Each group prints ``phase_wall``.
"""

from __future__ import annotations

import sys
import time

from _checkout import open_checkout


def main(argv=None) -> int:
    args, root, fa, build_s = open_checkout(
        "time_pipe3d", __doc__, argv, "ops.cuda.flash_attention",
        values=("--seed", "--phases"))
    import numpy as np
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"root={root} build_s={build_s} card={card}", flush=True)
    seed = int(args.seed or 0)
    phases = set((args.phases or "54,55,56,57").split(","))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if phases & {"54", "55"}:
        t0 = time.perf_counter()
        cs.phase_pipe3d(torch, np, fa, dev, gen, seed, card)
        print(f"phase_wall 54-55 seconds={time.perf_counter() - t0}",
              flush=True)
    if "56" in phases:
        t0 = time.perf_counter()
        cs.phase_tiles(card, cs.run_dp_ranks(seed, (), 56, onebit="56"))
        print(f"phase_wall 56 seconds={time.perf_counter() - t0}", flush=True)
    if "57" in phases:
        t0 = time.perf_counter()
        cs.phase_sparse_matmul(torch, np, dev, gen, card)
        print(f"phase_wall 57 seconds={time.perf_counter() - t0}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
