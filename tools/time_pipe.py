#!/usr/bin/env python3
"""Run the pipeline phases and sweep the micro-batch count through a checkout
of this repository on one NVIDIA GPU.

    python3 tools/time_pipe.py [--root DIR] [--build-only] [--seed N]
                               [--phases 50,51] [--sweep 1,2,4,8]

``--root`` names the checkout run, ``--build-only`` only builds it
(``tools/_checkout.py``). ``--phases`` runs ``chip_smoke.py``'s phases 50-51
(GPT-2 1.3B at full width and depth: the dense engine here, then the 1F1B
``PipelineEngine`` and ``GPipeSpmdEngine`` at pp 2 over two gloo ranks
sharing the card, with every gate; B1 / B1b at the stage shape against
their plain versions, timed). ``--sweep`` then starts the two ranks afresh
for each M and engine (``chip_smoke.PIPE_STEPS`` steps and one profiled)
and prints one JSON line a rank and engine: its step seconds, tokens/s,
device busy share (its kernels' device time over the profiled step's wall)
and peak memory, beside the schedule's bubble (S - 1)/(M + S - 1) and the
JAX package's logged bubble for that M (MULTICHIP_r05.json: 0.50, 0.33,
0.20 at M 1, 2, 4; a formula it printed, not a measurement). Both ranks
share one card: a rank's idle share mixes the bubble with the other rank's
time slices.
"""

from __future__ import annotations

import json
import sys

from _checkout import open_checkout

JAX_BUBBLE = {1: 0.50, 2: 0.33, 4: 0.20}


def main(argv=None) -> int:
    args, root, fa, build_s = open_checkout(
        "time_pipe", __doc__, argv, "ops.cuda.flash_attention",
        values=("--seed", "--phases", "--sweep"))
    import numpy as np
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"root={root} build_s={build_s} card={card}", flush=True)
    seed = int(args.seed or 0)
    dev = torch.device("cuda", 0)
    if args.phases:
        gen = torch.Generator(device=dev).manual_seed(seed)
        cs.phase_pipe(torch, np, fa, dev, gen, seed, card)
    for m in [int(x) for x in (args.sweep or "").split(",") if x]:
        for kind, phase in (("1f1b", "50"), ("gpipe", "51")):
            # an engine a start of the ranks: the card holds both ranks
            for rank, r in enumerate(cs.run_pipe_ranks(seed, phase, m)):
                run = r[kind]
                want = cs.pipe_want(kind, run["stage"], m)
                if any(step != want for step in run["launches"]):
                    cs.fail(f"M={m} {kind} rank {rank}: launches "
                            f"{run['launches']}, want {want} a step")
                summary = cs.print_pipe_run(run, kind, rank, m, card)
                print(json.dumps({
                    "root": root, "engine": kind, "m": m, "rank": rank,
                    "stage": run["stage"], "losses": run["losses"],
                    "step_s": run["step_s"],
                    "mean_step_s": summary["step_s"],
                    "tokens_per_s": cs.PIPE_MICRO * m * cs.PIPE_SEQ
                    / summary["step_s"],
                    "device_busy_share": summary["busy_share"],
                    "schedule_bubble": summary["bubble"],
                    "jax_logged_bubble": JAX_BUBBLE.get(m),
                    "peak_bytes": run["peak"],
                    "comm_bytes_per_step": run["comm_bytes_per_step"],
                    "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
