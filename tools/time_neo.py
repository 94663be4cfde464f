#!/usr/bin/env python3
"""Serve GPT-Neo 1.3B through a checkout of this repository on one NVIDIA
GPU: HF injection, local windows and int8 weights.

    python3 tools/time_neo.py [--root DIR] [--build-only] [--seed N]

``--root`` names the checkout run, ``--build-only`` only builds it
(``tools/_checkout.py``). It runs this checkout's ``chip_smoke.py`` phases
40 (GPT-Neo 1.3B from an HF-named state dict through ``HFGPTNeoPolicy``:
the forward through B1 against the einsum, greedy ``generate``, the dense,
fused and speculative megakernel engines against megakernel=False, the
paged refusal, and B1 / B2 at its shapes against their plain versions,
timed) and 41 (int8 weights, symmetric and asymmetric) over that
checkout's package, on phase 4's 16 requests, printing their numbers
beside the card's name and power limit.
"""

from __future__ import annotations

import sys

from _checkout import open_checkout


def main(argv=None) -> int:
    args, root, _, build_s = open_checkout(
        "time_neo", __doc__, argv, "module_inject.policies",
        values=("--seed",))
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
    neo = cs.phase_neo_serving(torch, np, dev, seed, prompts, kw, card)
    cs.phase_neo_int8(torch, np, dev, neo, kw, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
