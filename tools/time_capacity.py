#!/usr/bin/env python3
"""Run the layer-streamed capacity tier of a checkout of this repository on
one NVIDIA GPU.

    python3 tools/time_capacity.py [--root DIR] [--build-only] [--model NAME]

``--root`` names the checkout run, ``--build-only`` only builds it
(``tools/_checkout.py``). It runs this checkout's ``chip_smoke.py``
pieces over that checkout's package: the flash kernels at the capacity
shape (B 1, S 1024, H 32, D 80, bf16, causal) against their plain
versions and timed beside scaled_dot_product_attention, then phases 35
(streamed against plain offload at GPT 2.7B's width, 4 layers), 36
(cpu_checkpointing against remat) and 37 (``bench.py``'s capacity_streamed
pick at full width and depth; with ``--model`` that menu entry instead of
the pick: gpt_neox_6.7b, gpt_2.7b or gpt2_1.3b), printing their numbers
beside the card's name and power limit.
"""

from __future__ import annotations

import sys

from _checkout import open_checkout


def main(argv=None) -> int:
    args, root, _, build_s = open_checkout(
        "time_capacity", __doc__, argv, "runtime.zero.layer_stream",
        values=("--model",))
    import numpy as np
    import torch
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"root={root} build_s={build_s} card={card}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, H, D, causal = cs.CAPACITY_FLASH
    q, k, v, do = cs._qkv(torch, dev, gen, B, S, H, D)
    errs, (ro, rl) = cs._flash_pair(torch, fa, q, k, v, do, causal)
    print(f"flash capacity d80 max_abs_err {errs} card={card}", flush=True)
    for name, vals in cs._flash_times(torch, fa, q, k, v, do, ro, rl,
                                      causal).items():
        print(f"flash capacity d80 {name} " + " ".join(
            f"{key}={val}" for key, val in vals.items()) + f" card={card}",
            flush=True)
    del q, k, v, do, ro, rl
    torch.cuda.empty_cache()
    cs.phase_streamed_parity(torch, np, dev, 0, card)
    cs.phase_cpu_checkpointing(torch, np, dev, 0, card)
    cs.phase_capacity_streamed(torch, np, dev, 0, card, model=args.model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
