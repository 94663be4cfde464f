#!/usr/bin/env python3
"""Time the flash kernels at the sequence-parallel shapes through a checkout
of this repository on one NVIDIA GPU, and run the sequence-parallel phases.

    python3 tools/time_sp.py [--root DIR] [--build-only] [--seed N]
                             [--phases 47,48,49]

``--root`` names the checkout timed, ``--build-only`` only builds it
(``tools/_checkout.py``). For each of ``chip_smoke.py``'s ``SP_FLASH``
shapes (bench.py's long_context at seq 16384: the whole sequence's
[1, 16384, 12, 64] causal, a Ulysses rank's [1, 16384, 6, 64], a ring
rank's [1, 8192, 12, 64] causal and full blocks; bf16) it prints one JSON
line: the device ms per call of B1 and B1b through the checkout's package,
of their plain versions (over head slices) and of
scaled_dot_product_attention, and each kernel's bound, with
``chip_smoke.py``'s timing functions, beside the card's name and power
limit. ``--phases`` then runs this checkout's phases 47 (long_context at
sp 1 and B1 / B1b at those shapes against their plain versions), 48 (at
mesh {"sp": 2} over two gloo ranks, both cp_impls, against phase 47's
losses, which it runs first) and 49 (the sp prefill route on phase 4's
GPT-2 125M engine and requests) over the checkout's package.
"""

from __future__ import annotations

import json
import sys

from _checkout import open_checkout


def main(argv=None) -> int:
    args, root, fa, build_s = open_checkout(
        "time_sp", __doc__, argv, "ops.cuda.flash_attention",
        values=("--seed", "--phases"))
    import numpy as np
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"root={root} build_s={build_s} card={card}", flush=True)
    seed = int(args.seed or 0)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for tag, B, S, H, D, causal in cs.SP_FLASH:
        q, k, v, do = cs._qkv(torch, dev, gen, B, S, H, D)
        out, lse = fa.flash_attention_forward(q, k, v, causal, D ** -0.5)
        times = cs._flash_times(torch, fa, q, k, v, do, out, lse, causal,
                                plain_heads=cs.SP_PLAIN_HEADS)
        print(json.dumps({"root": root, "shape": tag, "B": B, "S": S,
                          "H": H, "D": D, "causal": causal, **times,
                          "card": card}), flush=True)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    phases = {int(p) for p in (args.phases or "").split(",") if p}
    if phases & {47, 48}:
        ctx, _, _ = cs.phase_long_context(torch, np, fa, dev, gen, seed,
                                          card)
        if 48 in phases:
            cs.phase_sp(seed, card, ctx)
    if 49 in phases:
        from deepspeed_tpu_torch import InferenceEngine
        from deepspeed_tpu_torch.models.gpt import GPT, gpt2_125m
        cfg = gpt2_125m(max_seq_len=1024, dtype=torch.bfloat16)
        model = GPT(cfg, device=dev)
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
        ie = InferenceEngine(model, dtype=torch.bfloat16, device=dev)
        rng = np.random.default_rng(seed)         # phase 4's requests
        prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
                   for n in rng.integers(16, 129, 16)]
        kw = dict(max_batch=8, decode_chunk=8, max_prompt_len=128)
        cs.phase_sp_route(torch, dev, ie, prompts, kw, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
