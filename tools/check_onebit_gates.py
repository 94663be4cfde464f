#!/usr/bin/env python3
"""Run the 1-bit phases of ``chip_smoke.py`` alone, and show that their
gates catch planted faults, on one NVIDIA GPU.

    python3 tools/check_onebit_gates.py [--seed N] [--clean-only]

Phases 52-53 run in two gloo ranks sharing the card (``chip_smoke.py``
with the hidden ``--dp-rank`` and ``--dp-onebit``): phase 52 holds three
compressed all-reduces at GPT-2 125M's padded size to the plain exchange
(``plain_compressed``) and to a host run; phase 53 trains GPT-2 125M with
OneBitAdam, OneBitLamb and ZeroOneAdam (``phase_onebit``'s gates). This
tool runs both on the clean checkout, printing every line the full script
prints for them, then, unless ``--clean-only``, the phase each fault
targets on a copy of ``chip_smoke.py`` and the package with that fault
planted, made in a temporary directory (sharing this checkout's built
kernels):

  * ``no_error_feedback``: the worker compresses its buffer without
    adding its error buffer;
  * ``no_server_error``: the server recompresses without its error buffer;
  * ``bit_order``: the signs are packed high bit first (and unpacked so,
    so the exchange's result is unchanged);
  * ``grads_averaged``: the runner averages the gradients over the ranks
    before the optimizer compresses them.

For each run it prints one JSON line: whether every gate passed and, if
not, the first gate that failed, beside the card's name and power limit.
It exits 0 when the clean checkout passes and each planted fault fails a
gate; else 1.
"""

from __future__ import annotations

import json
import sys
import tempfile

from _checkout import open_checkout
from check_pipe_gates import planted_copy

COMPRESSED = "comm/compressed.py"
RUNNER = "runtime/fp16/onebit/integration.py"
# name -> (the phase it targets, plants: (file under the package, the
# text, what replaces it); each text occurs once)
PLANTS = {
    "no_error_feedback": ("52", [
        (COMPRESSED, "    corrected = buf + worker_error\n",
         "    corrected = buf + 0 * worker_error\n")]),
    "no_server_error": ("52", [
        (COMPRESSED, "    m = m + server_error\n",
         "    m = m + 0 * server_error\n")]),
    "bit_order": ("52", [
        (COMPRESSED, "_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)\n",
         "_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)\n")]),
    "grads_averaged": ("53", [
        (RUNNER, "        loss_sum, g = self._local_grad(micros, p_eff)\n",
         "        loss_sum, g = self._local_grad(micros, p_eff)\n"
         "        g = comm.all_reduce(g, \"avg\", group=self.group)\n")]),
}


def gates(cs, card, ranks, phases: str):
    """None when the gates of ``phases`` pass, else the first failure."""
    try:
        if "52" in phases:
            cs.phase_compressed(card, ranks)
        if "53" in phases:
            cs.phase_onebit(card, ranks)
    except RuntimeError as e:
        return str(e)
    return None


def main(argv=None) -> int:
    args, root, _, build_s = open_checkout(
        "check_onebit_gates", __doc__, argv, "comm.compressed",
        flags=("--clean-only",), values=("--seed",))
    import chip_smoke as cs
    card = cs.card_line()
    seed = int(args.seed or 0)
    print(f"build_s={build_s} card={card}", flush=True)
    runs = [("clean", "52,53", [])]
    if not args.clean_only:
        runs += [(name, phase, plants)
                 for name, (phase, plants) in PLANTS.items()]
    ok = True
    for name, phases, plants in runs:
        with tempfile.TemporaryDirectory() as d:
            script = planted_copy(d, plants) if plants else None
            ranks = cs.run_dp_ranks(seed, (), 52, onebit=phases,
                                    script=script)
        failed = gates(cs, card, ranks, phases)
        ok &= (failed is None) == (name == "clean")
        print(json.dumps({"run": name, "phases": phases,
                          "gates_passed": failed is None,
                          "first_failure": failed, "card": card}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
