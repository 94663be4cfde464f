#!/usr/bin/env python3
"""Show that the pipeline gates of ``chip_smoke.py`` catch planted faults,
on one NVIDIA GPU.

    python3 tools/check_pipe_gates.py [--seed N]

Phases 50-51 hold each pipeline engine at pp 2 (GPT-2 1.3B, two gloo ranks
sharing the card) to the dense engine on the same weights and batches:
every step's loss within ``PIPE_LOSS_ATOL`` and the first step's global
grad norm within ``PIPE_NORM_RTOL`` of it (``check_pipe_run``). This tool
runs the dense engine once, then the ranks of the clean checkout (both
engines) and of copies of ``chip_smoke.py`` and the package with one fault
planted each, made in a temporary directory (sharing this checkout's built
kernels):

  * ``tied_not_reduced``: ``ReduceTiedGrads`` does nothing (the 1F1B
    engine's embedding and head replicas step on their own grads);
  * ``tied_twice``: the tied grads are summed over the owners twice;
  * ``cotangent_dropped``: stage 0 backpropagates micro-batch 1 with a
    zero cotangent;
  * ``rest_times_S``: ``GPipeSpmdEngine`` counts the grads of the
    parameters outside the blocks S times.

For each run, engine and rank it prints one JSON line: the largest loss gap
and the first grad norm's relative gap against the dense engine, whether
each gate passes and whether the launches are right, beside the card's name
and power limit. It exits 0 when the clean checkout passes every gate and
each planted fault fails a gate of the engine it targets; else 1.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

from _checkout import REPO, open_checkout

ENGINE = "runtime/pipe/engine.py"
BUILD = "ops/cuda/_build.py"
SPMD = "runtime/pipe/spmd.py"
# name -> (the engine it targets, the phase that runs it, plants: (file
# under the package, the text, what replaces it); each text occurs once)
PLANTS = {
    "tied_not_reduced": ("1f1b", "50", [
        (ENGINE, "                self._reduce_tied_grads()\n",
         "                pass\n")]),
    "tied_twice": ("1f1b", "50", [
        (ENGINE, "                self._reduce_tied_grads()\n",
         "                self._reduce_tied_grads()\n"
         "                self._reduce_tied_grads()\n")]),
    "cotangent_dropped": ("1f1b", "50", [
        (ENGINE, "cots = _leaves(self._fetch(s + 1, _GRAD, m))",
         "cots = [c * (m != 1) for c in "
         "_leaves(self._fetch(s + 1, _GRAD, m))]")]),
    "rest_times_S": ("gpipe", "51", [
        (SPMD, "            torch._foreach_div_(grads, float(self.dp))\n",
         "            torch._foreach_div_(grads, float(self.dp))\n"
         "        torch._foreach_mul_(grads[nb:], float(self.num_stages))\n")]),
}


def planted_copy(d: str, plants) -> str:
    """``chip_smoke.py`` and the package under ``d``, the plants applied;
    returns the copy's ``chip_smoke.py``. The copy's kernel loader points
    at this checkout's sources and build directory (the plants are Python
    only), so the copy runs the kernels already built instead of building
    them again."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), d)
    src = os.path.join(REPO, "deepspeed_tpu_torch")
    pkg = os.path.join(d, "deepspeed_tpu_torch")
    shutil.copytree(src, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", "_build"))
    loader = [
        (BUILD, 'CSRC = os.path.join(os.path.dirname(os.path.abspath('
         '__file__)), "csrc")\n',
         f"CSRC = {os.path.join(src, 'ops', 'cuda', 'csrc')!r}\n"),
        (BUILD, 'BUILD_DIR = os.path.join(\n    os.path.dirname(os.path.'
         'dirname(os.path.dirname(os.path.abspath(__file__)))),\n'
         '    "_build")\n',
         f"BUILD_DIR = {os.path.join(src, '_build')!r}\n")]
    for rel, old, new in loader + plants:
        path = os.path.join(pkg, rel)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise RuntimeError(f"plant text occurs {text.count(old)} times "
                               f"in {rel}: {old!r}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    return os.path.join(d, "chip_smoke.py")


def run_ranks(script: str, seed: int, phases: str, d: str, timeout: float):
    """``script``'s two pipeline ranks (--pipe-rank); their JSON results."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, script, "--seed", str(seed), "--pipe-rank",
         str(rank), "--pipe-phases", phases, "--dp-port", str(port),
         "--dp-out", os.path.join(d, f"rank{rank}.json")],
        env=dict(os.environ, LOCAL_RANK="0"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-6000:], flush=True)
            raise RuntimeError(f"{script} rank {rank} exited {p.returncode}")
    results = []
    for rank in range(2):
        with open(os.path.join(d, f"rank{rank}.json")) as fh:
            results.append(json.load(fh))
    return results


def main(argv=None) -> int:
    args, root, _, build_s = open_checkout(
        "check_pipe_gates", __doc__, argv, "runtime.pipe.engine",
        values=("--seed",))
    import numpy as np
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    seed = int(args.seed or 0)
    dev = torch.device("cuda", 0)
    print(f"build_s={build_s} card={card}", flush=True)
    dense = cs.pipe_dense(torch, np, dev, seed, card)
    runs = [("clean", None, "50,51", [])] + [
        (name, kind, phase, plants)
        for name, (kind, phase, plants) in PLANTS.items()]
    ok = True
    for name, target, phases, plants in runs:
        with tempfile.TemporaryDirectory() as d:
            script = (os.path.join(REPO, "chip_smoke.py") if not plants
                      else planted_copy(d, plants))
            ranks = run_ranks(script, seed, phases, d, cs.PIPE_TIMEOUT_S)
        caught = False
        for kind in ("1f1b", "gpipe"):
            for rank, r in enumerate(ranks):
                if kind not in r:
                    continue
                run = r[kind]
                gap = max(abs(a - b) for a, b in
                          zip(run["losses"], dense["losses"]))
                norm_gap = abs(run["norms"][0] - dense["norms"][0]) \
                    / dense["norms"][0]
                want = cs.pipe_want(kind, run["stage"], cs.PIPE_M)
                loss_pass = gap <= cs.PIPE_LOSS_ATOL
                norm_pass = norm_gap <= cs.PIPE_NORM_RTOL
                print(json.dumps({
                    "run": name, "engine": kind, "rank": rank,
                    "losses": run["losses"], "dense": dense["losses"],
                    "loss_gap": gap, "loss_gate": cs.PIPE_LOSS_ATOL,
                    "loss_pass": loss_pass, "norm": run["norms"][0],
                    "dense_norm": dense["norms"][0], "norm_gap": norm_gap,
                    "norm_gate": cs.PIPE_NORM_RTOL, "norm_pass": norm_pass,
                    "launches_ok": all(s == want for s in run["launches"]),
                    "card": card}), flush=True)
                if target is None:
                    ok &= loss_pass and norm_pass
                elif kind == target:
                    caught |= not (loss_pass and norm_pass)
        if target is not None:
            print(f"{name}: {'caught' if caught else 'NOT caught'}",
                  flush=True)
            ok &= caught
    print(f"check_pipe_gates {'ok' if ok else 'FAILED'} card={card}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
