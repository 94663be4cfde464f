#!/usr/bin/env python3
"""Show that the sequence-parallel kernel checks of ``chip_smoke.py`` catch
planted faults, on one NVIDIA GPU.

    python3 tools/check_sp_gates.py [--seed N]

Phase 47 holds B1 / B1b at ``SP_FLASH``'s shapes, and phase 48 the ring's
output and grads, within ``SP_ROW_RTOL`` of the largest |plain| of each
row plus ``SP_HEAD_ATOL`` of each head's rms (``_close_rows``). This tool
runs those comparisons (``_flash_results``, ``_sp_ring_results``) on this
checkout and on copies of its package with a fault planted, made in a
temporary directory and built there:

  * ``kernels``: ``flash_attention.cu`` with three faults at once, each
    seen by its own comparison (the backward takes the plain forward's out
    and lse): the forward leaves key tile 1's P V out of the output (its
    exp-sum, so lse, stays right), the dq kernel key tile 1's dS, the dk/dv
    kernel the first query tile past a key block's first;
  * ``ring_merge_skip``: ``RingAttention`` keeps only its first block (the
    second is left out of ``_merge``);
  * ``ring_merge_max``: ``_merge`` takes the larger lse for the log-sum-exp.

For each copy and comparison it prints one JSON line: the max abs error,
the max error over its row bound (``_row_share``: the gate passes at <= 1)
and whether the row gate and the older elementwise ``FLASH_TOL`` pass,
beside the card's name and power limit. It exits 0 when the clean checkout
passes every row gate and each planted fault fails the row gate of what it
targets; else 1. ``--mode`` and ``--ring-rank`` are the runs it starts.
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

CU = "ops/cuda/csrc/flash_attention.cu"
RING = "ops/ring_attention.py"
# (file under the package, the text, what replaces it): each text occurs
# once in its file
PLANTS = {
    "kernels": [
        (CU, """      for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];
      to_a<T, kN>(pa, s);
""", """      for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];
      to_a<T, kN>(pa, s);
      if (i == 1)
        for (int z0 = 0; z0 < kN / 16; ++z0)
          for (int z1 = 0; z1 < 4; ++z1) pa[z0][z1] = 0u;
"""),
        (CU, "s[e] = p * (dp[e] - dl[r]);",
         "s[e] = i == 1 ? 0.f : p * (dp[e] - dl[r]);"),
        (CU, """          p[e] = x;
""", """          if (i == first + 1) x = 0.f;
          p[e] = x;
""")],
    "ring_merge_skip": [
        (RING, """else _merge(out, lse,
                                                                 o, l)""",
         "else (out, lse)")],
    "ring_merge_max": [
        (RING, "new = torch.logaddexp(lse, l)",
         "new = torch.maximum(lse, l)")],
}
# what each planted copy must fail: (mode, the comparisons)
TARGETS = {"kernels": ("flash", ("out", "dq", "dk", "dv")),
           "ring_merge_skip": ("ring", ("out",)),
           "ring_merge_max": ("ring", ("out",))}
RANK_TIMEOUT_S = 900


def plant(root: str, name: str) -> None:
    """Apply plant ``name`` to the package copy under ``root``."""
    for rel, old, new in PLANTS[name]:
        path = os.path.join(root, "deepspeed_tpu_torch", rel)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise RuntimeError(f"plant {name}: {old!r} is not once in {rel}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))


def copy_package(dest: str) -> None:
    shutil.copytree(os.path.join(REPO, "deepspeed_tpu_torch"),
                    os.path.join(dest, "deepspeed_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))


def gates(cs, name, got, ref) -> dict:
    """One comparison under the gates: lse within LSE_ATOL, the rest under
    the row gate and the elementwise FLASH_TOL (True: passes)."""
    def passes(check, *args):
        try:
            check(got, ref, *args)
            return True
        except RuntimeError:
            return False
    err = (got.float() - ref.float()).abs().max().item()
    if name == "lse":
        return {"max_abs_err": err,
                "lse_atol": passes(cs._close, cs.LSE_ATOL, 0.0)}
    return {"max_abs_err": err, "row_share": cs._row_share(got, ref),
            "row_gate": passes(cs._close_rows),
            "flash_tol": passes(cs._close, *cs.FLASH_TOL)}


def merge(into: dict, name: str, g: dict) -> None:
    """Fold a head slice's verdicts into ``into[name]``."""
    if name not in into:
        into[name] = dict(g)
        return
    for key, val in g.items():
        into[name][key] = (into[name][key] and val if isinstance(val, bool)
                           else max(into[name][key], val))


def flash_mode(torch, cs, fa, seed, card, copy):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for tag, B, S, H, D, causal in cs.SP_FLASH:
        q, k, v, do = cs._qkv(torch, dev, gen, B, S, H, D)
        res = {}
        for name, got, ref in cs._flash_results(torch, fa, q, k, v, do,
                                                causal, cs.SP_PLAIN_HEADS):
            merge(res, name, gates(cs, name, got, ref))
        print(json.dumps({"copy": copy, "check": "flash", "shape": tag,
                          "B": B, "S": S, "H": H, "D": D, "causal": causal,
                          "gates": res, "card": card}), flush=True)
        del q, k, v, do
        torch.cuda.empty_cache()


def ring_mode(torch, cs, args, card, copy):
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_lib
    comm.init_distributed(dist_backend="gloo",
                          init_method=f"tcp://localhost:{args.port}",
                          rank=int(args.ring_rank), world_size=cs.SP)
    mesh_lib.ensure_global_mesh(mesh_lib.MeshShape.infer(cs.SP, sp=cs.SP))
    group = comm.new_group("sp")
    res = {}
    for name, got, ref in cs._sp_ring_results(
            torch, group, torch.device("cuda", 0), int(args.seed or 0)):
        merge(res, name, gates(cs, name, got, ref))
    print(json.dumps({"copy": copy, "check": "ring", "rank": group.rank,
                      "heads": cs.SP_RING_CHECK_HEADS, "S": cs.CTX_SEQ,
                      "gates": res, "card": card}), flush=True)
    torch.distributed.destroy_process_group()


def run(cmds) -> list:
    """Start ``cmds`` together; their JSON lines (fails on an exit code)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = []
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            print(out[-6000:], flush=True)
            raise RuntimeError(f"{cmds[0][:4]} exited {p.returncode}")
        lines += [json.loads(x) for x in out.splitlines()
                  if x.startswith("{")]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


def sub(root, mode, seed, copy, extra=()):
    return [sys.executable, os.path.abspath(__file__), "--root", root,
            "--mode", mode, "--seed", str(seed), "--copy", copy, *extra]


def ring_ranks(root, seed, copy) -> list:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    return run([sub(root, "ring", seed, copy,
                    ("--ring-rank", str(r), "--port", str(port)))
                for r in range(2)])


def main(argv=None) -> int:
    args, root, fa, build_s = open_checkout(
        "check_sp_gates", __doc__, argv, "ops.cuda.flash_attention",
        values=("--seed", "--mode", "--ring-rank", "--port", "--copy"))
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    seed = int(args.seed or 0)
    copy = args.copy or "clean"
    if args.mode == "flash":
        flash_mode(torch, cs, fa, seed, card, copy)
        return 0
    if args.mode == "ring":
        ring_mode(torch, cs, args, card, copy)
        return 0
    print(f"root={root} build_s={build_s} card={card}", flush=True)
    lines = run([sub(root, "flash", seed, "clean")])
    lines += ring_ranks(root, seed, "clean")
    with tempfile.TemporaryDirectory() as d:
        kernels, ring = os.path.join(d, "kernels"), os.path.join(d, "ring")
        copy_package(kernels)
        plant(kernels, "kernels")
        lines += run([sub(kernels, "flash", seed, "kernels")])
        copy_package(ring)
        for name in ("ring_merge_skip", "ring_merge_max"):
            shutil.copy(os.path.join(REPO, "deepspeed_tpu_torch", RING),
                        os.path.join(ring, "deepspeed_tpu_torch", RING))
            plant(ring, name)
            lines += ring_ranks(ring, seed, name)
    bad = []
    for line in lines:
        res = line["gates"]
        if line["copy"] == "clean":
            bad += [(line["check"], n) for n, g in res.items()
                    if not g.get("row_gate", g.get("lse_atol"))]
    for name, (check, targets) in TARGETS.items():
        for t in targets:
            if all(line["gates"][t]["row_gate"] for line in lines
                   if line["copy"] == name and line["check"] == check):
                bad.append((name, t))
    print(json.dumps({"ok": not bad, "missed_or_failed": bad,
                      "row_rtol": cs.SP_ROW_RTOL,
                      "head_atol": cs.SP_HEAD_ATOL, "flash_tol": cs.FLASH_TOL,
                      "card": card}), flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
