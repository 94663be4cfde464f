"""What the ``time_*`` tools share: the checkout under test.

Each tool times the code of one checkout of this repository (``--root``,
default the one holding the tool) with this checkout's ``chip_smoke.py``
measuring functions, so two commits compare in one call on one card: unpack
the other into a directory and time both in turns (parent, change, change,
parent), one process a turn. ``--build-only`` builds the checkout's kernels
and exits.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def open_checkout(tool: str, doc: str, argv, module: str, flags=(),
                  values=()):
    """Parse ``--root``, ``--build-only``, the boolean ``flags`` and the
    string options ``values`` (default None); exit 2
    without CUDA; import this checkout's ``chip_smoke`` and then
    ``deepspeed_tpu_torch.<module>`` from ``--root`` (raising if it came
    from elsewhere); build that checkout's kernels, and exit 0 after
    printing the build seconds under ``--build-only``.

    Returns ``(args, root, module, build_s)``; ``chip_smoke`` is then
    this checkout's in ``sys.modules``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--build-only", action="store_true")
    for flag in flags:
        ap.add_argument(flag, action="store_true")
    for name in values:
        ap.add_argument(name, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print(f"{tool}: CUDA is not available", file=sys.stderr)
        raise SystemExit(2)
    sys.path.insert(0, REPO)
    import chip_smoke  # noqa: F401  (this checkout's, before --root's)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    mod = importlib.import_module(f"deepspeed_tpu_torch.{module}")
    if not os.path.abspath(mod.__file__).startswith(root):
        raise RuntimeError(f"imported {mod.__file__}, not from {root}")
    from deepspeed_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    if args.build_only:
        print(json.dumps({"root": root, "build_s": build_s}), flush=True)
        raise SystemExit(0)
    return args, root, mod, build_s
