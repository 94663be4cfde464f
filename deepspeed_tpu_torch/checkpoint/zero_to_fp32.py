#!/usr/bin/env python
"""Standalone fp32 weight recovery from a deepspeed_tpu_torch checkpoint
directory.

The port's own copy of ``deepspeed_tpu/checkpoint/zero_to_fp32.py``, with
the same command line. ``save_checkpoint`` copies it into every checkpoint
directory (reference analogue: ``deepspeed/utils/zero_to_fp32.py``, dropped
in at ``engine.py:3066-3075``) so a checkpoint is recoverable with nothing
but the files in the directory and numpy: no framework, no torch.

Formats (``meta.json`` ``format`` field / file layout):

  * npz: ``model_states.npz`` already holds the full fp32 master weights,
    keyed by the module's ``state_dict`` names; this script re-exports them.
  * host_sharded (ZeRO-1 over dp > 1): ``zero_host_shard_pN.npz`` +
    ``.json`` pairs hold each rank's contiguous slice of every flattened
    leaf (the reference's ``zero_pp_rank_*_optim_states.pt`` scheme). The
    slices are merged by offset, truncated to ``global_numel`` (padding laid
    past it), and reshaped to the recorded shape.

Usage:
    python zero_to_fp32.py <checkpoint_dir> [output.npz]

where <checkpoint_dir> is either a tag directory (contains meta.json) or a
save root (contains ``latest``). Writes ``output.npz`` (default
``fp32_weights.npz`` inside the tag dir), name-keyed fp32 arrays, loadable
with ``numpy.load``.
"""

import argparse
import glob
import json
import os
import re
import sys

import numpy as np


def _resolve_tag_dir(path):
    if os.path.isfile(os.path.join(path, "meta.json")) or glob.glob(
            os.path.join(path, "zero_host_shard_p*.json")):
        return path
    latest = os.path.join(path, "latest")
    if os.path.isfile(latest):
        with open(latest) as fh:
            tag = fh.read().strip()
        return os.path.join(path, tag)
    raise FileNotFoundError(
        f"{path!r} is neither a checkpoint tag dir (no meta.json) nor a "
        "save root (no 'latest' file)")


def _from_npz(tag_dir):
    path = os.path.join(tag_dir, "model_states.npz")
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k].astype(np.float32) for k in f.files}


def _shard_index(path):
    """Numeric pN suffix, so shard 10 sorts after shard 2 (lexicographic
    glob order would interleave them; harmless while host slices are
    disjoint, but merge order should be deterministic by rank regardless)."""
    m = re.search(r"_p(\d+)\.json$", path)
    return int(m.group(1)) if m else 1 << 30


def _load_shard_metas(tag_dir):
    """Validated (metas, infos) for a host-sharded checkpoint."""
    metas = []
    for jpath in sorted(glob.glob(
            os.path.join(tag_dir, "zero_host_shard_p*.json")),
            key=_shard_index):
        with open(jpath) as fh:
            m = json.load(fh)
        m["_npz"] = jpath[:-5] + ".npz"
        metas.append(m)
    if not metas:
        raise FileNotFoundError(
            f"no zero_host_shard_p*.json files in {tag_dir}")
    n_leaves = len(metas[0]["leaves"])
    for m in metas:
        if len(m["leaves"]) != n_leaves:
            raise ValueError("inconsistent leaf counts across shard files")
    infos = metas[0]["leaves"]
    for info in infos:
        if "shape" not in info:
            raise ValueError(
                "shard files predate self-describing metadata (no 'shape'); "
                "re-save the checkpoint or consolidate in-process with "
                "engine.consolidated_fp32_state_dict()")
    for m in metas:
        for i, info in enumerate(infos):
            if m["leaves"][i]["path"] != info["path"]:
                raise ValueError(
                    f"leaf {i} path mismatch across shards: "
                    f"{m['leaves'][i]['path']!r} vs {info['path']!r}")
    return metas, infos


def _merge_leaf(pool, metas, i, info, key="master"):
    """ONE leaf's ``key`` array (the master, or an optimizer moment)
    merged from all shard files (npz members load lazily, so
    this touches only leaf i's bytes of each archive). Peak memory is one
    leaf + its largest shard slice — the out-of-core unit. ``pool`` is
    indexed per shard IN SEQUENCE so its bounded fd window holds."""
    total = int(info["global_numel"])
    flat = np.zeros(total, np.float32)
    filled = np.zeros(total, bool)
    for k, m in enumerate(metas):
        li = m["leaves"][i]
        arr = pool[k][f"{i}:{key}"]
        lo = int(li["offset"])
        hi = min(lo + len(arr), total)
        if hi > lo:
            flat[lo:hi] = arr[:hi - lo]
            filled[lo:hi] = True
    if not filled.all():
        missing = int((~filled).sum())
        raise ValueError(
            f"leaf {info['path']!r} ({key}): {missing}/{total} elements not "
            "covered by any shard file — incomplete checkpoint (a host's "
            "shard file is missing)")
    shape = tuple(info["shape"])
    return flat.reshape(shape) if shape else flat[0]


class _ShardPool:
    """Lazy npz handles with a bounded open-file window: a 1024-host
    checkpoint would otherwise exceed typical fd ulimits (np.load keeps
    each archive's fd open). Handles open on first use and the
    least-recently-opened closes past ``cap``."""

    def __init__(self, paths, cap: int = 64):
        self._paths = list(paths)
        self._cap = max(1, cap)
        self._open: dict = {}
        self._order: list = []

    def __getitem__(self, idx: int):
        h = self._open.get(idx)
        if h is None:
            if len(self._order) >= self._cap:
                old = self._order.pop(0)
                self._open.pop(old).close()
            h = np.load(self._paths[idx], allow_pickle=False)
            self._open[idx] = h
            self._order.append(idx)
        return h

    def close(self):
        for h in self._open.values():
            h.close()
        self._open.clear()
        self._order.clear()


def iter_host_shard_leaves(tag_dir):
    """Out-of-core iterator: yields (path, fp32 array) one leaf at a time.
    This is what lets a 175B-class host-sharded checkpoint (reference
    zero_to_fp32.py walks shard files the same way, utils/zero_to_fp32.py)
    convert on a host whose RAM holds one leaf, not the model."""
    metas, infos = _load_shard_metas(tag_dir)
    pool = _ShardPool([m["_npz"] for m in metas])
    try:
        for i, info in enumerate(infos):
            yield info["path"], _merge_leaf(pool, metas, i, info)
    finally:
        pool.close()


def _from_host_shards(tag_dir):
    return dict(iter_host_shard_leaves(tag_dir))


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=None):
    """Full fp32 weights as {path: np.ndarray} from a checkpoint dir."""
    if tag is not None:
        checkpoint_dir = os.path.join(checkpoint_dir, tag)
    tag_dir = _resolve_tag_dir(checkpoint_dir)
    if os.path.isfile(os.path.join(tag_dir, "model_states.npz")):
        return _from_npz(tag_dir)
    if glob.glob(os.path.join(tag_dir, "zero_host_shard_p*.json")):
        return _from_host_shards(tag_dir)
    raise FileNotFoundError(f"no recognizable model states in {tag_dir}")


def stream_fp32_to_npz(tag_dir, out_path):
    """Host-sharded checkpoint -> fp32 .npz, ONE LEAF AT A TIME: leaves
    are merged and appended to the archive individually (the way np.savez
    writes members, but without ever materializing the whole model). At
    the 175B capacity tier this is the only conversion that fits in host
    RAM; engine.consolidated_fp32_state_dict() gathers in-process and is
    for test-scale models."""
    import zipfile
    n, total = 0, 0
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for path, arr in iter_host_shard_leaves(tag_dir):
            with zf.open(path + ".npy", "w", force_zip64=True) as fh:
                np.lib.format.write_array(fh, np.asanyarray(arr),
                                          allow_pickle=False)
            n += 1
            total += int(arr.size)
    return n, total


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Reconstruct full fp32 weights from a "
                    "deepspeed_tpu_torch "
                    "checkpoint (numpy only, no framework needed)")
    ap.add_argument("checkpoint_dir",
                    help="tag dir (has meta.json) or save root (has latest)")
    ap.add_argument("output", nargs="?", default=None,
                    help="output .npz (default: fp32_weights.npz in tag dir)")
    args = ap.parse_args(argv)
    tag_dir = _resolve_tag_dir(args.checkpoint_dir)
    out = args.output or os.path.join(tag_dir, "fp32_weights.npz")
    # same dispatch precedence as get_fp32_state_dict_from_zero_checkpoint:
    # a consolidated model_states.npz wins over leftover shard files
    if not os.path.isfile(os.path.join(tag_dir, "model_states.npz")) \
            and glob.glob(os.path.join(tag_dir,
                                       "zero_host_shard_p*.json")):
        # out-of-core: peak RAM = one leaf, any model size
        n, total = stream_fp32_to_npz(tag_dir, out)
        print(f"wrote {n} tensors ({total:,} params, fp32, streamed "
              f"leaf-by-leaf) -> {out}")
        return 0
    state = get_fp32_state_dict_from_zero_checkpoint(tag_dir)
    np.savez(out, **state)
    total = sum(int(v.size) for v in state.values())
    print(f"wrote {len(state)} tensors ({total:,} params, fp32) -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
