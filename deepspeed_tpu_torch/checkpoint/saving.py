"""Checkpoint save/load.

Counterpart of ``deepspeed_tpu/checkpoint/saving.py`` (reference:
``engine.save_checkpoint`` engine.py:2768, ``load_checkpoint``:2438, the
tag file ``latest``:2948, ``deepspeed/utils/zero_to_fp32.py``). One
directory per tag, in one of the TPU package's two numpy layouts:

  * npz: rank 0 writes the whole state,
      - ``meta.json``         : counters, loss scale, schedule, client state
      - ``model_states.npz``  : fp32 masters, keyed by ``state_dict`` name
      - ``optim_states.npz``  : ``count`` and ``<moment>/<name>`` arrays
  * host_sharded (``meta.json`` ``format``): every dp rank writes its
    ZeRO slice of the masters and moments (an ep > 1 engine its slice of
    the whole leaves, from the ranks at ep coordinate 0),
    ``zero_host_shard_p<dp rank>.npz`` with
    keys ``<i>:master`` and ``<i>:<moment>`` beside a ``.json`` of per-leaf
    ``path``, ``offset``, ``numel``, ``padded``, ``global_numel`` and
    ``shape`` (the layout of the TPU package's offload tier).

plus a root ``latest`` file naming the newest tag and the standalone
``zero_to_fp32.py`` in the tag directory. Loading merges shard files by
offset into whole arrays, so a checkpoint loads at any dp. The TPU
package's orbax directories are not written (no orbax here).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterable, Optional

import numpy as np

from ..comm import comm
from ..utils.logging import log_dist
from . import zero_to_fp32

def save_tree(path: str, arrays: Dict[str, np.ndarray]) -> None:
    np.savez(path, **arrays)


def load_tree_arrays(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def drop_recovery_script(ckpt_dir: str) -> None:
    """Copy the standalone zero_to_fp32.py into the checkpoint dir so the
    checkpoint is recoverable with numpy alone (reference:
    engine.py:3066-3075)."""
    try:
        shutil.copyfile(zero_to_fp32.__file__,
                        os.path.join(ckpt_dir, "zero_to_fp32.py"))
    except OSError as e:  # never fail a save over the convenience script
        log_dist(f"could not drop zero_to_fp32.py: {e}", ranks=[0])


def _finish(save_dir: str, tag: str, meta: Dict[str, Any],
            save_latest: bool) -> str:
    """Rank 0 writes meta.json, ``latest`` and the recovery script once
    every rank's files are down; every rank leaves after it."""
    ckpt_dir = os.path.join(save_dir, tag)
    comm.barrier()
    if comm.get_rank() == 0:
        with open(os.path.join(ckpt_dir, "meta.json"), "w") as fh:
            json.dump(meta, fh, indent=2)
        if save_latest:
            with open(os.path.join(save_dir, "latest"), "w") as fh:
                fh.write(tag)
        drop_recovery_script(ckpt_dir)
    comm.barrier()
    return ckpt_dir


def save_checkpoint_dir(save_dir: str, tag: str, *,
                        master_params: Optional[Dict[str, np.ndarray]],
                        opt_state: Optional[Dict[str, np.ndarray]],
                        meta: Dict[str, Any], save_latest: bool = True) -> str:
    """The npz layout; only rank 0's arrays are read (others may pass
    None)."""
    ckpt_dir = os.path.join(save_dir, tag)
    if comm.get_rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        save_tree(os.path.join(ckpt_dir, "model_states.npz"), master_params)
        save_tree(os.path.join(ckpt_dir, "optim_states.npz"), opt_state)
    ckpt_dir = _finish(save_dir, tag, meta, save_latest)
    log_dist(f"saved checkpoint {ckpt_dir}", ranks=[0])
    return ckpt_dir


def save_host_sharded_dir(save_dir: str, tag: str, *,
                          arrays: Dict[str, np.ndarray],
                          leaves: Iterable[Dict[str, Any]], step: int,
                          meta: Dict[str, Any], save_latest: bool = True,
                          shard=None, write: bool = True) -> str:
    """The host_sharded layout: this rank's ``arrays`` (``<i>:master``,
    ``<i>:<moment>``) and ``leaves`` metadata as shard ``shard = (index,
    count)`` (default: this rank of the world), then rank 0's shared
    files. A rank whose shard another rank writes (an ep partner) passes
    ``write=False`` and only joins the barriers."""
    ckpt_dir = os.path.join(save_dir, tag)
    os.makedirs(ckpt_dir, exist_ok=True)
    index, count = shard or (comm.get_rank(), comm.get_world_size())
    if write:
        base = os.path.join(ckpt_dir, f"zero_host_shard_p{index}")
        np.savez(base + ".npz", **arrays)
        with open(base + ".json", "w") as fh:
            json.dump({"dp_shard": [index, count], "step": step,
                       "leaves": list(leaves)}, fh)
    ckpt_dir = _finish(save_dir, tag, dict(meta, format="host_sharded"),
                       save_latest)
    log_dist(f"saved host-sharded checkpoint {ckpt_dir}", ranks=[0])
    return ckpt_dir


def read_latest_tag(load_dir: str) -> Optional[str]:
    p = os.path.join(load_dir, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as fh:
        return fh.read().strip()


def _load_host_shards(ckpt_dir: str, moments: Iterable[str]):
    """Whole arrays merged from the shard files: the masters by path, and
    ``count`` plus ``<moment>/<path>`` for each moment in the files."""
    metas, infos = zero_to_fp32._load_shard_metas(ckpt_dir)
    pool = zero_to_fp32._ShardPool([m["_npz"] for m in metas])
    try:
        stored = set(k.split(":", 1)[1] for k in pool[0].files)
        master, opt = {}, {"count": np.asarray(metas[0]["step"])}
        for i, info in enumerate(infos):
            master[info["path"]] = zero_to_fp32._merge_leaf(
                pool, metas, i, info)
            for m in moments:
                if m in stored:
                    opt[f"{m}/{info['path']}"] = zero_to_fp32._merge_leaf(
                        pool, metas, i, info, key=m)
    finally:
        pool.close()
    return master, opt


def load_checkpoint_dir(load_dir: str, tag: Optional[str],
                        moments: Iterable[str] = ()):
    """``{"tag", "meta", "master_params", "opt_state"}`` with whole numpy
    arrays in either layout, or None when ``load_dir`` has no ``latest``
    and no tag is given."""
    tag = tag or read_latest_tag(load_dir)
    if tag is None:
        return None
    ckpt_dir = os.path.join(load_dir, tag)
    with open(os.path.join(ckpt_dir, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get("format") == "host_sharded":
        master, opt = _load_host_shards(ckpt_dir, moments)
    else:
        master = load_tree_arrays(os.path.join(ckpt_dir,
                                               "model_states.npz"))
        opt = load_tree_arrays(os.path.join(ckpt_dir, "optim_states.npz"))
    return {"tag": tag, "meta": meta, "master_params": master,
            "opt_state": opt}


def consolidated_fp32_state_dict(master_params) -> Dict[str, np.ndarray]:
    """zero_to_fp32 analogue: full fp32 weights keyed by name (copies),
    from whole arrays or tensors."""
    return {k: np.array(v.detach().cpu() if hasattr(v, "detach") else v,
                        np.float32)
            for k, v in master_params.items()}
