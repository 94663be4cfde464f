"""Data loading: the port's own copy of ``deepspeed_tpu/runtime/dataloader.py``
(reference: deepspeed/runtime/dataloader.py — DeepSpeedDataLoader:33,
RepeatingLoader:10). The loader yields global batches as numpy arrays; the
engine moves each micro-batch to its device. With ``torch.distributed``
initialized, each process takes the slice of its dp coordinate on the
device mesh (``parallel/mesh.py``): the ranks that differ only off dp (ep
partners) hold the same rows, as the TPU engine shards the batch over dp
only."""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Optional

import numpy as np


class RepeatingLoader:
    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


def default_collate(samples):
    """Stack a list of samples (dicts / tuples / arrays) into a batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples])
                           for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


def _process_index_and_count():
    """(this process's dp coordinate, the dp size) on the global mesh."""
    from ..parallel import mesh as mesh_lib
    mesh = mesh_lib.get_global_mesh()
    return mesh.coord("dp"), mesh.shape["dp"]


class DeepSpeedDataLoader:
    """Batches an indexable dataset into global batches, one process's share
    at a time, with optional shuffling and drop_last."""

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 shuffle: bool = False, seed: int = 42, drop_last: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        rank, world = _process_index_and_count()
        self.process_index = rank if process_index is None else process_index
        self.process_count = world if process_count is None else process_count
        if batch_size % self.process_count:
            raise ValueError(
                f"global batch {batch_size} not divisible by process count "
                f"{self.process_count}")
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else math.ceil(n / self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        per_proc = self.batch_size // self.process_count
        for b in range(len(self)):
            batch_idx = idx[b * self.batch_size:(b + 1) * self.batch_size]
            lo = self.process_index * per_proc
            local = batch_idx[lo:lo + per_proc] if self.process_count > 1 \
                else batch_idx
            yield self.collate_fn([self.dataset[int(i)] for i in local])
