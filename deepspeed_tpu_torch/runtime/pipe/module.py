"""PipelineModule / LayerSpec.

The port's own copy of ``deepspeed_tpu/runtime/pipe/module.py`` (reference
``runtime/pipe/module.py``: ``LayerSpec``:25 lazy construction,
``TiedLayerSpec``:73, ``PipelineModule``:87 with ``_partition_layers``:363).

The model is a list of layer specs; stages own contiguous slices. A spec
builds its ``nn.Module`` only when a stage asks for it, so a rank builds its
own stage's layers and nothing else. Partitioning methods match the
reference: ``uniform`` (equal layer counts), ``parameters`` (equal parameter
counts, from each layer class's static ``num_params``), ``type:regex``
(balance the layers whose class name matches).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence

import numpy as np


class LayerSpec:
    def __init__(self, typename: Callable, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs

    def build(self, **extra):
        """The layer: ``typename(*module_args, **module_kwargs, **extra)``
        (``extra``: e.g. the ``device`` a stage builds on, for classes that
        take one)."""
        return self.typename(*self.module_args, **self.module_kwargs, **extra)

    def param_count_estimate(self) -> int:
        """Estimated parameter count for `parameters` partitioning; layer
        classes may expose `.num_params(*args, **kwargs)`."""
        est = getattr(self.typename, "num_params", None)
        if est is not None:
            try:
                return int(est(*self.module_args, **self.module_kwargs))
            except Exception:
                return 1
        return 1

    def __repr__(self):
        return f"LayerSpec({getattr(self.typename, '__name__', self.typename)})"


class TiedLayerSpec(LayerSpec):
    def __init__(self, key: str, typename: Callable, *module_args,
                 forward_fn=None, tied_weight_attr: str = "weight",
                 **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


def partition_balanced(weights: Sequence[float], num_parts: int) -> List[int]:
    """Split `weights` into `num_parts` contiguous chunks minimizing the max
    chunk weight (greedy prefix-sum bisection, same contract as the
    reference's ds_utils.partition_balanced)."""
    weights = list(weights)
    n = len(weights)
    if num_parts > n:
        raise ValueError(f"cannot split {n} layers into {num_parts} stages")
    prefix = np.concatenate([[0], np.cumsum(weights)])
    total = prefix[-1]

    # binary search on the bottleneck
    lo, hi = max(weights), float(total)

    def feasible(cap):
        parts, start = 1, 0
        for i in range(1, n + 1):
            if prefix[i] - prefix[start] > cap:
                parts += 1
                start = i - 1
                if prefix[i] - prefix[start] > cap:
                    return None
                if parts > num_parts:
                    return None
        return True
    for _ in range(50):
        mid = (lo + hi) / 2
        if feasible(mid):
            hi = mid
        else:
            lo = mid
    cap = hi
    bounds = [0]
    start = 0
    for i in range(1, n + 1):
        if prefix[i] - prefix[start] > cap:
            bounds.append(i - 1)
            start = i - 1
    bounds.append(n)
    # pad with empty stages if fewer cuts than parts
    while len(bounds) < num_parts + 1:
        bounds.insert(-1, bounds[-2])
    return bounds[:num_parts + 1]


class PipelineModule:
    """Holds layer specs + the stage partition. Parameter construction and
    the 1F1B execution live in the pipeline engine (``engine.py``)."""

    def __init__(self, layers: Sequence, num_stages: int,
                 topology=None, loss_fn: Optional[Callable] = None,
                 partition_method: str = "parameters",
                 activation_checkpoint_interval: int = 0,
                 seed_layers: bool = False, base_seed: int = 1234):
        self.layer_specs = [l if isinstance(l, LayerSpec) else LayerSpec(l)
                            for l in layers]
        self.num_stages = num_stages
        self.topology = topology
        self.loss_fn = loss_fn
        self.partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.seed_layers = seed_layers
        self.base_seed = base_seed
        self.parts = self._partition_layers()

    def _partition_layers(self) -> List[int]:
        method = self.partition_method.lower()
        n = len(self.layer_specs)
        if method == "uniform":
            weights = [1.0] * n
        elif method == "parameters":
            weights = [float(s.param_count_estimate()) for s in self.layer_specs]
        elif method.startswith("type:"):
            pat = re.compile(method[5:], re.IGNORECASE)
            weights = [1.0 if pat.search(getattr(s.typename, "__name__", ""))
                       else 0.0 for s in self.layer_specs]
            if sum(weights) == 0:
                raise ValueError(f"no layers match {method!r}")
        else:
            raise ValueError(f"unknown partition_method {self.partition_method!r}")
        return partition_balanced(weights, self.num_stages)

    def stage_layers(self, stage_id: int) -> List[LayerSpec]:
        lo, hi = self.parts[stage_id], self.parts[stage_id + 1]
        return self.layer_specs[lo:hi]

    def stage_owner(self, layer_idx: int) -> int:
        for s in range(self.num_stages):
            if self.parts[s] <= layer_idx < self.parts[s + 1]:
                return s
        raise IndexError(layer_idx)

    def tied_keys(self):
        """Each tied key -> the indices of the layers that share it, in
        layer order (the first is the canonical owner)."""
        out = {}
        for i, spec in enumerate(self.layer_specs):
            if isinstance(spec, TiedLayerSpec):
                out.setdefault(spec.key, []).append(i)
        return out

    @property
    def num_layers(self):
        return len(self.layer_specs)
