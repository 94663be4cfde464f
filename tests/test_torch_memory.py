"""The port's ZeRO memory models (deepspeed_tpu_torch/autotuning/memory.py)
against the TPU package's (deepspeed_tpu/autotuning/memory.py): each
ported function returns exactly what the JAX one returns on the same
arguments (plain float arithmetic, no device), ``host_resources`` reading
the same ``/proc/meminfo`` text; the port's ``chip_memory_bytes`` reads the
card and, on a host without one, takes its default or raises."""

import builtins
import io

import numpy as np
import pytest
import torch

from torch_test_threads import one_torch_thread  # noqa: F401

N = 1_313_722_368


def _mods():
    from deepspeed_tpu.autotuning import memory as jm
    from deepspeed_tpu_torch.autotuning import memory as pm
    return jm, pm


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("dp,mp,half,factor", [(1, 1, True, 12),
                                               (8, 1, True, 12),
                                               (64, 2, False, 8)])
def test_model_states_memory(stage, dp, mp, half, factor):
    jm, pm = _mods()
    kw = dict(zero_stage=stage, dp=dp, mp=mp, half_precision=half,
              optimizer_factor=factor)
    assert pm.model_states_memory_per_chip(N, **kw) == \
        jm.model_states_memory_per_chip(N, **kw)


@pytest.mark.parametrize("remat", [False, True])
def test_activation_memory_and_max_micro_batch(remat):
    jm, pm = _mods()
    kw = dict(micro_batch=4, seq_len=1024, hidden=2048, layers=24,
              checkpoint_activations=remat)
    assert pm.activation_memory_per_chip(**kw) == \
        jm.activation_memory_per_chip(**kw)
    for budget in (1e9, 80e9, 16e9):
        kw = dict(num_params=N, zero_stage=2, dp=8, mp=1, seq_len=1024,
                  hidden=2048, layers=24, checkpoint_activations=remat)
        assert pm.max_micro_batch_for_budget(budget, **kw) == \
            jm.max_micro_batch_for_budget(budget, **kw)


def test_capacity_tiers_and_estimates():
    jm, pm = _mods()
    for args in ((80e9, 96e9, 2e12), (16e9, 256e9, 0.0), (141e9, 1e12, 4e12)):
        assert pm.capacity_tiers(*args) == jm.capacity_tiers(*args)
    for kw in ({}, {"num_chips_per_host": 8, "num_hosts": 4}):
        assert pm.estimate_zero_model_states_mem_needs(N, **kw) == \
            jm.estimate_zero_model_states_mem_needs(N, **kw)


@pytest.mark.parametrize("prefetch,mirror", [(0, True), (10**9, False)])
def test_plan_infinity(prefetch, mirror):
    jm, pm = _mods()
    numels = list(np.random.default_rng(0).integers(1, 10**8, 40))
    kw = dict(chips=64, hosts=16, hbm_per_chip=80e9,
              host_dram_per_host=1e12, nvme_per_host=8e12, micro_batch=2,
              seq_len=2048, hidden=12288, layers=96,
              prefetch_numel=prefetch, mirror_on_nvme=mirror)
    assert pm.plan_infinity(numels, **kw) == jm.plan_infinity(numels, **kw)


def test_host_resources_reads_the_same_meminfo(monkeypatch, tmp_path):
    jm, pm = _mods()
    text = "MemTotal: 105906176 kB\nMemAvailable:   98765432 kB\n"
    real_open = builtins.open

    def fake_open(path, *a, **kw):
        if path == "/proc/meminfo":
            return io.StringIO(text)
        return real_open(path, *a, **kw)
    monkeypatch.setattr(builtins, "open", fake_open)
    got = pm.host_resources(str(tmp_path))
    assert got == jm.host_resources(str(tmp_path))
    assert got["host_dram"] == 98765432 * 1024


def test_chip_memory_bytes_on_a_host_without_a_card():
    _, pm = _mods()
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the value is the card's")
    assert pm.chip_memory_bytes(default=80e9) == 80e9
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.chip_memory_bytes()
