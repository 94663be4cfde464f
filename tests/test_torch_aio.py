"""The port's async file I/O (deepspeed_tpu_torch/ops/aio.py over its own
ops/cpu/csrc/aio.cpp) and the NVMe swapper on top of it, on the CPU: round
trips at aligned and unaligned sizes and offsets, sync and async, bitwise;
files written by the JAX package's handle read back by the port's and the
other way round; O_DIRECT's alignment rules enforced, and the mode each
open ran in counted; the swapper's [master | m | v] records read back
bitwise."""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import aio as jax_aio
from deepspeed_tpu_torch.ops import aio
from deepspeed_tpu_torch.runtime.zero.offload import NVMeLeafSwapper
from torch_test_threads import one_torch_thread  # noqa: F401


def _bytes(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8))


def test_aligned_empty_and_padded_nbytes():
    for n, dtype in ((1, torch.float32), (1000, torch.bfloat16),
                     (4096, torch.uint8), (0, torch.float32)):
        t = aio.aligned_empty(n, dtype)
        assert t.data_ptr() % aio.DIRECT_ALIGN == 0
        assert t.numel() >= n
        assert (t.numel() * t.element_size()) % aio.DIRECT_ALIGN == 0
    assert [aio.padded_nbytes(n) for n in (0, 1, 4096, 4097)] == \
        [0, 4096, 4096, 8192]


@pytest.mark.parametrize("nbytes,offset", [(1, 0), (4095, 3), (5000, 0),
                                           (3 * 4096 + 7, 4096 + 1)])
@pytest.mark.parametrize("asynchronous", [False, True])
def test_buffered_round_trip_at_any_size(tmp_path, nbytes, offset,
                                         asynchronous):
    h = aio.AsyncIOHandle(block_size=4096, queue_depth=4)
    path = str(tmp_path / "f.bin")
    src, dst = _bytes(nbytes, nbytes), torch.zeros(nbytes, dtype=torch.uint8)
    if asynchronous:
        h.async_pwrite(src, path, offset)
        h.wait()
        h.async_pread(dst, path, offset)
        h.wait()
    else:
        h.sync_pwrite(src, path, offset)
        h.sync_pread(dst, path, offset)
    assert torch.equal(src, dst)
    assert os.path.getsize(path) == offset + nbytes
    assert h.bytes_written == h.bytes_read == nbytes
    assert h.opens == {"buffered": 2}
    h.close()


@pytest.mark.parametrize("nbytes", [4096, 5 * 4096])
def test_direct_round_trip_reports_its_mode(tmp_path, nbytes):
    h = aio.AsyncIOHandle(block_size=4096, queue_depth=4)
    path = str(tmp_path / "d.bin")
    src = aio.aligned_empty(nbytes, torch.uint8)
    src.copy_(_bytes(nbytes, 7))
    dst = aio.aligned_empty(nbytes, torch.uint8)
    h.async_pwrite(src, path, 0, direct=True)
    h.wait()
    h.sync_pread(dst, path, 0, direct=True)
    assert torch.equal(src, dst)
    # O_DIRECT, or buffered where this filesystem refuses it: counted
    assert sum(h.opens.values()) == 2
    assert set(h.opens) <= {"O_DIRECT", "buffered"}
    h.close()


def test_direct_io_rejects_unaligned_requests(tmp_path):
    h = aio.AsyncIOHandle()
    path = str(tmp_path / "x.bin")
    buf = aio.aligned_empty(8192, torch.uint8)
    with pytest.raises(ValueError, match="DIRECT_ALIGN"):
        h.sync_pwrite(buf[:100], path, direct=True)
    with pytest.raises(ValueError, match="DIRECT_ALIGN"):
        h.sync_pwrite(buf[1:4097], path, direct=True)
    with pytest.raises(ValueError, match="DIRECT_ALIGN"):
        h.sync_pwrite(buf[:4096], path, offset=512, direct=True)
    h.sync_pwrite(buf[:100], path)
    with pytest.raises(OSError, match="short read"):
        h.sync_pread(torch.zeros(200, dtype=torch.uint8), path)
    h.close()


def test_files_cross_between_the_packages(tmp_path):
    nbytes = 3 * 4096 + 11
    jh, ph = jax_aio.AsyncIOHandle(), aio.AsyncIOHandle()
    a, b = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    src = _bytes(nbytes, 5)
    jh.sync_pwrite(src.numpy(), a)
    got = torch.zeros(nbytes, dtype=torch.uint8)
    ph.sync_pread(got, a)
    assert torch.equal(got, src)
    ph.sync_pwrite(src, b)
    back = np.zeros(nbytes, np.uint8)
    jh.sync_pread(back, b)
    np.testing.assert_array_equal(back, src.numpy())
    ph.close()


@pytest.mark.parametrize("depth_budget", [0, 3 * 1000])
def test_swapper_records_read_back_bitwise(tmp_path, depth_budget):
    """Leaves of several sizes: the first record is master + zero moments;
    a written slot reads back bitwise through another slot; files are
    whole DIRECT_ALIGN records."""
    sizes = [1000, 37, 1000, 513]
    sw = NVMeLeafSwapper(str(tmp_path), max(sizes),
                         prefetch_numel=depth_budget)
    assert sw.num_slots == NVMeLeafSwapper.slot_count(sw.prefetch_depth)
    rng = np.random.default_rng(0)
    masters = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
               for n in sizes]
    for i, m in enumerate(masters):
        sw.write_init(i, m)
    for i, (n, m) in enumerate(zip(sizes, masters)):
        got_m, got_a, got_v = sw.read_sync(i, n, slot=i % sw.num_slots)
        assert torch.equal(got_m, m)
        assert not got_a.any() and not got_v.any()
        got_a.copy_(m * 2)
        got_v.copy_(m * 3)
        sw.write_sync(i, n, slot=i % sw.num_slots)
        assert os.path.getsize(sw._file(i)) % aio.DIRECT_ALIGN == 0
    for i, (n, m) in enumerate(zip(sizes, masters)):
        got_m, got_a, got_v = sw.read_sync(i, n, slot=(i + 1) % sw.num_slots)
        assert torch.equal(got_m, m) and torch.equal(got_a, m * 2) \
            and torch.equal(got_v, m * 3)
    sw.close()
