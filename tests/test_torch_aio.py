"""The port's async file I/O (``ops/aio.py`` over its copy of
``csrc/aio.cpp``) against the JAX package's handle.

Counterparts of ``tests/unit/test_offload.py::TestAio`` and
``TestAioEngines``: round trips, async overlap, offsets, the threads and
io_uring engines with O_DIRECT and an unaligned tail, a short file's read
returning the bytes there are, ``DSTPU_AIO_ENGINE`` applying to ``auto``
only; CPU tensors (pinned or not) as buffers beside numpy arrays; a file
written by either package's handle reads back bit for bit through the
other's; a failed build raises.
"""
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle, uring_supported


def test_roundtrip_numpy_and_tensor(tmp_path):
    h = AsyncIOHandle(n_threads=2)
    data = np.random.default_rng(0).standard_normal(1024).astype(np.float32)
    path = str(tmp_path / "buf.bin")
    assert h.sync_pwrite(data, path) == data.nbytes
    out = torch.empty(1024)
    assert h.sync_pread(out, path) == data.nbytes
    np.testing.assert_array_equal(out.numpy(), data)
    t = torch.randn(333, dtype=torch.float64)
    h.sync_pwrite(t, path)
    back = np.empty(333, np.float64)
    h.sync_pread(back, path)
    np.testing.assert_array_equal(back, t.numpy())


def test_async_overlap(tmp_path):
    h = AsyncIOHandle(n_threads=4)
    bufs = [torch.full((4096,), float(i)) for i in range(8)]
    ops = [h.async_pwrite(b, str(tmp_path / f"f{i}.bin"))
           for i, b in enumerate(bufs)]
    for op in ops:
        assert h.wait(op) == bufs[0].numel() * 4
    reads = [torch.empty(4096) for _ in range(8)]
    for i, r in enumerate(reads):
        h.async_pread(r, str(tmp_path / f"f{i}.bin"))
    assert h.pending() >= 0
    h.wait_all()
    for i, r in enumerate(reads):
        assert torch.equal(r, bufs[i])


def test_offset_io(tmp_path):
    h = AsyncIOHandle(n_threads=1)
    path = str(tmp_path / "seg.bin")
    a = np.arange(16, dtype=np.int32)
    b = np.arange(16, 32, dtype=np.int32)
    h.sync_pwrite(a, path, offset=0)
    h.sync_pwrite(b, path, offset=a.nbytes)
    out = np.empty(32, np.int32)
    h.sync_pread(out, path)
    np.testing.assert_array_equal(out, np.arange(32, dtype=np.int32))


@pytest.mark.parametrize("engine,odirect", [
    ("threads", False), ("uring", False), ("uring", True)])
def test_roundtrip_with_unaligned_tail(tmp_path, engine, odirect):
    if engine == "uring" and not uring_supported():
        pytest.skip("kernel without io_uring")
    h = AsyncIOHandle(n_threads=2, engine=engine, odirect=odirect,
                      block_bytes=1 << 20, queue_depth=8)
    buf = np.random.default_rng(1).integers(
        0, 255, size=3 * (1 << 20) + 999, dtype=np.uint8)
    path = str(tmp_path / "t.bin")
    assert h.sync_pwrite(buf, path) == buf.nbytes
    out = np.empty_like(buf)
    assert h.sync_pread(out, path) == buf.nbytes
    np.testing.assert_array_equal(out, buf)


def test_short_file_read_matches_threads_semantics(tmp_path):
    data = np.random.default_rng(5).integers(
        0, 255, size=3 * (1 << 20) + 77, dtype=np.uint8)
    path = str(tmp_path / "short.bin")
    AsyncIOHandle(engine="threads").sync_pwrite(data, path)
    engines = ("threads", "uring") if uring_supported() else ("threads",)
    for engine in engines:
        h = AsyncIOHandle(engine=engine, block_bytes=1 << 20, queue_depth=8)
        out = np.zeros(4 * (1 << 20), dtype=np.uint8)
        n = h.sync_pread(out, path)
        assert n == data.nbytes, (engine, n)
        np.testing.assert_array_equal(out[:n], data)


def test_engine_choice_and_env_override(monkeypatch):
    h = AsyncIOHandle(engine="auto")
    assert h.engine == ("uring" if uring_supported() else "threads")
    monkeypatch.setenv("DSTPU_AIO_ENGINE", "threads")
    assert AsyncIOHandle(engine="auto").engine == "threads"
    if uring_supported():
        assert AsyncIOHandle(engine="uring").engine == "uring"  # explicit
    with pytest.raises(ValueError, match="auto|threads|uring"):
        AsyncIOHandle(engine="libaio")


def test_files_cross_between_the_packages(tmp_path):
    """The port's copy of the library writes what the JAX package's
    handle reads, and the other way round."""
    from deepspeed_tpu.ops.aio import AsyncIOHandle as JaxHandle

    data = np.random.default_rng(3).standard_normal(5000).astype(np.float32)
    AsyncIOHandle().sync_pwrite(data, str(tmp_path / "p.bin"))
    got = np.empty_like(data)
    JaxHandle().sync_pread(got, str(tmp_path / "p.bin"))
    np.testing.assert_array_equal(got, data)
    JaxHandle().sync_pwrite(data[::-1].copy(), str(tmp_path / "j.bin"))
    back = torch.empty(5000)
    AsyncIOHandle().sync_pread(back, str(tmp_path / "j.bin"))
    np.testing.assert_array_equal(back.numpy(), data[::-1])


def test_bad_buffers_and_paths_raise(tmp_path):
    h = AsyncIOHandle(n_threads=1)
    with pytest.raises(ValueError, match="contiguous"):
        h.async_pread(torch.empty(8, 2).t(), str(tmp_path / "x.bin"))
    ro = np.zeros(8, np.float32)
    ro.setflags(write=False)
    with pytest.raises(ValueError, match="writeable"):
        h.async_pread(ro, str(tmp_path / "x.bin"))
    with pytest.raises(OSError):
        h.sync_pread(np.empty(8, np.float32), str(tmp_path / "missing.bin"))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A host library that does not compile raises ``KernelBuildError``
    with the compiler's message; nothing falls back."""
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setenv("DSTPU_TORCH_BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(build.KernelBuildError, match="g\\+\\+ failed"):
        build.load_host("broken")
    assert os.path.isdir(tmp_path / "out")
