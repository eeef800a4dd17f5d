"""Asynchronous file I/O for the NVMe tier: the binding of ``csrc/aio.cpp``.

Ports ``deepspeed_tpu/ops/aio.py`` (``AsyncIOHandle`` :92-175, the
reference's ``aio_handle`` with ``async_pread`` / ``async_pwrite`` /
``wait``) over the port's own copy of the C++ library
(``ops/csrc/aio.cpp``), which ``ops/build.py`` builds with ``g++`` at
first use into ``build/torch_kernels/``. Two engines: ``threads``
(positional pread/pwrite on a thread pool) and ``uring`` (raw io_uring,
block-sized chunks at a queue depth, optional O_DIRECT with aligned bounce
buffers); ``auto`` takes ``uring`` where the kernel accepts it, and the
``DSTPU_AIO_ENGINE`` environment variable overrides ``auto`` only.

Buffers are numpy arrays or contiguous CPU tensors (pinned or not). A
failed build raises :class:`~deepspeed_tpu_torch.ops.build.KernelBuildError`;
nothing falls back to Python file I/O.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Union

import numpy as np
import torch

from deepspeed_tpu_torch.ops import build

Buffer = Union[np.ndarray, torch.Tensor]

_lib = None
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load_host("aio")
            lib.aio_handle_create_ex.restype = ctypes.c_void_p
            lib.aio_handle_create_ex.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long,
                ctypes.c_int]
            lib.aio_handle_destroy.argtypes = [ctypes.c_void_p]
            for name in ("aio_submit_pwrite", "aio_submit_pread"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
            lib.aio_wait.restype = ctypes.c_long
            lib.aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.aio_wait_all.restype = ctypes.c_int
            lib.aio_wait_all.argtypes = [ctypes.c_void_p]
            lib.aio_pending.restype = ctypes.c_int
            lib.aio_pending.argtypes = [ctypes.c_void_p]
            lib.aio_uring_supported.restype = ctypes.c_int
            lib.aio_uring_supported.argtypes = []
            _lib = lib
    return _lib


def uring_supported() -> bool:
    """True when the kernel accepts ``io_uring_setup`` (builds the library;
    a failed build raises)."""
    return bool(_load().aio_uring_supported())


def _address(buf: Buffer, writeable: bool):
    """(address, bytes) of a contiguous host buffer."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("aio buffers must be contiguous CPU tensors, "
                             f"got {buf.device} contiguous="
                             f"{buf.is_contiguous()}")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    if not buf.flags["C_CONTIGUOUS"] or (writeable
                                         and not buf.flags["WRITEABLE"]):
        raise ValueError("pread buffer must be contiguous and writeable"
                         if writeable else "pwrite buffer must be contiguous")
    return buf.ctypes.data, buf.nbytes


class AsyncIOHandle:
    """The reference ``aio_handle`` analog over numpy arrays and CPU tensors.

    A buffer passed to an async op must stay alive until it is waited on;
    the handle keeps a reference until then."""

    def __init__(self, n_threads: int = 4, engine: str = "auto",
                 odirect: bool = False, block_bytes: int = 1 << 20,
                 queue_depth: int = 32):
        """``engine``: 'threads', 'uring' or 'auto' (uring when the kernel
        supports it; ``DSTPU_AIO_ENGINE`` overrides 'auto' only — an
        explicit engine is always honoured). ``odirect`` / ``block_bytes``
        / ``queue_depth`` mirror the reference aio config."""
        self._lib = _load()
        if engine == "auto":
            engine = os.environ.get("DSTPU_AIO_ENGINE", "auto")
        if engine == "auto":
            engine = "uring" if self._lib.aio_uring_supported() else "threads"
        if engine not in ("threads", "uring"):
            raise ValueError(f"engine must be auto|threads|uring, got "
                             f"{engine!r}")
        self.engine = engine
        self._h = self._lib.aio_handle_create_ex(
            n_threads, 1 if engine == "uring" else 0, int(odirect),
            block_bytes, queue_depth)
        self._live: Dict[int, Buffer] = {}

    def close(self) -> None:
        """Wait for every op and free the handle (idempotent)."""
        if getattr(self, "_h", None):
            self._lib.aio_wait_all(self._h)
            self._lib.aio_handle_destroy(self._h)
            self._h = None
            self._live.clear()

    def __del__(self):
        try:
            self.close()
        # interpreter teardown: ctypes or the library may already be gone
        except Exception:                                   # noqa: BLE001
            pass

    def _submit(self, fn, buf: Buffer, path: str, offset: int,
                writeable: bool) -> int:
        if not isinstance(buf, torch.Tensor) and not writeable:
            buf = np.ascontiguousarray(buf)
        ptr, nbytes = _address(buf, writeable)
        op = fn(self._h, path.encode(), ptr, nbytes, offset)
        if op < 0:
            raise OSError(-op, os.strerror(-op), path)
        self._live[op] = buf
        return op

    def async_pwrite(self, buf: Buffer, path: str, offset: int = 0) -> int:
        return self._submit(self._lib.aio_submit_pwrite, buf, path, offset,
                            writeable=False)

    def async_pread(self, buf: Buffer, path: str, offset: int = 0) -> int:
        return self._submit(self._lib.aio_submit_pread, buf, path, offset,
                            writeable=True)

    def wait(self, op_id: int) -> int:
        rc = self._lib.aio_wait(self._h, op_id)
        self._live.pop(op_id, None)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        return int(rc)

    def wait_all(self) -> None:
        rc = self._lib.aio_wait_all(self._h)
        self._live.clear()
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))

    def pending(self) -> int:
        return int(self._lib.aio_pending(self._h))

    def sync_pwrite(self, buf: Buffer, path: str, offset: int = 0) -> int:
        return self.wait(self.async_pwrite(buf, path, offset))

    def sync_pread(self, buf: Buffer, path: str, offset: int = 0) -> int:
        return self.wait(self.async_pread(buf, path, offset))
