"""Device resolution, name, count, synchronize and memory stats.

Parity: ``deepspeed_tpu/accelerator/{abstract_accelerator,real_accelerator,
cpu_accelerator}.py``. The JAX seam detects its platform and falls back to
the CPU; this one does not fall back. ``device=None`` means the first CUDA
device, and without one it raises: a run that asked for the GPU must never
carry on silently on the CPU. The CPU is reached only by asking for it
(``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda:0``; ``"cpu"`` → the CPU; ``"cuda"``/``"cuda:N"`` →
    that card. Raises ``RuntimeError`` when a CUDA device is asked for
    (explicitly or by default) and none is present."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} does not exist "
                               f"({torch.cuda.device_count()} CUDA devices)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


_SAME_DEVICE = contextlib.nullcontext()


def on_device(device: torch.device):
    """A context that makes the CUDA ``device`` current, for a launch from
    code that reads the current device; a no-op context when it already
    is (the common case: one card, entered once per launch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)


def device_name(device: DeviceLike = None) -> str:
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(dev)


def device_count() -> int:
    """Number of CUDA devices (0 without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def synchronize(device: DeviceLike = None) -> None:
    """Block the host until the device's queued work is done (no-op on the
    CPU, where PyTorch runs synchronously)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def memory_stats(device: DeviceLike = None) -> Dict[str, int]:
    """``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit`` — the
    keys the JAX accelerator reports. Zeros on the CPU (unknown)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    return {"bytes_in_use": torch.cuda.memory_allocated(dev),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory}


class PinnedHost:
    """A host buffer page-locked in place (``cudaHostRegister``) for a card
    on ``device``; a plain host tensor for the CPU. Unlike
    ``pin_memory=True``, whose caching allocator rounds a block up to a
    power of two (an 18 GB buffer would lock 34 GB), it locks exactly the
    buffer's bytes. ``release()`` (or the object's collection) unlocks it;
    nothing may copy into or out of it after that."""

    def __init__(self, n: int, dtype: torch.dtype, device: torch.device):
        self.tensor = torch.empty(n, dtype=dtype)
        self._registered = False
        if device.type == "cuda" and n:
            err = torch.cuda.cudart().cudaHostRegister(
                self.tensor.data_ptr(),
                self.tensor.numel() * self.tensor.element_size(), 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of {n} {dtype} "
                                   f"elements failed: cudaError {int(err)}")
            self._registered = True

    def release(self) -> None:
        if self._registered:
            torch.cuda.synchronize()
            torch.cuda.cudart().cudaHostUnregister(self.tensor.data_ptr())
            self._registered = False
        self.tensor = None

    def __del__(self):
        try:
            self.release()
        # interpreter teardown: the CUDA runtime may already be gone
        except Exception:                                   # noqa: BLE001
            pass
