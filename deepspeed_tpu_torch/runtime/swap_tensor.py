"""NVMe tensor swapping: the ZeRO-Infinity offload tier.

Ports ``deepspeed_tpu/runtime/swap_tensor.py`` (``TensorSwapper`` :36,
``OptimizerSwapper`` :136, ``ParamSwapper`` :154; reference
``runtime/swap_tensor/partitioned_optimizer_swapper.py:27``,
``partitioned_param_swapper.py:37``) over the port's flat buffers and the
port's async I/O handle (``ops/aio.py`` ← ``ops/csrc/aio.cpp``).

A swapper writes named tensors to one file each under its directory and
reads them back. Each rank swaps into its own subdirectory,
``<nvme_path>/<optimizer|param>/rank<r>``. A tensor on the card is staged
through one host buffer a key, page-locked in place at its first swap
(:class:`~deepspeed_tpu_torch.accelerator.PinnedHost`) and reused by every
later one; a CPU tensor is written as it lies, and read back into a
buffer the caller gives or a new one.
While a tier is swapped out its slot holds :class:`Swapped` placeholders,
so the memory it held is released; restore it before anything reads it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.accelerator import PinnedHost
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle

MANIFEST = "swap_manifest.json"


@dataclasses.dataclass(frozen=True)
class Swapped:
    """A tensor that lives in a swap file: its shape, dtype and device."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.replace("torch.", ""))


class TensorSwapper:
    """Swap named tensors to files under ``swap_dir`` and back (the files
    written and read in parallel by the async I/O handle)."""

    def __init__(self, swap_dir: str, n_threads: int = 4):
        self.swap_dir = swap_dir
        os.makedirs(swap_dir, exist_ok=True)
        self.handle = AsyncIOHandle(n_threads)
        self._manifest: Dict[str, Dict[str, Any]] = {}
        self._staging: Dict[str, PinnedHost] = {}
        self._copied = None     # the event after the last copies to a card
        #: the last swap-out's and swap-in's seconds, and the bytes a swap
        self.last: Dict[str, float] = {}

    def _path(self, key: str) -> str:
        return os.path.join(self.swap_dir, key.replace("/", "__") + ".bin")

    def _stage(self, key: str, shape, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
        """``key``'s staging buffer (locked for ``device`` at first use)."""
        buf = self._staging.get(key)
        if buf is None:
            n = 1
            for d in shape:
                n *= int(d)
            buf = self._staging[key] = PinnedHost(n, dtype, device)
        return buf.tensor.view(tuple(shape))

    def swap_out(self, tensors: Dict[str, torch.Tensor]) -> None:
        t0, nbytes = time.perf_counter(), 0
        for key, t in tensors.items():
            t = t.detach()
            if t.device.type != "cpu" or not t.is_contiguous():
                # ordered after the copies out of the buffer on the stream
                host = self._stage(key, t.shape, t.dtype, t.device)
                host.copy_(t)
                t = host
            self._manifest[key] = {"shape": list(t.shape),
                                   "dtype": str(t.dtype)}
            self.handle.async_pwrite(t, self._path(key))
            nbytes += t.numel() * t.element_size()
        with open(os.path.join(self.swap_dir, MANIFEST), "w") as f:
            json.dump(self._manifest, f)
        self.handle.wait_all()
        self.last.update(out_s=time.perf_counter() - t0, bytes=nbytes)

    def swap_in(self, device=None,
                into: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """Every swapped tensor, read back onto ``device`` (the CPU when
        None): on a card through its staging buffer, on the CPU into
        ``into[key]`` where given, else a new tensor."""
        if not self._manifest:
            with open(os.path.join(self.swap_dir, MANIFEST)) as f:
                self._manifest = json.load(f)
        device = torch.device("cpu") if device is None else torch.device(
            device)
        if self._copied is not None:    # the staging buffers' last readers
            self._copied.synchronize()
            self._copied = None
        t0, nbytes = time.perf_counter(), 0
        bufs: Dict[str, torch.Tensor] = {}
        for key, meta in self._manifest.items():
            shape, dtype = tuple(meta["shape"]), _dtype(meta["dtype"])
            if device.type != "cpu":
                buf = self._stage(key, shape, dtype, device)
            elif into is not None and key in into:
                buf = into[key]
            else:
                buf = torch.empty(shape, dtype=dtype)
            self.handle.async_pread(buf, self._path(key))
            bufs[key] = buf
            nbytes += buf.numel() * buf.element_size()
        self.handle.wait_all()
        if device.type != "cpu":
            bufs = {k: v.to(device, non_blocking=True)
                    for k, v in bufs.items()}
            if device.type == "cuda":
                self._copied = torch.cuda.Event()
                self._copied.record(torch.cuda.current_stream(device))
        self.last.update(in_s=time.perf_counter() - t0, bytes=nbytes)
        return bufs

    def close(self) -> None:
        """Unlock the staging buffers (idempotent)."""
        for buf in self._staging.values():
            buf.release()
        self._staging = {}


class _StateSwapper:
    """An engine's NVMe swapper for one tier: the optimizer moments
    (``state["opt"]``) or the fp32 master (``flat_master``)."""

    subdir: str

    def __init__(self, engine, swap_dir: Optional[str] = None,
                 n_threads: int = 4):
        swap_dir = swap_dir or self._config(engine).nvme_path or \
            os.path.join(tempfile.gettempdir(), "dstpu_torch_swap")
        self.engine = engine
        rank = getattr(engine, "rank", 0)
        self.swapper = TensorSwapper(
            os.path.join(swap_dir, self.subdir, f"rank{rank}"), n_threads)
        self._swapped = False

    def _config(self, engine):
        raise NotImplementedError

    @property
    def swapped(self) -> bool:
        return self._swapped


class OptimizerSwapper(_StateSwapper):
    """NVMe optimizer-state swapper (``offload_optimizer.device ==
    "nvme"``): every tensor of ``engine.state["opt"]`` (the moments, and
    ZenFlow's ``cold_acc``)."""

    subdir = "optimizer"

    def _config(self, engine):
        return engine.config.zero_optimization.offload_optimizer

    def swap_out_optimizer(self) -> None:
        opt = self.engine.state["opt"]
        tensors = {k: v for k, v in opt.items()
                   if isinstance(v, torch.Tensor)}
        self.swapper.swap_out(tensors)
        for k, v in tensors.items():
            opt[k] = Swapped(tuple(v.shape), v.dtype, v.device)
        self._swapped = True

    def swap_in_optimizer(self) -> None:
        if not self._swapped:
            return
        opt = self.engine.state["opt"]
        devices = {k: v.device for k, v in opt.items()
                   if isinstance(v, Swapped)}
        dev = next(iter(devices.values()))
        for k, v in self.swapper.swap_in(dev).items():
            opt[k] = v
        self._swapped = False


class ParamSwapper(_StateSwapper):
    """NVMe parameter swapper (``offload_param.device == "nvme"`` at stage
    3): the fp32 master, round-tripped through its file between steps. It
    restores into the engine's pinned-host tier buffer; the engine moves
    it to the card for the step."""

    subdir = "param"

    def _config(self, engine):
        return engine.config.zero_optimization.offload_param

    def swap_out_params(self) -> None:
        e = self.engine
        if e.device.type == "cuda":
            # the parked master is an async device→host copy's target
            torch.cuda.current_stream(e.device).synchronize()
        self.swapper.swap_out({"master": e.flat_master})
        e._set_master(Swapped(tuple(e.flat_master.shape), e.flat_master.dtype,
                              e.flat_master.device))
        self._swapped = True

    def swap_in_params(self) -> None:
        if not self._swapped:
            return
        e = self.engine
        host = e._host_buffer("master", e.flat_master)
        e._set_master(self.swapper.swap_in(into={"master": host})["master"])
        self._swapped = False
