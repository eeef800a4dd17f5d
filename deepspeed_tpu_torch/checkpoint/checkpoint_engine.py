"""Checkpoint writers: the fast per-leaf writer over the C++ async I/O
library, and the decoupled (background-thread) wrapper.

Ports ``deepspeed_tpu/checkpoint/checkpoint_engine.py`` (``resolve_np_dtype``
:42, ``_flatten_with_paths`` :79, ``FastCheckpointEngine`` :110,
``DecoupledCheckpointEngine`` :165, ``get_checkpoint_engine`` :241). The
port writes JAX's ``writer="fast"`` layout whatever the writer's name:

    <dir>/manifest.json        {leaf name: {"shape", "dtype", "file"}}
    <dir>/<name with / → __>.bin   the leaf's raw bytes, C order

Leaf names are ``_flatten_with_paths``'s: dict keys (sorted, as JAX
flattens a dict) joined by ``/``; a dataclass field is ``.field`` (the
fp16 scaler's ``scaler/.scale``). Dtype names are numpy's (``float32``,
``bfloat16``, ``int32``); a 0-d leaf (``step``) is stored with shape
``[1]``, as JAX's writer stores it. No ``ml_dtypes``: a bf16 leaf's bytes
become a tensor by ``torch.frombuffer(..., dtype=torch.uint8).view(
torch.bfloat16)`` and a bf16 tensor its bytes by the reverse view. JAX's default writer,
orbax, needs JAX and tensorstore; the port reads and writes the per-leaf
layout only (``checkpoint/engine.py`` names the way across).
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.runtime.config_utils import logger

MANIFEST = "manifest.json"
Leaves = Iterable[Tuple[str, Any]]

# numpy's dtype names (JAX's manifest entries) ↔ torch dtypes
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def resolve_dtype(name: str) -> torch.dtype:
    """A manifest's dtype name → torch dtype (no ml_dtypes: ``bfloat16``
    resolves without numpy knowing it)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise TypeError(f"unresolvable checkpoint dtype {name!r} (not one "
                        f"of {sorted(_DTYPES)})") from None


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's numpy name, as JAX writes it in a manifest."""
    return _NAMES[dtype]


def flatten_with_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) of a nested dict in JAX's flatten order: dict keys
    sorted, a dataclass's fields in their order as ``.field``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_paths(tree[k], f"{prefix}{k}/")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from flatten_with_paths(getattr(tree, f.name),
                                          f"{prefix}.{f.name}/")
    else:
        yield prefix[:-1], tree


def to_host(leaf: Any, copy: bool = False) -> torch.Tensor:
    """A leaf (tensor on any device, numpy array, Python scalar) as a
    contiguous CPU tensor; ``copy`` forces a copy of a CPU tensor (an
    async save must not alias buffers the next step updates)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            return t.to("cpu").contiguous()
        return t.clone().contiguous() if copy else t.contiguous()
    return torch.from_numpy(np.array(leaf))


def leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU tensor's bytes, C order (uint8, 1-D)."""
    return t.reshape(-1).view(torch.uint8)


def leaf_from_bytes(raw: torch.Tensor, dtype: str, shape) -> torch.Tensor:
    """Raw uint8 bytes → a tensor of the manifest's dtype and shape."""
    return raw.view(resolve_dtype(dtype)).reshape(tuple(shape))


def leaf_file(name: str) -> str:
    return name.replace("/", "__") + ".bin"


class CheckpointEngine:
    """The writer interface (reference ``checkpoint_engine.py:21``)."""

    def save(self, leaves: Leaves, path: str, **kw) -> None:
        raise NotImplementedError

    def load(self, path: str) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def wait(self) -> None:
        """Block until queued saves are durable (the commit's analog)."""

    def close(self) -> None:
        self.wait()


class FastCheckpointEngine(CheckpointEngine):
    """The per-leaf writer over ``ops/aio.py``: each leaf's bytes handed to
    the C++ async writer, one leaf in flight while the next is gathered,
    so at most two leaves are held at once."""

    def __init__(self, n_threads: int = 4):
        from deepspeed_tpu_torch.ops.aio import AsyncIOHandle

        self.handle = AsyncIOHandle(n_threads=n_threads)

    def _finish(self, pending, retry: Optional[Callable]) -> None:
        raw, path, op = pending
        try:
            self.handle.wait(op)
        except OSError:
            if retry is None:
                raise
            retry(lambda: self.handle.sync_pwrite(raw, path), path)

    def save(self, leaves: Leaves, path: str,
             retry: Optional[Callable] = None,
             timings: Optional[Dict[str, float]] = None) -> None:
        """Write every leaf under ``path``; ``retry(fn, what)`` reruns a
        leaf's failed write. ``timings`` receives ``gather_s`` (producing
        the leaves: the engine's gathers and device→host copies),
        ``write_s`` and ``bytes``."""
        os.makedirs(path, exist_ok=True)
        manifest: Dict[str, Dict[str, Any]] = {}
        timings = {} if timings is None else timings
        pending = None
        it = iter(leaves)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            host = None if item is None else to_host(item[1])
            timings["gather_s"] = timings.get("gather_s", 0.0) \
                + time.perf_counter() - t0
            t0 = time.perf_counter()
            if pending is not None:
                self._finish(pending, retry)
                pending = None
            if item is not None:
                name = item[0]
                if host.dim() == 0:
                    # JAX's writer stores a 0-d leaf as [1] (its
                    # np.ascontiguousarray); the manifests stay equal
                    host = host.reshape(1)
                fname = leaf_file(name)
                manifest[name] = {"shape": list(host.shape),
                                  "dtype": dtype_name(host.dtype),
                                  "file": fname}
                full = os.path.join(path, fname)
                raw = leaf_bytes(host)
                timings["bytes"] = timings.get("bytes", 0) + raw.numel()
                if raw.numel():
                    pending = (raw, full, self.handle.async_pwrite(raw, full))
                else:
                    open(full, "wb").close()
            timings["write_s"] = timings.get("write_s", 0.0) \
                + time.perf_counter() - t0
            if item is None:
                break
        with open(os.path.join(path, MANIFEST), "w") as f:
            json.dump(manifest, f)

    def load(self, path: str) -> Dict[str, torch.Tensor]:
        reader = LeafReader(path, self.handle)
        return {name: reader[name] for name in reader.names}


class LeafReader:
    """The leaves of a per-leaf directory, each read when asked for (a
    loader holds one leaf at a time)."""

    def __init__(self, path: str, handle=None):
        self.path = path
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest: Dict[str, Dict[str, Any]] = json.load(f)
        self._handle = handle
        self.bytes_read = 0

    @property
    def names(self) -> List[str]:
        return list(self.manifest)

    def __contains__(self, name: str) -> bool:
        return name in self.manifest

    def __getitem__(self, name: str) -> torch.Tensor:
        info = self.manifest[name]
        dtype = resolve_dtype(info["dtype"])
        n = int(np.prod(info["shape"], dtype=np.int64))
        nbytes = n * torch.empty((), dtype=dtype).element_size()
        full = os.path.join(self.path, info["file"])
        size = os.path.getsize(full)
        if size != nbytes:
            raise ValueError(f"checkpoint leaf {name!r}: {size} bytes on "
                             f"disk, {nbytes} expected ({info})")
        raw = torch.empty(nbytes, dtype=torch.uint8)
        if nbytes:
            if self._handle is None:
                from deepspeed_tpu_torch.ops.aio import AsyncIOHandle

                self._handle = AsyncIOHandle(n_threads=4)
            self._handle.sync_pread(raw, full)
        self.bytes_read += nbytes
        return leaf_from_bytes(raw, info["dtype"], info["shape"])

    def get(self, name: str) -> Optional[torch.Tensor]:
        return self[name] if name in self.manifest else None


def snapshot(leaves: Leaves) -> List[Tuple[str, torch.Tensor]]:
    """Every leaf copied to host memory now (an async save returns after
    this: the flat buffers are updated in place by the next step)."""
    return [(name, to_host(leaf, copy=True)) for name, leaf in leaves]


class DecoupledCheckpointEngine(CheckpointEngine):
    """Async wrapper: ``save`` snapshots the leaves to host and enqueues;
    a daemon thread drains the queue through the inner writer (reference
    ``DecoupledCheckpointEngine``, a writer process there, a thread
    here)."""

    def __init__(self, inner: Optional[CheckpointEngine] = None,
                 max_queue: int = 2):
        self.inner = inner or FastCheckpointEngine()
        self.queue: "queue.Queue[Optional[Tuple[Any, str]]]" = \
            queue.Queue(maxsize=max_queue)
        self._err_lock = threading.Lock()
        self._err: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="dstpu-ckpt-decoupled")
        self._thread.start()

    def _drain(self):
        while True:
            item = self.queue.get()
            if item is None:
                self.queue.task_done()
                return
            leaves, path = item
            try:
                self.inner.save(leaves, path)
                self.inner.wait()
            except BaseException as e:  # surfaced on the next wait()
                with self._err_lock:
                    self._err = e
            finally:
                self.queue.task_done()

    def save(self, leaves: Leaves, path: str, **kw) -> None:
        self.queue.put((snapshot(leaves), path))

    def wait(self) -> None:
        self.queue.join()
        with self._err_lock:
            err, self._err = self._err, None
        if err is not None:
            raise err

    def load(self, path: str) -> Dict[str, torch.Tensor]:
        self.wait()
        return self.inner.load(path)

    def close(self) -> None:
        # best-effort: close runs on teardown paths, often while another
        # error propagates; a failed queued save must not mask it, and the
        # drain thread must still be joined. Idempotent.
        if self._closed:
            return
        self._closed = True
        try:
            self.wait()
        except Exception as e:     # not BaseException: Ctrl-C still stops it
            telemetry.counter(
                "checkpoint_close_errors_total",
                "save errors swallowed by best-effort engine close"
            ).inc(error=type(e).__name__)
            logger.warning(
                f"DecoupledCheckpointEngine.close: queued save had failed "
                f"({type(e).__name__}: {e}) — teardown continues")
        self.queue.put(None)
        self._thread.join(timeout=10)


def get_checkpoint_engine(name: str, **kw) -> CheckpointEngine:
    """``orbax`` (JAX's default), ``torch``, ``default`` and ``fast`` all
    write the per-leaf layout here; ``decoupled`` wraps it in a thread."""
    name = (name or "orbax").lower()
    if name in ("orbax", "torch", "default", "fast"):
        return FastCheckpointEngine(**kw)
    if name == "decoupled":
        return DecoupledCheckpointEngine(**kw)
    raise ValueError(f"unknown checkpoint engine {name!r}; "
                     "supported: orbax | fast | decoupled")
