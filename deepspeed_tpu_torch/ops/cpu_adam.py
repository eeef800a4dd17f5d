"""The host Adam of the host-executed step: the binding of ``csrc/cpu_adam.cpp``.

Ports the CPU-compiled update of ``deepspeed_tpu/runtime/host_step.py``
(``_build_update`` :160-191, one ``jax.jit`` program for the CPU backend:
the gas division, the global norm, the clip, Adam and the bf16 cast fused
into vectorised loops) to a C++ library that ``ops/build.py`` builds with
``g++ -O3 -march=native -ffp-contract=off`` at first use
(:func:`~deepspeed_tpu_torch.ops.build.load_host`). Two calls over flat
fp32 host buffers, in the step's order:

* :func:`grad_prep` — g divided by the gas scale in place, and the sum of
  squares of the result from per-block fp32 partials over a fixed
  partition (1,048,576-element blocks) added in block order: the same
  bits at any thread count;
* :func:`adam` — the clip factor, then Adam / AdamW in
  ``fused_adam_ref``'s arithmetic order, p, m, v in place and the bf16
  copy of the new p into ``out``.

Both take ``threads`` (default ``torch.get_num_threads()``). Inputs are
checked (dtype, device, contiguity, size, alignment; ``ValueError``
otherwise), and a failed build raises
:class:`~deepspeed_tpu_torch.ops.build.KernelBuildError`: nothing falls
back to the eager update. ``calls`` counts the library's calls.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import build

calls: Dict[str, int] = {"host_grad_prep": 0, "host_adam": 0}

_lib = None
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load_host("cpu_adam")
            lib.dstpu_host_grad_prep.restype = ctypes.c_double
            lib.dstpu_host_grad_prep.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_int]
            lib.dstpu_host_norm_block.restype = ctypes.c_int64
            lib.dstpu_host_norm_block.argtypes = []
            lib.dstpu_host_adam.restype = ctypes.c_int
            lib.dstpu_host_adam.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int64]
                + [ctypes.c_float] * 9
                + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int])
            _lib = lib
    return _lib


def norm_block() -> int:
    """Elements a partial of the norm's sum of squares covers."""
    return int(_load().dstpu_host_norm_block())


def _threads(threads: Optional[int]) -> int:
    return max(1, int(torch.get_num_threads() if threads is None
                      else threads))


def _check(name: str, t: torch.Tensor, n: int,
           dtype: torch.dtype = torch.float32, align: int = 16) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu":
        raise ValueError(f"cpu_adam: {name} must be a CPU tensor")
    if t.dtype != dtype or not t.is_contiguous() or t.numel() != n:
        raise ValueError(f"cpu_adam: {name} must be a contiguous {dtype} "
                         f"tensor of {n} elements, got {t.dtype} "
                         f"{tuple(t.shape)} contiguous={t.is_contiguous()}")
    if t.data_ptr() % align:
        raise ValueError(f"cpu_adam: {name} must be {align}-byte aligned")


def grad_prep(g: torch.Tensor, gas_scale: float,
              threads: Optional[int] = None) -> Tuple[float, np.ndarray]:
    """``g /= gas_scale`` in place (fp32 true division) → (the sum of
    squares of the divided g, in double from the fp32 partials, and the
    partials)."""
    n = g.numel()
    _check("g", g, n)
    lib = _load()
    partials = np.zeros(max(1, -(-n // norm_block())), np.float32)
    total = lib.dstpu_host_grad_prep(g.data_ptr(), n, float(gas_scale),
                                     partials.ctypes.data, _threads(threads))
    calls["host_grad_prep"] += 1
    return float(total), partials


def global_norm(sum_sq: float) -> torch.Tensor:
    """The global norm from :func:`grad_prep`'s sum (an fp32 0-dim
    tensor)."""
    return torch.tensor(np.float32(math.sqrt(sum_sq)), dtype=torch.float32)


def clip_factor(norm: torch.Tensor, clip: float) -> float:
    """``min(clip / (norm + 1e-6), 1)`` in fp32, as
    ``runtime/loss_scaler.clip_by_global_norm`` computes it."""
    return float(torch.clamp(clip / (norm + 1e-6), max=1.0))


def adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
         lr: float, betas: Tuple[float, float], eps: float,
         weight_decay: float, bc1: float, bc2: float, adam_w: bool = True,
         out: Optional[torch.Tensor] = None, clip: Optional[float] = None,
         threads: Optional[int] = None) -> None:
    """One Adam / AdamW step on flat fp32 host buffers, in place; ``g`` is
    read only (multiplied by ``clip`` first when given); ``out`` (bf16,
    optional) receives the new p rounded to nearest even."""
    n = p.numel()
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        _check(name, t, n)
    if out is not None:
        _check("out", out, n, torch.bfloat16, 8)
    b1, b2 = betas
    _load().dstpu_host_adam(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        out.data_ptr() if out is not None else None, n, lr, b1, 1.0 - b1,
        b2, 1.0 - b2, eps, weight_decay, bc1, bc2, int(bool(adam_w)),
        1.0 if clip is None else float(clip), int(clip is not None),
        _threads(threads))
    calls["host_adam"] += 1
