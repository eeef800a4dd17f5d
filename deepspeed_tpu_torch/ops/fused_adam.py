"""Fused Adam: the CUDA kernel's wrapper and its plain PyTorch version.

Ports ``deepspeed_tpu/ops/pallas/fused_adam.py`` (``_adam_kernel`` via
``fused_adam_flat``) to the hand-written CUDA kernel in
``ops/csrc/fused_adam.cu``: one pass over flat fp32 buffers that updates
p, m and v in place from g, Adam or AdamW with bias correction, in the
arithmetic order of the JAX engine's ``FusedAdam.update``.

:func:`fused_adam` runs :func:`fused_adam_ref` for tensors on the CPU and
launches the kernel for tensors on a CUDA device — or raises; it never falls
back. ``launches["fused_adam"]`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import on_device
from deepspeed_tpu_torch.ops import build

launches: Dict[str, int] = {"fused_adam": 0}
#: elements a chunk of the plain version over flat CPU buffers: its
#: temporaries a few MB, in cache, at any model size (on the H100
#: machine's host a quarter of this took 2.2 times as long: more per-op
#: overhead)
CHUNK = 1 << 20


def bias_corrections(step: int, betas: Tuple[float, float],
                     bias_correction: bool = True) -> Tuple[float, float]:
    """``1 - beta ** step`` in fp32, as the JAX update computes it from an
    fp32 step (``1.0 - b1 ** sf``)."""
    if not bias_correction:
        return 1.0, 1.0
    sf = np.float32(step)
    return tuple(float(np.float32(1.0) - np.float32(b) ** sf) for b in betas)


def fused_adam_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, lr: float, betas: Tuple[float, float],
                   eps: float, weight_decay: float, bc1: float, bc2: float,
                   adam_w: bool = True,
                   out: Optional[torch.Tensor] = None) -> None:
    """The kernel's function in plain PyTorch, one rounded fp32 operation
    at a time (no fused multiply-add), updating p, m, v in place and, when
    given, ``out`` with the compute-dtype copy of the new p; two scratch
    tensors the size of p. The bias corrections divide as tensors:
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal instead."""
    b1, b2 = betas
    g = g.float()
    if not adam_w and weight_decay:
        g = g + weight_decay * p
    t1, t2 = torch.empty_like(p), torch.empty_like(p)
    m.mul_(b1).add_(torch.mul(g, 1.0 - b1, out=t1))
    v.mul_(b2).add_(torch.mul(g, g, out=t2).mul_(1.0 - b2))
    bc1_t = torch.tensor(bc1, dtype=torch.float32, device=p.device)
    bc2_t = torch.tensor(bc2, dtype=torch.float32, device=p.device)
    torch.div(v, bc2_t, out=t2).sqrt_().add_(eps)
    upd = torch.div(m, bc1_t, out=t1).div_(t2)
    if adam_w and weight_decay:
        upd.add_(torch.mul(p, weight_decay, out=t2))
    p.sub_(upd.mul_(lr))
    if out is not None:
        out.copy_(p)


_fn = None          # the bound C entry point, set at the first launch


def _bind():
    global _fn
    if _fn is None:
        fn = build.load("fused_adam").dstpu_fused_adam
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] \
            + [ctypes.c_float] * 9 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(p, g, m, v, out) -> None:
    n = p.numel()
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.device != p.device:
            raise ValueError(f"fused_adam: {name} on {t.device}, p on "
                             f"{p.device}")
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.numel() != n:
            raise ValueError(f"fused_adam: {name} must be a contiguous "
                             f"float32 tensor of {n} elements, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_adam: {name} must be 16-byte aligned")
    if out is not None:
        if out.device != p.device or out.dtype != torch.bfloat16 \
                or not out.is_contiguous() or out.numel() != n \
                or out.data_ptr() % 8:
            raise ValueError("fused_adam: out must be a contiguous, 8-byte "
                             f"aligned bfloat16 tensor of {n} elements on "
                             f"{p.device}")


def fused_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, lr: float, betas: Tuple[float, float],
               eps: float, weight_decay: float, bc1: float, bc2: float,
               adam_w: bool = True,
               out: Optional[torch.Tensor] = None) -> None:
    """In-place Adam/AdamW step on flat fp32 p/m/v from fp32 g; ``out``
    (bf16, optional) receives the new p rounded to bf16. The plain version
    on the CPU, ``CHUNK`` elements of the flattened buffers at a time (an
    elementwise update: the same bits as one whole-tensor call, with no
    temporary the size of the buffers), the CUDA kernel on a GPU."""
    if p.device.type == "cpu":
        flat = [t.view(-1) for t in (p, g, m, v)]
        out = None if out is None else out.view(-1)
        for i in range(0, p.numel(), CHUNK):
            c = slice(i, i + CHUNK)
            fused_adam_ref(*(t[c] for t in flat), lr, betas, eps,
                           weight_decay, bc1, bc2, adam_w,
                           None if out is None else out[c])
        return
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam: unsupported device {p.device}")
    _check(p, g, m, v, out)
    b1, b2 = betas
    fn = _bind()
    with on_device(p.device):
        err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 out.data_ptr() if out is not None else None, p.numel(),
                 lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, bc1, bc2,
                 int(bool(adam_w)),
                 torch.cuda.current_stream(p.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_adam kernel launch failed: cudaError {err}")
    launches["fused_adam"] += 1
