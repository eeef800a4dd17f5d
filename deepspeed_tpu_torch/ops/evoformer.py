"""Evoformer (biased) attention: the CUDA forward kernel's wrapper, its plain
PyTorch version, and the differentiable ``evoformer_flash``.

Ports ``deepspeed_tpu/ops/pallas/evoformer.py`` — ``_evo_fwd_kernel``
behind the ``jax.custom_vjp`` ``evoformer_flash`` — to the hand-written
``ops/csrc/evoformer.cu`` behind one ``torch.autograd.Function``. Its
backward is, as in JAX, the gradient of the plain ``_reference`` recomputed
from the saved inputs (JAX: ``jax.vjp`` of ``_reference``); it includes the
bias gradient, summed over G for a row-shared bias (Gb = 1).

Layouts are the JAX package's: q/k/v [G, S, N, D], bias [Gb, N, S, S] with
Gb in {1, G}; the kernel reads q/k/v through their strides, masks the
ragged edge itself, and reads a row-shared bias tile by tile without
expanding it. :func:`evoformer_fwd` runs :func:`evoformer_flash_ref` for
tensors on the CPU and launches the kernel for tensors on a CUDA device —
or raises; it never falls back. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from deepspeed_tpu_torch.accelerator import on_device
from deepspeed_tpu_torch.ops import build

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches: Dict[str, int] = {"evoformer_fwd": 0}


def _scale(D: int) -> float:
    return 1.0 / math.sqrt(D)


def evoformer_flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """The Pallas kernel's fp32 arithmetic as whole tensors: s = q kᵀ ·
    scale + bias, m = max(-1e30, rowmax s), o = Σ exp(s - m) v /
    max(Σ exp(s - m), 1e-30), in q's dtype. q/k/v [G, S, N, D], bias
    [Gb, N, S, S] (Gb = 1 broadcast over G)."""
    s = torch.einsum("gqnd,gknd->gnqk", q.float(), k.float()) \
        * _scale(q.shape[-1])
    s = s + bias.float()
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("gnqk,gknd->gnqd", p, v.float()) / l
    return o.transpose(1, 2).to(q.dtype)


def _reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """JAX ``_reference``: scores in q's dtype cast to fp32, softmax in
    fp32, p cast back to q's dtype before P V."""
    s = torch.einsum("gqnd,gknd->gnqk", q, k).float() * _scale(q.shape[-1])
    s = s + bias.float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("gnqk,gknd->gqnd", p, v)


# --------------------------------------------------------------------------- #
# kernel wrapper
# --------------------------------------------------------------------------- #

_fns: Dict[str, object] = {}     # the bound C entry point, set at first launch


def _bind():
    fn = _fns.get("fwd")
    if fn is None:
        fn = build.load("evoformer").dstpu_evoformer_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_int64] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns["fwd"] = fn
    return fn


def _check(q, k, v, bias) -> None:
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"evoformer attention: want q/k/v [G, S, N, D] of "
                         f"one shape, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    G, S, N, D = q.shape
    if bias.dim() != 4 or tuple(bias.shape[1:]) != (N, S, S) \
            or bias.shape[0] not in (1, G):
        raise ValueError(f"evoformer attention: want bias [1 or {G}, {N}, "
                         f"{S}, {S}], got {tuple(bias.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"evoformer attention: head dim {D}; the kernel "
                         f"takes D in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or bias.dtype not in _DTYPES:
        raise TypeError(f"evoformer attention: q {q.dtype}, bias "
                        f"{bias.dtype}; the kernel takes float32 or bfloat16")
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"evoformer attention: {name} on {t.device}, q "
                             f"on {q.device}")
        if name != "bias" and t.dtype != q.dtype:
            raise TypeError(f"evoformer attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if name != "bias" and (
                t.stride(3) != 1 or any(t.stride(i) % align for i in range(3))
                or t.data_ptr() % 16):
            raise ValueError(
                f"evoformer attention: {name} must have a contiguous head "
                f"dim and 16-byte aligned rows (strides {tuple(t.stride())})")


def evoformer_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """o [G, S, N, D]: the plain version on the CPU, the CUDA kernel on a
    GPU."""
    if q.device.type == "cpu":
        return evoformer_flash_ref(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"evoformer_fwd: unsupported device {q.device}")
    _check(q, k, v, bias)
    bias = bias.contiguous()     # [Gb, N, S, S]; a row-shared bias stays Gb 1
    G, S, N, D = q.shape
    o = torch.empty(G, S, N, D, dtype=q.dtype, device=q.device)
    with on_device(q.device):
        err = _bind()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), G, S, N, D, bias.shape[0],
            *(t.stride(i) for t in (q, k, v) for i in range(3)), _scale(D),
            _DTYPES[q.dtype], _DTYPES[bias.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"evoformer_fwd kernel launch failed: cudaError "
                           f"{err}")
    launches["evoformer_fwd"] += 1
    return o


class _EvoFlash(torch.autograd.Function):
    """The ``jax.custom_vjp`` ``evoformer_flash``: the forward kernel; the
    backward differentiates ``_reference`` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return evoformer_fwd(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        want = [i for i, need in enumerate(ctx.needs_input_grad[:4]) if need]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(i in want)
                   for i, t in enumerate(saved)]
            out = _reference(*ins)
            got = torch.autograd.grad(out, [ins[i] for i in want], g)
        grads = [None] * 4
        for i, t in zip(want, got):
            grads[i] = t
        return tuple(grads)


def evoformer_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Flash-style biased attention. q/k/v: [G, S, N, D]; bias [Gb, N, S, S]
    with Gb in {1, G} (pass [1, N, S, S] to share the pair bias across MSA
    rows — it is read tile-wise, never expanded)."""
    return _EvoFlash.apply(q, k, v, bias)
