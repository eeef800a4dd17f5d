"""Paged attention: the CUDA kernel's wrapper and its plain PyTorch version.

Ports ``deepspeed_tpu/ops/pallas/paged_attention.py`` (``_kernel`` via
``paged_attention``) to the hand-written CUDA kernel in
``ops/csrc/paged_attention.cu``. Shapes (the JAX package's): q [T, N, D];
kpool/vpool [NB, bs, K, D]; tables [T, MB] int32; lengths [T] int32 (context
length per token, pos+1). GQA: query head n reads kv head n // (N/K).

:func:`paged_attention` runs the plain version for a tensor on the CPU and
launches the kernel for a tensor on a CUDA device — or raises; it never falls
back. ``launches["paged_attention"]`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import on_device
from deepspeed_tpu_torch.ops import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_REP = 8

launches: Dict[str, int] = {"paged_attention": 0}


def paged_attention_reference(q: torch.Tensor, kpool: torch.Tensor,
                              vpool: torch.Tensor, tables: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """Gather + masked softmax (``deepspeed_tpu/models/paged.py:49``).

    Token t attends to its sequence's first ``lengths[t]`` cache slots. One
    intended difference from the JAX reference: a row of length 0 gives 0,
    as both kernels do (the JAX reference averages V over the masked row
    there; FastGen never produces such a row, lengths = pos + 1 >= 1)."""
    Tn, N, D = q.shape
    _, bs, K, _ = kpool.shape
    MB = tables.shape[1]
    idx = tables.long()
    kg = kpool[idx].reshape(Tn, MB * bs, K, D)           # [T, ctx, K, D]
    vg = vpool[idx].reshape(Tn, MB * bs, K, D)
    if K != N:
        kg = kg.repeat_interleave(N // K, dim=2)
        vg = vg.repeat_interleave(N // K, dim=2)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))   # fp32 1/sqrt(D)
    s = torch.einsum("tnd,tcnd->tnc", q.float(), kg.float()) * scale
    ctx = torch.arange(MB * bs, device=q.device)
    mask = ctx[None, None, :] < lengths.long()[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * (lengths > 0).float()[:, None, None]
    return torch.einsum("tnc,tcnd->tnd", p, vg.float()).to(q.dtype)


_fn = None          # the bound C entry point, set at the first launch


def _bind():
    global _fn
    if _fn is None:
        fn = build.load("paged_attention").dstpu_paged_attention
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, kpool, vpool, tables, lengths) -> None:
    dev = q.device
    for name, t in (("kpool", kpool), ("vpool", vpool), ("tables", tables),
                    ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on {dev}")
    if q.dim() != 3 or kpool.dim() != 4 or vpool.shape != kpool.shape:
        raise ValueError(
            f"paged_attention: want q [T, N, D] and pools [NB, bs, K, D], got "
            f"q {tuple(q.shape)}, kpool {tuple(kpool.shape)}, "
            f"vpool {tuple(vpool.shape)}")
    Tn, N, D = q.shape
    _, bs, K, D2 = kpool.shape
    if q.dtype not in _DTYPES or kpool.dtype != q.dtype \
            or vpool.dtype != q.dtype:
        raise TypeError(f"paged_attention: q/kpool/vpool must share one of "
                        f"float32/bfloat16, got {q.dtype}/{kpool.dtype}/"
                        f"{vpool.dtype}")
    if D != D2 or D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {D} (pool {D2}); the "
                         f"kernel takes D in {_HEAD_DIMS}")
    if N % K or N // K > _MAX_REP:
        raise ValueError(f"paged_attention: N={N} heads over K={K} kv heads; "
                         f"the kernel takes N/K integral and <= {_MAX_REP}")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != Tn or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (Tn,):
        raise ValueError(
            f"paged_attention: want tables [T, MB] int32 and lengths [T] "
            f"int32 with T={Tn}, got {tables.dtype} {tuple(tables.shape)} and "
            f"{lengths.dtype} {tuple(lengths.shape)}")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be 16-byte aligned")


def paged_attention(q: torch.Tensor, kpool: torch.Tensor, vpool: torch.Tensor,
                    tables: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Drop-in for :func:`paged_attention_reference`: the plain version on
    the CPU, the CUDA kernel on a GPU."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, kpool, vpool, tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check(q, kpool, vpool, tables, lengths)
    Tn, N, D = q.shape
    _, bs, K, _ = kpool.shape
    out = torch.empty_like(q)
    fn = _bind()
    # the C side launches on the calling thread's current device
    with on_device(q.device):
        err = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                 tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 Tn, N, K, D, bs, tables.shape[1], _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    launches["paged_attention"] += 1
    return out
