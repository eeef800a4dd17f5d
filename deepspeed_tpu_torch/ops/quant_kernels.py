"""Blockwise int8 quantize and fused dequant-reduce: the CUDA kernels'
wrappers and their plain PyTorch versions.

Ports ``deepspeed_tpu/ops/pallas/quantization.py`` — ``quantize_int8_blocks``
(:48, ``_quant_kernel`` :40) and ``dequant_reduce`` (:89,
``_dequant_reduce_kernel`` :80) — to the hand-written kernels in
``ops/csrc/quantization.cu``, with the same contracts, signatures and
``ValueError``\\ s:

* :func:`quantize_int8_blocks` ``(x [N], block)`` → ``(q int8 [N], scale
  fp32 [N / block])``: per block, scale = amax / 127 (1 where amax = 0),
  q = clip(round-half-even(x / scale), -127, 127);
* :func:`dequant_reduce` ``(q int8 [W, C], scales fp32 [W, C / block])`` →
  fp32 [C] = Σ_w q[w]·scale[w], summed in w order, ÷ W when ``mean``.

One deviation from the JAX package, in the kernels and the plain versions
alike: a block whose amax is NaN gets a NaN scale, so it dequantizes to NaN
and the overflow skip sees it. The JAX quantizer gives such a block scale 1
(``NaN > 0`` is false) and drops the NaN. Everywhere else the port gives
JAX's bits (a block holding inf: scale inf, q 0).

Each wrapper runs its plain version (:func:`quantize_int8_blocks_ref`,
:func:`dequant_reduce_ref`) for tensors on the CPU and launches its kernel
for tensors on a CUDA device — or raises; it never falls back.
``launches["quant_int8"]`` / ``launches["dequant_reduce"]`` count kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.accelerator import on_device
from deepspeed_tpu_torch.ops import build

DEFAULT_BLOCK = 2048
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches: Dict[str, int] = {"quant_int8": 0, "dequant_reduce": 0}


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #

def quantize_int8_blocks_ref(x: torch.Tensor, block: int = DEFAULT_BLOCK
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in whole-tensor PyTorch: fp32 throughout, a
    true division by a tensor (CUDA divides by a Python scalar through its
    reciprocal), ``torch.round`` (half to even), and a NaN quotient made
    0 explicitly rather than left to a cast."""
    xb = x.reshape(-1, block).float()
    amax = xb.abs().amax(dim=1, keepdim=True)          # propagates NaN
    scale = torch.where(amax > 0, amax / torch.tensor(127.0, device=x.device),
                        torch.ones_like(amax))
    scale = torch.where(torch.isnan(amax), amax, scale)
    r = torch.round(xb / scale)
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r.clamp(-127, 127))
    return r.to(torch.int8).reshape(-1), scale[:, 0]


def dequant_reduce_ref(q: torch.Tensor, scales: torch.Tensor,
                       block: int = DEFAULT_BLOCK, mean: bool = False,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_w q[w]·scale[w] with one rounded fp32 product and one rounded sum
    per rank, in w order from 0; ÷ W by a true division when ``mean``."""
    W, C = q.shape
    acc = torch.zeros(C // block, block, dtype=torch.float32, device=q.device)
    for w in range(W):
        acc = acc + q[w].reshape(-1, block).float() * scales[w][:, None]
    if mean:
        acc = acc / torch.tensor(float(W), device=q.device)
    acc = acc.reshape(-1)
    if out is None:
        return acc
    out.view(-1).copy_(acc)
    return out


# --------------------------------------------------------------------------- #
# the kernels
# --------------------------------------------------------------------------- #

_fns: Dict[str, object] = {}        # the bound C entry points, set at first use


def _bind(name: str):
    if name not in _fns:
        lib = build.load("quantization")
        if name == "quant":
            fn = lib.dstpu_quantize_int8_blocks
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] \
                + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        else:
            fn = lib.dstpu_dequant_reduce
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                   ctypes.c_int64] \
                + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _device_of(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def quantize_int8_blocks(x: torch.Tensor, block: int = DEFAULT_BLOCK
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization of a flat tensor.

    → (q int8 [N], scale fp32 [N/block]); ``block`` must divide N. Same
    contract as :func:`deepspeed_tpu_torch.ops.quantization.quantize_int8`.
    The plain version on the CPU, the CUDA kernel on a GPU (fp32 or bf16
    input)."""
    N = x.shape[0]
    if N % block:
        raise ValueError(f"size {N} must be a multiple of block={block}")
    if _device_of("quantize_int8_blocks", x) == "cpu":
        return quantize_int8_blocks_ref(x, block)
    if x.dtype not in _DTYPES or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("quantize_int8_blocks: the kernel takes a "
                         "contiguous 1-D float32 or bfloat16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if N // block >= 2 ** 31:
        raise ValueError(f"quantize_int8_blocks: {N // block} blocks "
                         "exceed the grid")
    q = torch.empty(N, dtype=torch.int8, device=x.device)
    s = torch.empty(N // block, dtype=torch.float32, device=x.device)
    vec = int(block % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0)
    fn = _bind("quant")
    with on_device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), N, block,
                 _DTYPES[x.dtype], vec,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantize_int8_blocks kernel launch failed: "
                           f"cudaError {err}")
    launches["quant_int8"] += 1
    return q, s


def dequant_reduce(q: torch.Tensor, scales: torch.Tensor,
                   block: int = DEFAULT_BLOCK, mean: bool = False,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum W ranks' int8 contributions without materializing fp32 copies.

    q: int8 [W, C] (rank-major, C % block == 0); scales: fp32 [W, C/block].
    → fp32 [C] = Σ_w dequant(q[w]), written into ``out`` when given (a
    contiguous fp32 [C] on q's device; the port's addition, so a caller
    reuses a buffer). The plain version on the CPU, the CUDA kernel on a
    GPU."""
    W, C = q.shape
    if C % block:
        raise ValueError(f"chunk {C} must be a multiple of block={block}")
    if _device_of("dequant_reduce", q) == "cpu":
        return dequant_reduce_ref(q, scales, block, mean, out)
    if q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError("dequant_reduce: q must be a contiguous int8 "
                         f"tensor, got {q.dtype}")
    if scales.device != q.device or scales.dtype != torch.float32 \
            or not scales.is_contiguous() \
            or tuple(scales.shape) != (W, C // block):
        raise ValueError("dequant_reduce: scales must be a contiguous "
                         f"float32 [{W}, {C // block}] tensor on {q.device}, "
                         f"got {scales.dtype} {tuple(scales.shape)} on "
                         f"{scales.device}")
    if out is None:
        out = torch.empty(C, dtype=torch.float32, device=q.device)
    elif out.device != q.device or out.dtype != torch.float32 \
            or not out.is_contiguous() or out.numel() != C:
        raise ValueError(f"dequant_reduce: out must be a contiguous float32 "
                         f"tensor of {C} elements on {q.device}")
    vec = int(C % 4 == 0 and block % 4 == 0 and q.data_ptr() % 4 == 0
              and out.data_ptr() % 16 == 0)
    fn = _bind("dequant")
    with on_device(q.device):
        err = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), W, C,
                 block, int(bool(mean)), vec,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"dequant_reduce kernel launch failed: "
                           f"cudaError {err}")
    launches["dequant_reduce"] += 1
    return out
