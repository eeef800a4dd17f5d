"""Blockwise int8 quantization and the compressed collectives of the
ZeRO++ and 1-bit wires.

Ports ``deepspeed_tpu/ops/quantization.py`` :40-223:

* :func:`quantize_int8` — the same function as the kernel wrapper
  ``ops/quant_kernels.quantize_int8_blocks``, and it is that wrapper: the
  CUDA kernel on a CUDA tensor, the plain version on the CPU;
* :func:`dequantize_int8` — ``dequant_reduce`` at W = 1 (q·scale is the
  sum of one rank's term), so the kernel on a CUDA tensor; and
  :func:`pad_to_block`;
* :func:`quantized_reduce_scatter` (:72) — the qgZ collective between
  processes: each rank passes its own contribution [N] and gets back its
  reduced chunk [N / world] (JAX: row r of a [world, N] array sharded over
  the mesh). Quantize, ``all_to_all`` the int8 blocks and their scales,
  dequant-reduce — the kernels on a CUDA tensor (JAX's ``use_pallas``);
  ``x`` itself at world 1, as in JAX;
* the 1-bit wire: :func:`pack_signs`, :func:`unpack_signs`,
  :func:`onebit_compress`, :func:`packed_sign_allreduce` and
  :func:`onebit_allreduce` (:138-223).

The group-wise weight quantization (:237-309) belongs to quantized serving,
a later slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.ops.quant_kernels import (
    DEFAULT_BLOCK,
    dequant_reduce,
    quantize_int8_blocks,
)

quantize_int8 = quantize_int8_blocks


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """int8 [N], fp32 [N/block] → fp32 [N] = q·scale per block."""
    return dequant_reduce(q.reshape(1, -1), scale.reshape(1, -1), block)


def pad_to_block(x: torch.Tensor, block: int = DEFAULT_BLOCK
                 ) -> Tuple[torch.Tensor, int]:
    pad = (-x.shape[0]) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x, pad


# --------------------------------------------------------------------------- #
# quantized reduce-scatter (qgZ)
# --------------------------------------------------------------------------- #

def quantized_reduce_scatter(x: torch.Tensor, group=None,
                             block: int = DEFAULT_BLOCK,
                             mean: bool = True) -> torch.Tensor:
    """Reduce-scatter the ranks' contributions with int8 transport.

    ``x``: this rank's contribution [N]. Returns this rank's chunk [N/world]
    of the reduction (÷ world when ``mean``), accumulated in fp32. Wire
    bytes per rank: N int8 + N/block fp32 scales, against 4 N for fp32."""
    world = comm.get_world_size(group)
    if world <= 1:
        return x
    N = x.shape[-1]
    if N % (world * block):
        raise ValueError(f"size {N} must divide world*block={world * block}")
    chunk = N // world
    q, s = quantize_int8(x.reshape(-1), block)
    q = comm.all_to_all_single(q.view(world, chunk), group)
    s = comm.all_to_all_single(s.view(world, chunk // block), group)
    return dequant_reduce(q, s, block, mean=mean)


# --------------------------------------------------------------------------- #
# 1-bit (sign) allreduce with error feedback — packed wire format
# --------------------------------------------------------------------------- #

_BIT_WEIGHTS = [1 << i for i in range(8)]


def pack_signs(sign: torch.Tensor) -> torch.Tensor:
    """bool [N] (N % 8 == 0) → uint8 [N/8] bitmask, bit i of byte j =
    sign[8 j + i]."""
    bits = sign.reshape(-1, 8).to(torch.uint8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8,
                           device=sign.device)
    return (bits * weights).sum(dim=1, dtype=torch.uint8)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [M] → ±1.0 fp32 [M*8]."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts) & 1
    one = torch.ones((), dtype=torch.float32, device=packed.device)
    return torch.where(bits.bool(), one, -one).reshape(-1)


def onebit_compress(x: torch.Tensor, error: torch.Tensor,
                    block: int = DEFAULT_BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-compensated sign compression: corrected = x + error; sent =
    sign · mean|corrected| per block; new_error = corrected − sent."""
    corrected = x.float() + error
    cb = corrected.reshape(-1, block)
    scale = cb.abs().mean(dim=1)
    sign = cb >= 0
    one = torch.ones((), dtype=torch.float32, device=x.device)
    sent = torch.where(sign, one, -one) * scale[:, None]
    return sign, scale, (cb - sent).reshape(-1)


def packed_sign_allreduce(x: torch.Tensor, error: torch.Tensor, group,
                          world: int, block: int = DEFAULT_BLOCK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean all-reduce of ``x`` with a 1-bit + per-block-scale wire and
    error feedback. x, error: fp32 [N] per rank (N % lcm(8, block) == 0).
    Returns (reduced [N], the same on every rank; new_error [N])."""
    nb = x.shape[0] // block
    sign, scale, new_error = onebit_compress(x, error, block)
    signs_all = comm.all_gather(pack_signs(sign.reshape(-1)), group,
                                tiled=False)                  # [world, N/8]
    scales_all = comm.all_gather(scale, group, tiled=False)   # [world, nb]
    reduced = torch.zeros(nb, block, dtype=torch.float32, device=x.device)
    for w in range(world):
        reduced = reduced + unpack_signs(signs_all[w]).reshape(nb, block) \
            * scales_all[w][:, None]
    reduced = reduced.reshape(-1) / torch.tensor(float(world),
                                                 device=x.device)
    return reduced, new_error


def onebit_allreduce(x: torch.Tensor, error: torch.Tensor, group=None,
                     block: int = DEFAULT_BLOCK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean all-reduce with a 1-bit payload, per-block scales and error
    feedback. ``x`` / ``error``: this rank's contribution and running
    compression error [N]. Returns (reduced [N] fp32, the same on every
    rank; this rank's new error [N])."""
    world = comm.get_world_size(group)
    N = x.shape[0]
    if N % block:
        raise ValueError(f"size {N} must be a multiple of block={block}")
    if world <= 1:
        return x.float() + error, torch.zeros_like(error)
    return packed_sign_allreduce(x, error, group, world, block)
