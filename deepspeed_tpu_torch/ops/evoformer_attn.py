"""Evoformer attention (DeepSpeed4Science / AlphaFold-family models).

Ports ``deepspeed_tpu/ops/evoformer_attn.py``: ``evoformer_attention`` (the
``DS4Sci_EvoformerAttention`` analog: attention over MSA/pair
representations with additive biases and a sigmoid gate) and
``msa_row_attention_with_pair_bias``. Shapes follow the reference API:
inputs ``[*, seq, heads, dim]`` with biases broadcastable to
``[*, heads, seq_q, seq_k]``.

``use_flash`` None (auto) takes the CUDA kernel (``ops/evoformer.py``) for
tensors on a GPU whose shapes fit its contract, and the plain path for
tensors on the CPU — where JAX asks whether it runs on a TPU. The gate
stays outside the kernel, as in JAX.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from deepspeed_tpu_torch.ops.evoformer import HEAD_DIMS, evoformer_flash


def _flash_dispatch(q, k, v, biases):
    """The kernel path: flatten leading dims to one G axis and combine the
    biases into a single [1 or G, N, S, S] tensor. Returns None when the
    shapes don't reduce to the kernel's contract (square attention, D in
    ``HEAD_DIMS``); the caller then takes the plain path."""
    if q.shape != k.shape or k.shape != v.shape:
        return None    # rectangular attention → plain path
    *lead, S, N, D = q.shape
    if D not in HEAD_DIMS:
        return None
    G = math.prod(lead)
    try:
        combined = None
        for b in biases:
            if b is None:
                continue
            combined = b if combined is None else combined + b
        if combined is None:
            combined = torch.zeros((1, N, S, S), dtype=torch.float32,
                                   device=q.device)
        # normalize to exactly [*, N, S, S] (right-aligned broadcast)
        combined = torch.broadcast_to(
            combined, torch.broadcast_shapes(combined.shape, (1, N, S, S)))
        blead = combined.shape[:-3]
        if all(d == 1 for d in blead):
            # row-shared bias: keep Gb=1 — the kernel reads it tile-wise,
            # never expand it G-fold in memory
            bias4 = combined.reshape(1, N, S, S)
        else:
            full = torch.broadcast_to(combined, (*lead, N, S, S))
            if tuple(full.shape[:-3]) != tuple(lead):
                return None
            bias4 = full.reshape(G, N, S, S)
    except (ValueError, TypeError, RuntimeError):
        return None

    out = evoformer_flash(q.reshape(G, S, N, D), k.reshape(G, S, N, D),
                          v.reshape(G, S, N, D), bias4)
    return out.reshape(*lead, S, N, D)


def evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        biases: Sequence[Optional[torch.Tensor]] = (),
                        gate: Optional[torch.Tensor] = None,
                        use_flash: Optional[bool] = None) -> torch.Tensor:
    """DS4Sci_EvoformerAttention analog.

    q/k/v: [..., S, N, D] (arbitrary leading batch dims — MSA rows/cols);
    biases: each broadcastable to [..., N, S_q, S_k] (e.g. mask bias
    [..., 1, 1, S_k] and pair bias [..., N, S_q, S_k]); gate: optional
    [..., S, N, D] sigmoid gate. fp32 softmax; output in q's dtype.

    ``use_flash``: None (auto) takes the CUDA kernel for GPU tensors whose
    shapes fit its contract (square attention, D in 8/16/32/64/128) and the
    plain path otherwise; True forces the kernel path (its plain version on
    the CPU) and raises ``ValueError`` on shapes outside the contract;
    False takes the plain path.
    """
    forced = use_flash is True
    if use_flash is None:
        use_flash = q.device.type == "cuda"
    if use_flash and q.dim() >= 3:
        out = _flash_dispatch(q, k, v, biases)
        if out is not None:
            if gate is not None:
                out = out * torch.sigmoid(gate.to(out.dtype))
            return out
        if forced:
            raise ValueError("shapes do not fit the flash evoformer "
                             "kernel; pass use_flash=False")
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("...qnd,...knd->...nqk", q, k).float()
    scores = scores * scale
    for b in biases:
        if b is not None:
            scores = scores + b.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("...nqk,...knd->...qnd", probs, v)
    if gate is not None:
        out = out * torch.sigmoid(gate.to(out.dtype))
    return out


def msa_row_attention_with_pair_bias(msa: torch.Tensor,
                                     pair_bias: torch.Tensor, wq, wk, wv, wo,
                                     w_gate=None, num_heads: int = 8,
                                     use_flash: Optional[bool] = None
                                     ) -> torch.Tensor:
    """MSA row-wise gated self-attention with pair bias (Evoformer block
    building block; reference evoformer examples).

    msa: [rows, S, C]; pair_bias: [N, S, S] (from the pair representation);
    projections are [C, N*D] / [N*D, C]."""
    R, S, C = msa.shape
    D = wq.shape[-1] // num_heads

    def proj(w):
        return (msa @ w).reshape(R, S, num_heads, D)

    q, k, v = proj(wq), proj(wk), proj(wv)
    gate = proj(w_gate) if w_gate is not None else None
    out = evoformer_attention(q, k, v, biases=(pair_bias[None],), gate=gate,
                              use_flash=use_flash)
    return out.reshape(R, S, num_heads * D) @ wo
