"""Ulysses sequence parallelism: all-to-all head-scatter / seq-gather
attention.

Ports ``deepspeed_tpu/sequence/ulysses.py``: ``ulysses_attention`` (:73)
and ``ulysses_attention_shard_map`` (:104) with its two all-to-alls
(``_a2a_scatter_heads`` :94, ``_a2a_gather_seq`` :99). In JAX the first is
GSPMD re-sharding and the second the explicit ``shard_map`` dataflow; both
compute the same function. Here every rank holds its own positions of q,
k and v, [B, S/sp, N, D] (rank r of the ``seq`` group positions
``[r·S/sp, (r+1)·S/sp)``), so both names run the explicit dataflow:

    [B, S/sp, N, D] --all-to-all--> [B, S, N/sp, D] --inner attention-->
    [B, S, N/sp, D] --all-to-all--> [B, S/sp, N, D]

Each all-to-all is ``comm.all_to_all_autograd`` on the attentions' own
``seq`` group (``MeshManager.seq_group``), whose backward is the same
exchange of the gradient. The inner attention sees whole sequences of
N/sp heads: the plain attention, or the CUDA flash kernels (the model's
``attention="ulysses_flash"``). With GQA at ``kv_heads % sp != 0`` the KV
heads are repeated up to ``sp`` first (JAX :124-130); query heads that
``sp`` does not divide raise JAX's ``ValueError``. At ``sp = 1`` the
attention is the inner one. JAX's GSPMD variant takes a ``segment_mask``
(its inner attention sees global shapes); the explicit dataflow does not,
so here both raise on one at ``sp > 1`` (the port's model never passes
one).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.mesh import MeshManager, get_mesh_manager


def _scatter_heads(x: torch.Tensor, group, sp: int) -> torch.Tensor:
    """[B, S/sp, N, D] → [B, S, N/sp, D]: head block j goes to rank j, the
    positions from rank j land at sequence block j (JAX's
    ``lax.all_to_all(split_axis=2, concat_axis=1, tiled=True)``)."""
    B, Sl, N, D = x.shape
    send = x.reshape(B, Sl, sp, N // sp, D).permute(2, 0, 1, 3, 4)
    recv = comm.all_to_all_autograd(send.contiguous(), group)
    return recv.permute(1, 0, 2, 3, 4).reshape(B, sp * Sl, N // sp, D)


def _gather_seq(x: torch.Tensor, group, sp: int) -> torch.Tensor:
    """[B, S, N/sp, D] → [B, S/sp, N, D], the inverse exchange."""
    B, S, Nl, D = x.shape
    send = x.reshape(B, sp, S // sp, Nl, D).permute(1, 0, 2, 3, 4)
    recv = comm.all_to_all_autograd(send.contiguous(), group)
    return recv.permute(1, 2, 0, 3, 4).reshape(B, S // sp, sp * Nl, D)


def _inner_or_default(inner: Optional[Callable]) -> Callable:
    if inner is not None:
        return inner
    from deepspeed_tpu_torch.models.transformer import dot_product_attention

    return dot_product_attention


def ulysses_attention_shard_map(inner: Optional[Callable] = None,
                                mesh: Optional[MeshManager] = None,
                                axis_name: str = "seq") -> Callable:
    """The explicit all-to-all Ulysses (``_SeqAllToAll`` parity) around
    ``inner`` (default: the plain attention); ``mesh`` defaults to the
    installed one, read at each call."""
    inner = _inner_or_default(inner)

    def attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool = True, segment_mask=None) -> torch.Tensor:
        m = mesh or get_mesh_manager()
        sp = m.axis_size(axis_name)
        if sp <= 1:
            if segment_mask is not None:
                return inner(q, k, v, causal=causal,
                             segment_mask=segment_mask)
            return inner(q, k, v, causal=causal)
        if segment_mask is not None:
            raise NotImplementedError(
                "segment_mask not supported in shard_map ulysses")
        if q.shape[2] % sp != 0:
            raise ValueError(f"num_heads {q.shape[2]} not divisible by "
                             f"sp={sp}")
        kv = k.shape[2]
        if kv % sp != 0:   # GQA with kv_heads < sp: repeat up to sp heads
            rep = -(-sp // kv)
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        group = m.seq_group()
        og = inner(_scatter_heads(q, group, sp), _scatter_heads(k, group, sp),
                   _scatter_heads(v, group, sp), causal=causal)
        return _gather_seq(og, group, sp)

    return attn


def ulysses_attention(inner: Optional[Callable] = None,
                      mesh: Optional[MeshManager] = None) -> Callable:
    """Ulysses around ``inner``: JAX's GSPMD re-sharding, the same
    function as :func:`ulysses_attention_shard_map`, which it runs."""
    return ulysses_attention_shard_map(inner, mesh)
