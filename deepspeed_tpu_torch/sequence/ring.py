"""Ring attention: blockwise causal attention with K/V passed around the
``seq`` ranks.

Ports ``deepspeed_tpu/sequence/ring.py`` (``_ring_local`` :34,
``ring_attention`` :75). Every rank keeps its query shard [B, S/sp, N, D]
and sends its K/V shard to the next rank of the ``seq`` group, sp − 1
times, accumulating JAX's online softmax in fp32; the shard held at step
i came from rank ``(idx − i) mod sp``, so step 0 is the diagonal block
(every causal row sees a key there before any fully masked block). The
causal mask is taken at global positions, ``idx·S + arange(S)``. GQA heads
are repeated locally; the output is cast to q's dtype.

The hop is ``comm.permute_autograd`` (JAX's ``lax.ppermute``, whose
backward sends the gradient back the other way) on the attentions' own
``seq`` group, so autograd carries dK/dV back to the shard's owner. JAX's
loop permutes after its last step too; that last hop's value is never
read, and here it is not sent. Under remat ``full`` the recompute repeats
the hops in the same order on every rank.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.mesh import MeshManager, get_mesh_manager

_NEG = -1e30


def _ring_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, group, sp: int, idx: int) -> torch.Tensor:
    """One rank's ring loop; q/k/v: [B, S/sp, N|K, D] local shards."""
    B, S, N, D = q.shape
    K = k.shape[2]
    if K != N:
        k = k.repeat_interleave(N // K, dim=2)
        v = v.repeat_interleave(N // K, dim=2)
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    q_pos = idx * S + torch.arange(S, device=q.device)
    o = torch.zeros(B, S, N, D, dtype=torch.float32, device=q.device)
    m = torch.full((B, N, S), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, N, S, dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for i in range(sp):
        src = (idx - i) % sp      # the global shard kc / vc hold
        scores = torch.einsum("bsnd,btnd->bnst", qf, kc.float()) * scale
        if causal:
            k_pos = src * S + torch.arange(S, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(mask[None, None], scores,
                                 torch.full_like(scores, _NEG))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bnst,btnd->bsnd", p, vc.float())
        m = m_new
        if i < sp - 1:
            kc = comm.permute_autograd(kc, group)
            vc = comm.permute_autograd(vc, group)
    o = o / l.clamp(min=1e-30).transpose(1, 2)[..., None]
    return o.to(q.dtype)


def ring_attention(mesh: Optional[MeshManager] = None,
                   axis_name: str = "seq") -> Callable:
    """Attention fn (the model's ``attention="ring"``) running a K/V ring
    over ``seq``; the plain attention at ``sp = 1``."""

    def attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool = True, segment_mask=None) -> torch.Tensor:
        if segment_mask is not None:
            raise NotImplementedError(
                "segment_mask not supported in ring attention")
        m = mesh or get_mesh_manager()
        sp = m.axis_size(axis_name)
        if sp <= 1:
            from deepspeed_tpu_torch.models.transformer import (
                dot_product_attention,
            )

            return dot_product_attention(q, k, v, causal=causal)
        return _ring_local(q, k, v, causal=causal, group=m.seq_group(),
                           sp=sp, idx=m.coords[axis_name])

    return attn
