"""Tiled sequence compute: ALST's memory caps, and query-chunked / FPDT
attention.

Ports ``deepspeed_tpu/sequence/tiled.py``: ``sequence_tiled_compute``
(:37), ``tiled_lm_loss`` (:57), ``chunked_attention`` (:104) and
``fpdt_attention`` (:171). JAX scans the tiles with ``jax.checkpoint`` on
the tile body; here a Python loop runs the tiles and, under ``remat``,
``torch.utils.checkpoint`` wraps each tile's body, so the backward
recomputes one tile at a time. JAX's fallbacks stay: a length the chunks
do not divide takes plain (or chunked) attention.

``fpdt_attention``: JAX puts the chunked K/V in its accelerator's
``pinned_host`` memory and pulls one chunk into device memory at a time
(:151-168; off the TPU the constraint is the identity). Here, for CUDA
tensors with ``offload_kv``, K/V are copied into pinned host memory a
chunk each, and each chunk is copied to the card where it is used, the
next chunk's copy issued on a side stream while the current one computes.
The chunks' gradients stay on the card: each block's backward adds its
K/V gradient into a card buffer of its chunk, and the offload's backward
joins those into K's and V's gradients. For CPU tensors it is the identity, as JAX's is
off the TPU.

The LM loss of a ``seq`` rank (``tiled_lm_loss`` with ``seq_shard``): the
rank holds the hidden states of positions ``[idx·S_l, (idx+1)·S_l)`` and
the whole rows' tokens; its targets are the next tokens of those
positions, the last rank's last position having none (JAX's global
``hidden[:, :-1]`` against ``tokens[:, 1:]``).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

_NEG = -1e30


def _ckpt(fn: Callable, remat: bool, *args):
    if not remat:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def sequence_tiled_compute(fn: Callable[[torch.Tensor], torch.Tensor],
                           x: torch.Tensor, num_tiles: int, axis: int = 1,
                           remat: bool = True) -> torch.Tensor:
    """Apply a position-wise ``fn`` over ``num_tiles`` tiles of ``axis``
    (the TiledMLP analog); a length the tiles do not divide raises JAX's
    ``ValueError``."""
    if num_tiles <= 1:
        return fn(x)
    S = x.shape[axis]
    if S % num_tiles != 0:
        raise ValueError(f"seq len {S} not divisible by num_tiles "
                         f"{num_tiles}")
    return torch.cat([_ckpt(fn, remat, t)
                      for t in x.split(S // num_tiles, dim=axis)], dim=axis)


def tiled_lm_loss(hidden: torch.Tensor, head: torch.Tensor,
                  tokens: torch.Tensor,
                  loss_mask: Optional[torch.Tensor] = None,
                  num_tiles: int = 8, remat: bool = True,
                  seq_shard: Optional[Tuple[int, int]] = None
                  ) -> torch.Tensor:
    """Next-token CE without materializing [B, S, V] logits
    (``TiledFusedLogitsLoss`` parity): hidden [B, S, H] (the final
    activations), head [H, V]; per tile fp32 logits (``head_matmul``),
    logsumexp and the picked logit, recomputed tile by tile in backward
    under ``remat``. The masked mean of the tiles' summed NLL; under
    ``seq_shard`` over this rank's positions (see the module doc)."""
    from deepspeed_tpu_torch.models.transformer import (
        head_matmul,
        loss_targets,
    )

    n, tgt, mask = loss_targets(tokens, loss_mask, seq_shard,
                                hidden.shape[1])
    hid = hidden[:, :n]
    pad = (-n) % num_tiles
    if pad:
        hid = torch.nn.functional.pad(hid, (0, 0, 0, pad))
        tgt = torch.nn.functional.pad(tgt, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    head_c = head.to(hidden.dtype)
    tile = (n + pad) // num_tiles

    def body(h, t, mk):
        logits = head_matmul(h, head_c)                  # [B, tile, V] fp32
        logz = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, t.long()[..., None])[..., 0]
        return ((logz - picked) * mk).sum()

    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    for i in range(num_tiles):
        sl = slice(i * tile, (i + 1) * tile)
        loss_sum = loss_sum + _ckpt(body, remat, hid[:, sl], tgt[:, sl],
                                    mask[:, sl])
    return loss_sum / torch.clamp(mask.sum(), min=1.0)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, segment_mask=None,
                      num_chunks: int = 4, remat: bool = True
                      ) -> torch.Tensor:
    """FPDT-style query-chunked attention: each query chunk against the
    whole K/V in fp32 (peak scores [B, N, S/chunks, S]), recomputed per
    chunk in backward under ``remat``; the plain attention where the
    chunks do not divide S."""
    if segment_mask is not None:
        raise NotImplementedError(
            "segment_mask unsupported in chunked attention")
    B, S, N, D = q.shape
    K = k.shape[2]
    if K != N:
        k = k.repeat_interleave(N // K, dim=2)
        v = v.repeat_interleave(N // K, dim=2)
    if num_chunks <= 1 or S % num_chunks != 0:
        from deepspeed_tpu_torch.models.transformer import (
            dot_product_attention,
        )

        return dot_product_attention(q, k, v, causal=causal)
    C = S // num_chunks
    scale = 1.0 / math.sqrt(D)
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(S, device=q.device)

    def body(qi, i):
        scores = torch.einsum("bcnd,btnd->bnct", qi.float(), kf) * scale
        if causal:
            q_pos = i * C + torch.arange(C, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
            scores = torch.where(mask[None, None], scores,
                                 torch.full_like(scores, _NEG))
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bnct,btnd->bcnd", probs, vf).to(q.dtype)

    return torch.cat([_ckpt(body, remat, qi, i)
                      for i, qi in enumerate(q.split(C, dim=1))], dim=1)


# --------------------------------------------------------------------------- #
# FPDT: K/V in pinned host memory, streamed to the card a chunk at a time
# --------------------------------------------------------------------------- #

class _Fetch:
    """One FPDT call's copies: the side stream that brings host chunks to
    the card, the event after the host chunks' writes, and K's and V's
    chunk gradients, summed on the card."""

    def __init__(self, device, n):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.ready: Optional[torch.cuda.Event] = None
        self.grads: List[List[Optional[torch.Tensor]]] = [[None] * n,
                                                          [None] * n]


class _Offload(torch.autograd.Function):
    """K and V [B, S, N, D] on the card → ``n`` pinned host chunks each
    (appended to ``out``, outside autograd) and an empty card tensor, the
    anchor every chunk's copy to the card hangs on; backward: the chunks'
    gradients that :class:`_ToDevice` summed on the card, joined."""

    @staticmethod
    def forward(ctx, k, v, n, fetch, out: List):
        ctx.fetch = fetch
        for x in (k, v):
            chunks = []
            for c in x.chunk(n, dim=1):
                h = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
                h.copy_(c, non_blocking=True)
                chunks.append(h)
            out.append(tuple(chunks))
        fetch.ready = torch.cuda.Event()
        fetch.ready.record()
        return k.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        dk, dv = (torch.cat(g, dim=1) for g in ctx.fetch.grads)
        ctx.fetch.grads = None
        return dk, dv, None, None, None


class _ToDevice(torch.autograd.Function):
    """Chunk ``j`` of K (``which`` 0) or V (1), a pinned host tensor → the
    card, copied on ``fetch``'s side stream after the host chunks' writes
    (its event appended to ``out_event``); backward: the chunk's gradient
    added into ``fetch.grads`` on the card (an empty one to the anchor)."""

    @staticmethod
    def forward(ctx, anchor, h, which, j, fetch, out_event: List):
        ctx.which, ctx.j, ctx.fetch = which, j, fetch
        s = fetch.stream
        s.wait_event(fetch.ready)
        with torch.cuda.stream(s):
            d = h.to(fetch.device, non_blocking=True)
        d.record_stream(torch.cuda.current_stream(fetch.device))
        ev = torch.cuda.Event()
        ev.record(s)
        out_event.append(ev)
        return d

    @staticmethod
    def backward(ctx, g):
        grads = ctx.fetch.grads[ctx.which]
        grads[ctx.j] = g if grads[ctx.j] is None else grads[ctx.j] + g
        return g.new_empty(0), None, None, None, None, None


def _kv_stream(anchor, kh: Tuple[torch.Tensor, ...],
               vh: Tuple[torch.Tensor, ...], fetch: _Fetch):
    """Yields (j, k_j, v_j) on the card, chunk j + 1's copy issued before
    chunk j is handed out."""
    def get(j):
        evs: List = []
        return (_ToDevice.apply(anchor, kh[j], 0, j, fetch, evs),
                _ToDevice.apply(anchor, vh[j], 1, j, fetch, evs), evs)

    nxt = get(0)
    for j in range(len(kh)):
        kj, vj, evs = nxt
        if j + 1 < len(kh):
            nxt = get(j + 1)
        for ev in evs:
            torch.cuda.current_stream(fetch.device).wait_event(ev)
        yield j, kj, vj


def fpdt_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, segment_mask=None,
                   num_chunks: int = 4, kv_chunks: int = 4,
                   offload_kv: bool = True, remat: bool = True
                   ) -> torch.Tensor:
    """FPDT attention (``_FPDTGPUOffloadingAttentionImpl_`` analog): each
    query chunk walks the K/V chunks with fp32 online-softmax
    accumulation, each block recomputed on its own in backward under
    ``remat``, so the card holds one [B, S/kv_chunks, N, D] K/V chunk and
    one [B, N, C, S/kv_chunks] score block's temporaries at a time; with
    ``offload_kv`` on a card the K/V chunks live in pinned host memory
    (see the module doc). Lengths the chunks do not divide fall back to
    :func:`chunked_attention`."""
    if segment_mask is not None:
        raise NotImplementedError("segment_mask unsupported in FPDT "
                                  "attention")
    B, S, N, D = q.shape
    K = k.shape[2]
    if K != N:
        k = k.repeat_interleave(N // K, dim=2)
        v = v.repeat_interleave(N // K, dim=2)
    if (num_chunks <= 1 or S % num_chunks or kv_chunks <= 1
            or S % kv_chunks):
        return chunked_attention(q, k, v, causal=causal,
                                 num_chunks=max(num_chunks, 1), remat=remat)
    C, CK = S // num_chunks, S // kv_chunks
    scale = 1.0 / math.sqrt(D)
    offload = offload_kv and q.device.type == "cuda"
    if offload:
        fetch = _Fetch(q.device, kv_chunks)
        host: List = []
        anchor = _Offload.apply(k, v, kv_chunks, fetch, host)
        kh, vh = host
    else:
        anchor = None
        kh, vh = k.chunk(kv_chunks, dim=1), v.chunk(kv_chunks, dim=1)

    def kv_step(q32, i, j, acc, m, l, kj, vj):
        """One (query chunk, K/V chunk) block of the online softmax."""
        s = torch.einsum("bcnd,btnd->bnct", q32, kj.float()) * scale
        if causal:
            q_pos = i * C + torch.arange(C, device=q.device)
            kv_pos = j * CK + torch.arange(CK, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
            s = torch.where(mask[None, None], s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bnct,btnd->bncd", p, vj.float())
        return acc, m_new, l

    def q_body(qi, i, anchor, *kv):
        q32 = qi.float()
        acc = torch.zeros(B, N, C, D, dtype=torch.float32, device=q.device)
        m = torch.full((B, N, C, 1), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(B, N, C, 1, dtype=torch.float32, device=q.device)
        chunks = (_kv_stream(anchor, kv[:kv_chunks], kv[kv_chunks:], fetch)
                  if offload else zip(range(kv_chunks), kv[:kv_chunks],
                                      kv[kv_chunks:]))
        # each block recomputed on its own in backward: one [B, N, C, CK]
        # score block's temporaries at a time
        for j, kj, vj in chunks:
            acc, m, l = _ckpt(kv_step, remat, q32, i, j, acc, m, l, kj, vj)
        out = acc / l.clamp(min=1e-30)
        return out.transpose(1, 2).to(q.dtype)          # [B, C, N, D]

    return torch.cat([_ckpt(q_body, remat, qi, i, anchor, *kh, *vh)
                      for i, qi in enumerate(q.split(C, dim=1))], dim=1)
