"""Paged (block-table) KV forward pass — the FastGen blocked-KV tick.

Parity: ``deepspeed_tpu/models/paged.py`` (``init_paged_kv``,
``forward_paged``, dense path). The ragged batch is a flat token batch:
``tokens[T]``, ``positions[T]`` and ``tables[T, MB]`` (the owning sequence's
block table). The KV pool is ``[L, NB, bs, K, D]``; token t writes its K/V
at ``pool[l, tables[t, pos // bs], pos % bs]`` and attends to its first
``pos + 1`` cache slots. Pad tokens carry an all-zeros table and write into
block 0 of each layer, the trash block that is never allocated.

Differences in form, not in result: a Python loop over layers takes the
place of ``lax.scan``, and each layer's attention gets that layer's pool
view ``pool["k"][l]`` (contiguous ``[NB, bs, K, D]``) with the raw tables,
where the JAX scan carried a flat ``[L*NB, ...]`` pool and offset tables by
``l*NB``. Both read the same slots.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.ops import paged_attention as PA

paged_attention_reference = PA.paged_attention_reference


def init_paged_kv(cfg: T.TransformerConfig, n_blocks: int, block_size: int,
                  dtype: Optional[torch.dtype] = None,
                  device: Optional[torch.device] = None
                  ) -> Dict[str, torch.Tensor]:
    """Block pool per layer. Block 0 is the trash block for pad writes.
    ``device`` as in :func:`resolve_device` (``None`` = the first GPU)."""
    T._check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or cfg.compute_dtype
    shape = (cfg.num_layers, n_blocks, block_size, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


class _ParamTree(nn.Module):
    """Holds a nested dict of tensors as parameters under the same keys
    (``model.blocks.ln1.scale`` is the JAX pytree path blocks/ln1/scale)."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, _ParamTree(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def tree(self) -> Dict[str, object]:
        out: Dict[str, object] = dict(self._parameters)
        for key, mod in self._modules.items():
            out[key] = mod.tree()
        return out


class PagedTransformer(_ParamTree):
    """The serving model's parameters under the JAX keys and shapes; a
    tick is ``forward_paged(model.tree(), ..., model.cfg)``."""

    def __init__(self, cfg: T.TransformerConfig, params: Dict[str, object]):
        T._check_supported(cfg)
        super().__init__(params)
        self.cfg = cfg


def _layer(blocks: Dict[str, object], li: int) -> Dict[str, object]:
    return {k: _layer(v, li) if isinstance(v, dict) else v[li]
            for k, v in blocks.items()}


@torch.no_grad()
def forward_paged(params: Dict[str, object], tokens: torch.Tensor,
                  positions: torch.Tensor, tables: torch.Tensor,
                  pool: Dict[str, torch.Tensor], cfg: T.TransformerConfig,
                  use_kernels: bool = True
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One SplitFuse tick over a flat token batch.

    tokens [T], positions [T], tables [T, MB] (int32 or int64, on the
    pool's device). Returns (logits [T, vocab] fp32, pool). The pool is
    updated IN PLACE: the JAX tick donated it and scattered into the
    donated buffer; PyTorch writes the rows into the same tensors.

    ``use_kernels``: paged attention and the norms go through their kernel
    wrappers (the kernels on a GPU, the plain versions on the CPU), with
    one paged-attention plan (``PA.build_plan``) for every layer of the
    tick where one is read (``PA.uses_plan``: bf16, at least ``MIN_RUN``
    rows); ``False`` takes the plain versions on any device."""
    T._check_supported(cfg)
    dt = cfg.compute_dtype
    N, K, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    Tn = tokens.shape[0]
    pk, pv = pool["k"], pool["v"]
    L, NB, bs = pk.shape[:3]
    tok, pos = tokens.long(), positions.long()

    x = params["tok_emb"][tok].to(dt)                    # [T, H]
    if cfg.pos_emb == "learned":
        x = x + params["pos_emb"][pos].to(dt)
    cos_t = sin_t = None
    if cfg.pos_emb == "rope":
        cos_t, sin_t = T.rope_table(NB * bs, cfg.rope_dim, cfg.rope_theta,
                                    cfg.rope_scaling_dict, device=x.device)
    block_idx = tables.long().gather(1, (pos // bs)[:, None])[:, 0]   # [T]
    offsets = pos % bs
    lengths = (pos + 1).to(torch.int32)
    tables32 = tables.to(torch.int32).contiguous()
    if use_kernels:
        plan = PA.build_plan(tables32) if PA.uses_plan(dt, Tn) else None
        attention_fn = functools.partial(PA.paged_attention, plan=plan)
    else:
        attention_fn = PA.paged_attention_reference
    blocks = params["blocks"]

    def proj(h, lp, name, heads):
        out = h @ lp[f"w{name}"]
        if cfg.attn_bias_enabled if name in ("q", "k", "v") else cfg.use_bias:
            out = out + lp[f"b{name}"]
        return out.reshape(Tn, heads, D) if heads else out

    for li in range(L):
        lp = _layer(blocks, li)
        h = T._norm(x, lp["ln1"], cfg.norm, cfg.norm_eps, use_kernels)
        q = proj(h, lp, "q", N)
        k = proj(h, lp, "k", K)
        v = proj(h, lp, "v", K)
        if cfg.pos_emb == "rope":
            q = T.apply_rope_at(q[None], cos_t, sin_t, pos[None])[0]
            k = T.apply_rope_at(k[None], cos_t, sin_t, pos[None])[0]
        # blocked KV write: token t → pool[l, block_idx[t], offsets[t]];
        # pad tokens hit this layer's trash block 0
        pk[li][block_idx, offsets] = k.to(pk.dtype)
        pv[li][block_idx, offsets] = v.to(pv.dtype)
        attn = attention_fn(q.contiguous(), pk[li], pv[li], tables32, lengths)
        attn_out = proj(attn.reshape(Tn, N * D), lp, "o", 0)
        x = x + attn_out
        h2 = T._norm(x, lp["ln2"], cfg.norm, cfg.norm_eps, use_kernels)
        x = x + T._ffn(h2, lp, cfg, use_kernels)[0]
    x = T._norm(x, params["final_norm"], cfg.norm, cfg.norm_eps, use_kernels)
    logits = T.head_matmul(x, T._lm_head_of(params, cfg).to(x.dtype))
    return logits, pool
