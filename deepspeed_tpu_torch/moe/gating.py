"""MoE gating: the index-form top-k gate of the dropless dispatch.

Ports ``deepspeed_tpu/moe/gating.py``: ``IndexGateOutput``, ``gate_capacity``
(:42), ``_group_limited_mask`` (:48), ``_gate_scores`` (:61), ``_iter_topk``
(:94), ``_aux_loss`` (:110) and ``topk_gating_indices`` (:117) — softmax or
sigmoid scores, DeepSeek-V3's ``select_bias`` and node-limited routing
(``n_group`` / ``topk_group``), renormalised top-k weights, and the
Switch/GShard aux loss over the first choice. Plain PyTorch: the gate is a
handful of [T, E] operations, all in fp32.

Later slices: noisy gating and the dense capacity gate ``topk_gating``
(:143) with its [T, E, C] dispatch/combine tensors raise
``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from deepspeed_tpu_torch.runtime.config_utils import later_slice


class IndexGateOutput(NamedTuple):
    """Who goes where and with what weight — no [T, E, C] one-hot tensors."""
    weights: torch.Tensor    # [T, k] fp32 — combine weights per choice
    experts: torch.Tensor    # [T, k] int64 — selected expert per choice
    aux_loss: torch.Tensor   # scalar fp32 — load-balancing loss
    probs: torch.Tensor      # [T, E] fp32 — gate probabilities


def gate_capacity(num_tokens: int, num_experts: int, k: int,
                  capacity_factor: float, min_capacity: int = 4) -> int:
    """C = max(min_capacity, ceil(T * k * capacity_factor / E))."""
    cap = int(math.ceil(num_tokens * k * capacity_factor / num_experts))
    return max(min_capacity, cap)


def _group_limited_mask(sel: torch.Tensor, n_group: int,
                        topk_group: int) -> torch.Tensor:
    """DeepSeek-V3 node-limited routing: score each group by the sum of its
    top-2 selection scores, keep the best ``topk_group`` groups, zero the
    rest."""
    T, E = sel.shape
    g = sel.reshape(T, n_group, E // n_group)
    group_scores = torch.topk(g, 2, dim=-1).values.sum(dim=-1)      # [T, G]
    thresh = torch.topk(group_scores, topk_group, dim=-1).values[:, -1:]
    group_mask = (group_scores >= thresh).to(sel.dtype)
    return (g * group_mask[:, :, None]).reshape(T, E)


def _gate_scores(logits: torch.Tensor, score_func: str,
                 select_bias: Optional[torch.Tensor], n_group: int,
                 topk_group: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (gate_source [T,E], probs [T,E], sel_logits [T,E]); the bias and
    the group limitation steer selection only, never the combine weights."""
    logits = logits.float()
    if score_func == "sigmoid":
        scores = torch.sigmoid(logits)
        probs = scores / torch.clamp(scores.sum(dim=-1, keepdim=True),
                                     min=1e-9)
        gate_source = scores
    elif score_func == "softmax":
        probs = torch.softmax(logits, dim=-1)
        gate_source = probs
    else:
        raise ValueError(
            f"score_func must be softmax|sigmoid, got {score_func!r}")
    sel_logits = logits
    if select_bias is not None or n_group > 1:
        sel = gate_source
        if select_bias is not None:
            sel = sel + select_bias.float()[None, :]
        if n_group > 1:
            sel = _group_limited_mask(sel, n_group, topk_group)
        sel_logits = sel
    return gate_source, probs, sel_logits


def _iter_topk(sel_logits: torch.Tensor, gate_source: torch.Tensor, k: int
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                          List[torch.Tensor]]:
    """Iterative argmax top-k (the first index wins a tie, as in jnp).
    → (gates k×[T], indices k×[T] int64, one-hot masks k×[T, E] fp32)."""
    masked = sel_logits
    E = sel_logits.shape[-1]
    gates_list, idx_list, masks = [], [], []
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)
        mask = torch.nn.functional.one_hot(idx, E).float()
        gates_list.append((gate_source * mask).sum(dim=-1))
        idx_list.append(idx)
        masks.append(mask)
        masked = masked.masked_fill(mask.bool(), -math.inf)
    return gates_list, idx_list, masks


def _aux_loss(probs: torch.Tensor, mask1: torch.Tensor) -> torch.Tensor:
    """Switch/GShard l_aux over the FIRST choice."""
    me = probs.mean(dim=0)
    ce = mask1.mean(dim=0)
    return (me * ce).sum() * probs.shape[-1]


def topk_gating_indices(logits: torch.Tensor, k: int = 2,
                        rng: Optional[torch.Generator] = None,
                        noise_std: float = 0.0,
                        normalize: bool = True,
                        score_func: str = "softmax",
                        select_bias: Optional[torch.Tensor] = None,
                        n_group: int = 1, topk_group: int = 1
                        ) -> IndexGateOutput:
    """Index-form top-k gate for the dropless dispatch: no capacity, so
    ``normalize`` renormalises the k selected scores directly."""
    if noise_std > 0.0 and rng is not None:
        raise later_slice("noisy gating (noise_std > 0)")
    gate_source, probs, sel_logits = _gate_scores(
        logits, score_func, select_bias, n_group, topk_group)
    gates_list, idx_list, masks = _iter_topk(sel_logits, gate_source, k)
    aux = _aux_loss(probs, masks[0])
    gates = torch.stack(gates_list, dim=1)                   # [T, k]
    experts = torch.stack(idx_list, dim=1)                   # [T, k]
    if normalize:
        gates = gates / torch.clamp(gates.sum(dim=1, keepdim=True),
                                    min=1e-9)
    return IndexGateOutput(gates, experts, aux, probs)


def topk_gating(*args, **kwargs):
    """The dense capacity gate of the GShard dispatch: a later slice."""
    raise later_slice("the dense MoE gate topk_gating (dispatch='dense')")
