"""MoE gating: top-1 / top-2 / top-k with capacity and load-balancing loss.

Ports ``deepspeed_tpu/moe/gating.py``: ``GateOutput``, ``IndexGateOutput``,
``gate_capacity`` (:42), ``_group_limited_mask`` (:48), ``_gate_scores``
(:61, noisy gating included), ``_iter_topk`` (:94), ``_aux_loss`` (:110),
``topk_gating_indices`` (:117), the dense capacity gate ``topk_gating``
(:143) with its [T, E, C] combine and dispatch tensors, ``top1_gating``
and ``top2_gating`` (:196, :205) — softmax or sigmoid scores, DeepSeek-V3's
``select_bias`` and node-limited routing (``n_group`` / ``topk_group``),
renormalised top-k weights, and the Switch/GShard aux loss over the first
choice. Plain PyTorch: the gate is a handful of [T, E] operations, all in
fp32.

Noisy gating adds ``noise_std`` × a standard normal draw to the selection
scores. The draw is :func:`gate_noise` from an explicit
``torch.Generator``; JAX draws ``jax.random.normal(rng, logits.shape)``
from its key. The two generators give different numbers for one seed, so
a test puts JAX's draw in place of :func:`gate_noise` to hold the rest of
the gate against JAX's.

The dense gate of a token batch sharded over processes takes
``global_counts``: a function from this rank's per-choice expert counts
[k, E] to (the choices' location offsets [k, E], the global first-choice
counts [E], the global token count). Capacity then comes from the global
token count and each choice's locations continue the earlier ranks' and
the earlier choices' counts, as JAX's one GSPMD gate over the whole batch
lays them out (``moe/layer.py`` builds it).
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch


class GateOutput(NamedTuple):
    combine: torch.Tensor    # [T, E, C] fp32 — combine weights
    dispatch: torch.Tensor   # [T, E, C] bool — dispatch mask
    aux_loss: torch.Tensor   # scalar fp32 — load-balancing loss
    probs: torch.Tensor      # [T, E] fp32 — gate probabilities
    counts: torch.Tensor     # [E] int32 — tokens routed per expert (first
    #                          choice, before capacity)


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


def gate_noise(rng: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """A standard normal fp32 draw of ``shape`` from ``rng``, on its
    device: noisy gating's noise (the one place a test substitutes JAX's
    draw)."""
    return torch.randn(shape, generator=rng, device=rng.device,
                       dtype=torch.float32)


def _gate_scores(logits: torch.Tensor, score_func: str,
                 select_bias: Optional[torch.Tensor], n_group: int,
                 topk_group: int, rng: Optional[torch.Generator] = None,
                 noise_std: float = 0.0, noise=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (gate_source [T,E], probs [T,E], sel_logits [T,E]); the bias, the
    group limitation and the noise steer selection only, never the combine
    weights. ``noise``: the draw itself (a sharded batch's rows of the
    global draw), else :func:`gate_noise` of the logits' shape."""
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
    if noise_std > 0.0 and rng is not None:
        if noise is None:
            noise = gate_noise(rng, tuple(logits.shape))
        sel_logits = sel_logits + noise.to(sel_logits.device) * noise_std
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
    gate_source, probs, sel_logits = _gate_scores(
        logits, score_func, select_bias, n_group, topk_group, rng, noise_std)
    gates_list, idx_list, masks = _iter_topk(sel_logits, gate_source, k)
    aux = _aux_loss(probs, masks[0])
    gates = torch.stack(gates_list, dim=1)                   # [T, k]
    experts = torch.stack(idx_list, dim=1)                   # [T, k]
    if normalize:
        gates = gates / torch.clamp(gates.sum(dim=1, keepdim=True),
                                    min=1e-9)
    return IndexGateOutput(gates, experts, aux, probs)


def topk_gating(logits: torch.Tensor, k: int = 2,
                capacity_factor: float = 1.25, min_capacity: int = 4,
                rng: Optional[torch.Generator] = None,
                noise_std: float = 0.0, normalize: bool = True,
                score_func: str = "softmax",
                select_bias: Optional[torch.Tensor] = None,
                n_group: int = 1, topk_group: int = 1,
                global_counts: Optional[Callable] = None, noise=None,
                aux_fn: Optional[Callable] = None) -> GateOutput:
    """Generic top-k gate with capacity (k=1: ``top1_gating``, k=2:
    ``top2_gating``). C = max(min_capacity, ceil(T·k·capacity_factor /
    E)); capacity fills in choice-priority order (every first choice
    before any second), a choice past its expert's capacity is dropped and
    the kept gates renormalised (``normalize``). ``global_counts`` and
    ``aux_fn`` (the aux loss from ``probs`` and the first-choice mask)
    serve a batch sharded over processes (see the module doc)."""
    T, E = logits.shape
    gate_source, probs, sel_logits = _gate_scores(
        logits, score_func, select_bias, n_group, topk_group, rng, noise_std,
        noise)
    gates_list, idx_list, masks = _iter_topk(sel_logits, gate_source, k)
    aux = (aux_fn or _aux_loss)(probs, masks[0])
    local = torch.stack([m.sum(dim=0) for m in masks])       # [k, E]
    if global_counts is None:
        base = torch.cumsum(local, dim=0) - local
        counts1, n_tokens = local[0], T
    else:
        base, counts1, n_tokens = global_counts(local)
    C = gate_capacity(n_tokens, E, k, capacity_factor, min_capacity)

    # capacity assignment in choice-priority order (1st choices fill first)
    denom = torch.zeros(T, dtype=torch.float32, device=logits.device)
    per_choice = []
    for i in range(k):
        mask = masks[i]
        locations = torch.cumsum(mask, dim=0) - 1 + base[i][None, :]
        keep = (locations < C) & (mask > 0)
        mask = torch.where(keep, mask, torch.zeros_like(mask))
        denom = denom + gates_list[i] * mask.sum(dim=-1)
        per_choice.append((mask, locations, gates_list[i]))

    combine = torch.zeros(T, E, C, dtype=torch.float32, device=logits.device)
    for mask, locations, gate_raw in per_choice:
        gate = gate_raw / torch.clamp(denom, min=1e-9) if normalize \
            else gate_raw
        # a dropped choice's location lies past C: its one-hot row is 0
        loc = locations.long().clamp(0, C)
        loc_oh = torch.nn.functional.one_hot(loc, C + 1)[..., :C].float()
        combine = combine + gate[:, None, None] * mask[:, :, None] * loc_oh
    dispatch = combine > 0.0
    return GateOutput(combine, dispatch, aux, probs, counts1.to(torch.int32))


def top1_gating(logits: torch.Tensor, capacity_factor: float = 1.0,
                min_capacity: int = 4, rng: Optional[torch.Generator] = None,
                noise_std: float = 0.0) -> GateOutput:
    """Switch-transformer gate (reference ``top1gating``)."""
    return topk_gating(logits, k=1, capacity_factor=capacity_factor,
                       min_capacity=min_capacity, rng=rng,
                       noise_std=noise_std, normalize=False)


def top2_gating(logits: torch.Tensor, capacity_factor: float = 1.0,
                min_capacity: int = 4) -> GateOutput:
    """GShard top-2 gate (reference ``top2gating``)."""
    return topk_gating(logits, k=2, capacity_factor=capacity_factor,
                       min_capacity=min_capacity, normalize=True)
