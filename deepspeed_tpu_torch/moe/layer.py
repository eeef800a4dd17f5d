"""MoE expert layer: the dropless ragged dispatch, local and expert-parallel,
and the dense GShard dispatch.

Ports ``deepspeed_tpu/moe/layer.py``: ``set_drop_monitor`` (:74),
``grouped_dot`` (:136), ``ragged_expert_ffn`` (:189), ``expert_sort`` (:213),
``permute_rows`` (:240), ``buffer_exchange`` (:270),
``buffer_exchange_kdup`` (:293), ``dispatch_gather`` (:321) and
``combine_gather`` (:346) with their gather-only backward passes,
``_expert_act``, ``_dense_ffn`` (the shared expert), ``_ragged_dispatch_local``
(:377), ``ragged_mesh_plan`` (:434), ``resolve_dispatch`` (:462),
``routing_drop_stats`` (:495), ``_gate_indices`` (:532),
``ep_shard_capacity`` (:542), ``_ragged_routed`` (:553) and ``moe_ffn``
(:752).

Local: the fp32 router picks k experts per token; a counting sort lays the
T·k token choices out by expert; each expert weight is applied by ONE
grouped GEMM (``ops/grouped_gemm.py``, the hand-written CUDA kernels on a
card) over the expert-sorted rows; the combine gathers each token's k rows
back, weighted by the gate. No [T, E, C] tensor, no capacity, no dropped
token. Both directions of every dispatch and combine are gathers and sums,
as in JAX, never ``index_add_``: CUDA's atomics would make the gradients
change from run to run.

Over processes the layer reads the process mesh (``comm/mesh``), as JAX's
reads its device mesh, and each process holds its own rows of the batch
(the engine's split; JAX's ``shard_map`` takes the same rows per device):

* a batch sharded over ``data`` / ``zshard`` / ``expert`` sorts per rank
  and takes the EXACT global aux loss: the token means of the router
  probabilities and of the first-choice mask averaged over the batch group
  before their product (JAX's ``_global_aux``), through a differentiable
  all-reduce mean on the MoE layer's own group;
* under an ``expert`` axis of X ranks each rank holds E/X experts (its
  coordinate c: experts c·E/X …) and the choices travel by all-to-all to
  their expert's rank in fixed per-destination buffers of
  ``ep_shard_capacity`` slots (a choice past its buffer is dropped and the
  kept weights renormalised, JAX's semantics; ``set_drop_monitor`` reports
  the dropped share). The received rows are counting-sorted by local
  expert, empties last; the grouped GEMMs run over the routed rows
  (``group_sizes`` the first E/X counts), and the rows past them — the
  buffer's empty tail — are written as zeros by the kernels (no GEMM work:
  those tiles have no contraction steps) and never read by the combine,
  which gathers strictly by slot;
* under ``comm/mesh.manual_axes`` (the ZeRO++ int8 wire's step, JAX's
  manual ``shard_map`` over ``data`` and ``zshard``) those axes count as
  local: the gate, its aux loss and the dense gate's capacity are the
  rank's own, as in JAX.

Dense (``dispatch="dense"``): the GShard capacity gate
(``moe/gating.topk_gating``) and the [E, C, H] einsums, every expert on
every rank. Over a sharded batch the gate is JAX's global one: C from the
global token count and each choice's locations after the earlier ranks'
(an all-gather of the [k, E] counts); a slot is filled by at most one
token, so each rank's buffer holds only its own tokens and the expert FFN,
row by row, needs no other rank's. The dense dispatch under an ``expert``
axis raises ``NotImplementedError`` (a later slice).

Casts follow the JAX package: router logits in fp32 from fp32 upcasts,
expert weights cast to the compute dtype before the GEMMs, combine weights
cast to the compute dtype, and the combine's weight gradient summed in fp32
before its cast. ``route_scale`` multiplies by the Python float (a copy of
a host scalar to the card would break a CUDA graph's capture).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm import mesh as mesh_mod
from deepspeed_tpu_torch.moe import gating as G
from deepspeed_tpu_torch.moe.gating import (
    GateOutput,
    IndexGateOutput,
    gate_capacity,
    topk_gating,
    topk_gating_indices,
)
from deepspeed_tpu_torch.ops import grouped_gemm as GG
from deepspeed_tpu_torch.runtime.config_utils import later_slice

# the installed observer of the expert-parallel buffers' dropped choices
# (None: nothing is counted, no collective runs for it)
_DROP_MONITOR: Optional[Callable[[torch.Tensor], None]] = None


def set_drop_monitor(fn) -> None:
    """``fn(dropped_frac)`` is called with the global fraction of
    token-choices the expert-parallel buffers dropped, a 0-dim fp32 tensor
    on the layer's device (no host read), at each dispatch. None
    uninstalls."""
    global _DROP_MONITOR
    _DROP_MONITOR = fn


def _dense_ffn(xt: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
               w_gate: Optional[torch.Tensor], activation: str
               ) -> torch.Tensor:
    """Plain FFN on flat tokens [T, H] (the shared-expert path)."""
    dt = xt.dtype
    up = xt @ w_up.to(dt)
    if w_gate is not None:
        up = F.silu(xt @ w_gate.to(dt)) * up
    elif activation == "gelu":
        up = F.gelu(up, approximate="tanh")
    else:
        up = F.relu(up)
    return up @ w_down.to(dt)


def _expert_act(up: torch.Tensor, gate: Optional[torch.Tensor],
                activation: str) -> torch.Tensor:
    if gate is not None:
        return F.silu(gate) * up
    if activation == "gelu":
        return F.gelu(up, approximate="tanh")
    return F.relu(up)


def grouped_dot(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                use_kernel: bool = True) -> torch.Tensor:
    """Grouped GEMM ``x[rows of group e] @ w[e]`` → [M, N]: the CUDA
    kernels (megablox ``gmm``'s place) with their VJP; ``use_kernel=False``
    the plain version differentiated by autograd. Rows past
    ``sum(group_sizes)`` are zeros, as under ``lax.ragged_dot``."""
    if use_kernel:
        return GG.grouped_matmul(x, w, group_sizes)
    return GG.gmm_ref(x, w, group_sizes)


def ragged_expert_ffn(x_sorted: torch.Tensor, group_sizes: torch.Tensor,
                      experts: Dict[str, torch.Tensor], activation: str,
                      use_kernels: bool = True) -> torch.Tensor:
    """Grouped expert FFN on expert-sorted rows x_sorted [M, H];
    ``group_sizes`` [E] int32 summing to M. Each weight is ONE grouped
    GEMM."""
    dt = x_sorted.dtype
    up = grouped_dot(x_sorted, experts["w_up"].to(dt), group_sizes,
                     use_kernels)
    g = (grouped_dot(x_sorted, experts["w_gate"].to(dt), group_sizes,
                     use_kernels) if "w_gate" in experts else None)
    act = _expert_act(up, g, activation)
    return grouped_dot(act, experts["w_down"].to(dt), group_sizes,
                       use_kernels)


def expert_sort(flat: torch.Tensor, E: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Counting sort of expert assignments → (order, inverse, counts).

    ``order[i]`` = row of the i-th element in expert-sorted layout (stable);
    ``inv[r]`` = sorted slot of row r (the inverse permutation);
    ``counts[e]`` = occupancy of expert e (int32, the GEMMs' group sizes).
    One-hot + cumsum, as in JAX: no general sort, no host sync. The one-hot
    lies expert-major, [E, Tk], so the cumsum runs along the contiguous
    dim: along dim 0 of [Tk, E] a GPU scans each of the E columns in one
    serial thread."""
    Tk = flat.shape[0]
    experts = torch.arange(E, device=flat.device)
    onehot = (flat[None, :] == experts[:, None]).long()      # [E, Tk]
    within = torch.cumsum(onehot, dim=1) - 1                 # pos within expert
    counts = onehot.sum(dim=1)                               # [E]
    starts = torch.cumsum(counts, dim=0) - counts            # exclusive
    slot = within.gather(0, flat[None, :])[0] + starts[flat]
    order = torch.empty_like(slot).scatter_(
        0, slot, torch.arange(Tk, device=flat.device))
    return order, slot, counts.to(torch.int32)


class _DispatchGather(torch.autograd.Function):
    """``out[j] = x[order[j] // k]`` — the expert-sorted rows in one gather,
    without the k-duplicated [T·k, H] copy. Backward: ``dx[t] = Σ_c
    g[inv2d[t, c]]``, gathers and a sum."""

    @staticmethod
    def forward(ctx, x, rows, inv2d):
        ctx.save_for_backward(inv2d)
        return x.index_select(0, rows)

    @staticmethod
    def backward(ctx, g):
        inv2d, = ctx.saved_tensors
        with record_function("moe_dispatch_backward"):
            T, k = inv2d.shape
            dx = g.index_select(0, inv2d.reshape(-1)).reshape(
                T, k, g.shape[-1]).sum(dim=1)
        return dx, None, None


def dispatch_gather(x: torch.Tensor, order: torch.Tensor,
                    inv2d: torch.Tensor) -> torch.Tensor:
    """Expert-sorted token rows ``x[order // k]`` (JAX ``dispatch_gather``)."""
    return _DispatchGather.apply(x, order // inv2d.shape[-1], inv2d)


class _CombineGather(torch.autograd.Function):
    """``out[t] = Σ_c weights[t, c] · y_s[inv2d[t, c]]`` in the rows' dtype.
    Backward: ``dy_s[j] = w[j] · g[order[j] // k]`` and ``dw[t, c] =
    ⟨y_s[inv2d[t, c]], g[t]⟩`` summed in fp32, then cast."""

    @staticmethod
    def forward(ctx, y_s, weights, order, inv2d):
        ctx.save_for_backward(y_s, weights, order, inv2d)
        T, k = inv2d.shape
        w = weights.to(y_s.dtype)
        picked = y_s.index_select(0, inv2d.reshape(-1)).reshape(T, k, -1)
        return (picked * w[..., None]).sum(dim=1)

    @staticmethod
    def backward(ctx, g):
        y_s, weights, order, inv2d = ctx.saved_tensors
        with record_function("moe_combine_backward"):
            T, k = inv2d.shape
            w_s = weights.reshape(-1).index_select(0, order).to(y_s.dtype)
            dy = g.index_select(0, order // k) * w_s[:, None]
            picked = y_s.index_select(0, inv2d.reshape(-1)).reshape(T, k, -1)
            dw = torch.bmm(picked.float(), g.float()[:, :, None])[..., 0]
        return dy, dw.to(weights.dtype), None, None


def combine_gather(y_s: torch.Tensor, weights: torch.Tensor,
                   order: torch.Tensor, inv2d: torch.Tensor) -> torch.Tensor:
    """Weighted combine straight from the expert-sorted rows (JAX
    ``combine_gather``)."""
    return _CombineGather.apply(y_s, weights, order, inv2d)


def _take_pad_zero(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` where the one-past sentinel ``idx == len(x)`` reads a
    zero row (a gather and a masked fill, no padded copy of ``x``)."""
    n = x.shape[0]
    out = x.index_select(0, idx.clamp(max=max(n - 1, 0)))
    return out.masked_fill((idx >= n)[:, None], 0)


class _PermuteRows(torch.autograd.Function):
    """``x[perm]`` for a permutation whose inverse is known; backward
    ``g[inv_perm]``: both directions gathers."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        inv_perm, = ctx.saved_tensors
        return g.index_select(0, inv_perm), None, None


def permute_rows(x: torch.Tensor, perm: torch.Tensor,
                 inv_perm: torch.Tensor) -> torch.Tensor:
    """``x[perm]`` (JAX ``permute_rows``)."""
    return _PermuteRows.apply(x, perm, inv_perm)


class _BufferExchange(torch.autograd.Function):
    """``vals[fwd_idx]`` (sentinel → 0) whose transpose is ``g[bwd_idx]``:
    the buffers' slots are filled by at most one row, so the two index maps
    are each other's partial inverses."""

    @staticmethod
    def forward(ctx, vals, fwd_idx, bwd_idx):
        ctx.save_for_backward(bwd_idx)
        return _take_pad_zero(vals, fwd_idx)

    @staticmethod
    def backward(ctx, g):
        bwd_idx, = ctx.saved_tensors
        return _take_pad_zero(g, bwd_idx), None, None


def buffer_exchange(vals: torch.Tensor, fwd_idx: torch.Tensor,
                    bwd_idx: torch.Tensor) -> torch.Tensor:
    """JAX ``buffer_exchange``."""
    return _BufferExchange.apply(vals, fwd_idx, bwd_idx)


class _BufferExchangeKdup(torch.autograd.Function):
    """``out[j] = x[fwd_rows[j]]`` with the k-duplication folded into the
    index map (``fwd_rows = slot2row // k``; the sentinel t·k divides to
    t, a zero row); backward ``dx[t] = Σ_c g[bwd_idx2d[t, c]]``, the
    sentinel reading zero: gathers and a sum."""

    @staticmethod
    def forward(ctx, x, fwd_rows, bwd_idx2d):
        ctx.save_for_backward(bwd_idx2d)
        return _take_pad_zero(x, fwd_rows)

    @staticmethod
    def backward(ctx, g):
        bwd_idx2d, = ctx.saved_tensors
        t, k = bwd_idx2d.shape
        dx = _take_pad_zero(g, bwd_idx2d.reshape(t * k)).reshape(
            t, k, g.shape[-1]).sum(dim=1)
        return dx, None, None


def buffer_exchange_kdup(x: torch.Tensor, fwd_rows: torch.Tensor,
                         bwd_idx2d: torch.Tensor) -> torch.Tensor:
    """JAX ``buffer_exchange_kdup``."""
    return _BufferExchangeKdup.apply(x, fwd_rows, bwd_idx2d)


def _ragged_dispatch_local(xt: torch.Tensor, weights: torch.Tensor,
                           idx: torch.Tensor,
                           experts: Dict[str, torch.Tensor], activation: str,
                           use_kernels: bool = True) -> torch.Tensor:
    """Dropless dispatch on local tokens: sort → grouped GEMMs → un-sort.
    xt [T, H]; weights/idx [T, k]."""
    T, _ = xt.shape
    k = idx.shape[-1]
    E = experts["w_up"].shape[0]
    with record_function("moe_dispatch"):
        order, inv, group_sizes = expert_sort(idx.reshape(T * k), E)
        inv2d = inv.reshape(T, k)
        x_s = dispatch_gather(xt, order, inv2d)
    y_s = ragged_expert_ffn(x_s, group_sizes, experts, activation,
                            use_kernels)
    with record_function("moe_combine"):
        return combine_gather(y_s, weights.to(xt.dtype), order, inv2d)


def _gate_indices(xt: torch.Tensor, gate_w: torch.Tensor,
                  gate_bias: Optional[torch.Tensor], k: int, score_func: str,
                  route_norm: bool, n_group: int, topk_group: int
                  ) -> IndexGateOutput:
    logits = xt.float() @ gate_w.float()
    return topk_gating_indices(
        logits, k=k, normalize=route_norm, score_func=score_func,
        select_bias=gate_bias, n_group=n_group, topk_group=topk_group)




# --------------------------------------------------------------------------- #
# over processes: the mesh plan, the global aux, the expert-parallel
# all-to-all dispatch and the dense GShard dispatch
# --------------------------------------------------------------------------- #

def _mesh():
    """The process mesh when one is installed, else None (one process)."""
    return mesh_mod.get_mesh_manager() if mesh_mod.mesh_is_initialized() \
        else None


def ragged_mesh_plan(mm, B: int, S: Optional[int], E: int):
    """How the layer runs on the process mesh ``mm`` for this rank's
    [B, S, H] rows → ``('local', None)`` (no axis sharded, or all of them
    under ``manual_axes``), ``('shard', (batch_axes, ep))`` or
    ``('indivisible', None)`` (E does not divide the expert axis). The
    ONE copy of this predicate, for :func:`resolve_dispatch` and
    :func:`moe_ffn` (JAX ``ragged_mesh_plan``; each rank's rows are its own
    already, so no batch shape can fail to divide)."""
    if mm is None:
        return "local", None
    manual = set(mesh_mod.current_manual_axes())
    batch_axes = tuple(a for a in mesh_mod.BATCH_AXES
                       if mm.axis_size(a) > 1 and a not in manual)
    ep = mm.axis_size(mesh_mod.EXPERT_AXIS) \
        if mesh_mod.EXPERT_AXIS not in manual else 1
    if not (batch_axes or ep > 1):
        return "local", None
    if ep > 1 and E % ep:
        return "indivisible", None
    return "shard", (batch_axes, ep)


def resolve_dispatch(dispatch: str, rng=None, noise_std: float = 0.0,
                     B: Optional[int] = None, S: Optional[int] = None,
                     E: Optional[int] = None) -> str:
    """'auto' → 'ragged' wherever it runs, else 'dense' (noisy gating, or
    an expert axis that E does not divide); JAX's errors for an unknown
    mode and for 'ragged' with noisy gating."""
    if dispatch not in ("auto", "ragged", "dense"):
        raise ValueError(
            f"moe dispatch must be auto|ragged|dense, got {dispatch!r}")
    noisy = rng is not None and noise_std > 0.0
    if dispatch == "ragged" and noisy:
        raise ValueError(
            "dispatch='ragged' does not implement noisy gating (per-shard "
            "RNG streams would decorrelate from global-batch semantics) — "
            "use dispatch='dense' or 'auto' with noisy gating")
    if dispatch != "auto":
        return dispatch
    if noisy:
        return "dense"
    if B is not None:
        kind, _ = ragged_mesh_plan(_mesh(), B, S, E if E is not None else 1)
        if kind == "indivisible":
            return "dense"
    return "ragged"


def ep_shard_capacity(local_choices: int, ep: int) -> int:
    """Slots of each destination's buffer in the expert-parallel
    all-to-all: 2× the balanced load, at least 64, at most every local
    choice (tiny inputs get a dropless buffer)."""
    return min(local_choices, max(64, -(-local_choices * 2 // ep)))


def routing_drop_stats(logits: torch.Tensor, k: int, capacity_factor: float,
                       min_capacity: int = 4, ep: int = 1,
                       tokens_per_shard: Optional[int] = None
                       ) -> Dict[str, float]:
    """Dropped-token-choice fractions of both dispatch modes on one batch of
    logits [T, E]: ``dense`` over the per-expert capacity; ``ragged`` 0 off
    expert-parallel meshes, else over the per-destination buffers of
    ``ep_shard_capacity`` slots, token shard by token shard."""
    T, E = logits.shape
    gate = topk_gating(logits, k=k, capacity_factor=capacity_factor,
                       min_capacity=min_capacity)
    kept = float(gate.dispatch.sum())
    dense_frac = 1.0 - kept / (T * k)
    ragged_frac = 0.0
    if ep > 1:
        t = tokens_per_shard or T
        idx = torch.argsort(-logits, dim=-1, stable=True)[:, :k]
        dest = idx // (E // ep)
        Cs = ep_shard_capacity(t * k, ep)
        dropped = 0
        for s0 in range(0, T, t):
            counts = torch.bincount(dest[s0:s0 + t].reshape(-1),
                                    minlength=ep)
            dropped += int((counts - Cs).clamp(min=0).sum())
        ragged_frac = dropped / (T * k)
    return {"dense": dense_frac, "ragged": ragged_frac,
            "dense_capacity": gate_capacity(T, E, k, capacity_factor,
                                            min_capacity)}


def _aux_over(group, probs: torch.Tensor, mask1: torch.Tensor
              ) -> torch.Tensor:
    """The Switch aux loss over a batch sharded on ``group``: the token
    means of the probabilities and of the first-choice mask averaged over
    the group BEFORE their product (JAX ``_global_aux``)."""
    E = probs.shape[-1]
    both = torch.cat([probs.mean(dim=0), mask1.float().mean(dim=0)])
    if group is not None:
        both = comm.all_reduce_mean_autograd(both, group)
    me, ce = both[:E], both[E:]
    return (me * ce).sum() * E


def _ep_dispatch(xt: torch.Tensor, gate: IndexGateOutput,
                 experts: Dict[str, torch.Tensor], E: int, ep: int,
                 expert_group, batch_group, activation: str,
                 route_norm: bool, use_kernels: bool) -> torch.Tensor:
    """The expert-parallel dispatch of this rank's tokens xt [t, H]
    (JAX's ``_ragged_routed`` EP branch): each choice to the buffer of
    its expert's rank (slot order: position among the choices bound there,
    overflow → the sentinel), the rows and local expert ids all-to-all'd,
    sorted by local expert (empties last), the grouped GEMMs over the
    routed rows, back by the inverse permutation and a second all-to-all,
    and the combine renormalised over the kept choices."""
    t, H = xt.shape
    k = gate.experts.shape[-1]
    E_l = E // ep
    tk = t * k
    Cs = ep_shard_capacity(tk, ep)
    dev, dt = xt.device, xt.dtype
    with record_function("moe_dispatch"):
        flat_e = gate.experts.reshape(tk)
        dest = flat_e // E_l
        onehot = (dest[None, :] == torch.arange(ep, device=dev)[:, None]
                  ).long()                                   # [ep, tk]
        pos = (torch.cumsum(onehot, dim=1) - 1).gather(0, dest[None])[0]
        slot = torch.where(pos < Cs, dest * Cs + pos,
                           torch.full_like(pos, ep * Cs))
        # slot → row (sentinel tk: an empty slot); the dropped choices all
        # land on the extra last entry, which is cut
        slot2row = torch.full((ep * Cs + 1,), tk, dtype=torch.long,
                              device=dev).scatter_(
            0, slot, torch.arange(tk, device=dev))[:ep * Cs]
        if _DROP_MONITOR is not None:
            stats = torch.stack([(slot == ep * Cs).sum().float(),
                                 torch.full((), float(tk), device=dev)])
            if batch_group is not None:
                comm.all_reduce(stats, group=batch_group)
            _DROP_MONITOR(stats[0] / stats[1])
        send_x = buffer_exchange_kdup(xt, slot2row // k, slot.reshape(t, k))
        send_e = torch.where(
            slot2row < tk,
            (flat_e % E_l).index_select(0, slot2row.clamp(max=tk - 1)),
            torch.full_like(slot2row, E_l))
        recv_x = comm.all_to_all_autograd(send_x, expert_group)
        recv_e = comm.all_to_all_single(send_e, expert_group)
        ro, rinv, rc = expert_sort(recv_e, E_l + 1)
        rx = permute_rows(recv_x, ro, rinv)
    y_r = ragged_expert_ffn(rx, rc[:E_l].contiguous(), experts, activation,
                            use_kernels)
    with record_function("moe_combine"):
        y_slots = permute_rows(y_r, rinv, ro)
        y_back = comm.all_to_all_autograd(y_slots, expert_group)
        keep = (slot < ep * Cs).reshape(t, k).float()
        w = gate.weights * keep
        if route_norm:
            w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
        contrib = buffer_exchange(y_back, slot, slot2row) * \
            w.reshape(tk)[:, None].to(dt)
        return contrib.reshape(t, k, H).sum(dim=1)


def _ragged_routed(xt: torch.Tensor, gate_w: torch.Tensor,
                   experts: Dict[str, torch.Tensor],
                   gate_bias: Optional[torch.Tensor], plan, *,
                   activation: str, k: int, score_func: str,
                   route_norm: bool, n_group: int, topk_group: int,
                   use_kernels: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropless routed experts on this rank's tokens xt [t, H] → (y,
    aux): local, per-rank sort with the global aux, or expert-parallel."""
    E = gate_w.shape[1]
    with record_function("moe_gate"):
        gate = _gate_indices(xt, gate_w, gate_bias, k, score_func,
                             route_norm, n_group, topk_group)
    if plan is None:
        y = _ragged_dispatch_local(xt, gate.weights, gate.experts, experts,
                                   activation, use_kernels)
        return y, gate.aux_loss
    batch_axes, ep = plan
    mm = _mesh()
    batch_group = mm.moe_group(batch_axes, "batch") if batch_axes \
        else None
    aux = _aux_over(batch_group, gate.probs,
                    F.one_hot(gate.experts[:, 0], E))
    if ep == 1:
        y = _ragged_dispatch_local(xt, gate.weights, gate.experts, experts,
                                   activation, use_kernels)
        return y, aux
    if experts["w_up"].shape[0] != E // ep:
        raise ValueError(
            f"expert axis {ep}: each rank holds {E // ep} of the {E} "
            f"experts, got {experts['w_up'].shape[0]}")
    y = _ep_dispatch(xt, gate, experts, E, ep,
                     mm.moe_group((mesh_mod.EXPERT_AXIS,), "expert"),
                     batch_group,
                     activation, route_norm, use_kernels)
    return y, aux


def _dense_routed(xt: torch.Tensor, gate_w: torch.Tensor,
                  experts: Dict[str, torch.Tensor],
                  gate_bias: Optional[torch.Tensor], plan, *,
                  activation: str, k: int, capacity_factor: float,
                  min_capacity: int, rng, noise_std: float,
                  score_func: str, route_norm: bool, n_group: int,
                  topk_group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GShard capacity dispatch: [T, E, C] combine and dispatch
    tensors, [E, C, H] buffers, the experts as batched einsums (JAX
    ``moe_ffn`` dense branch); over a sharded batch with JAX's global
    gate."""
    T, E = xt.shape[0], gate_w.shape[1]
    logits = xt.float() @ gate_w.float()
    global_counts = aux_fn = None
    W = r = 0
    if plan is not None:
        batch_axes, ep = plan
        if ep > 1:
            raise later_slice("the dense MoE dispatch under an 'expert' "
                              "mesh axis")
        mm = _mesh()
        group = mm.moe_group(batch_axes, "batch")
        ranks = mm.group_ranks(batch_axes)
        W, r = len(ranks), ranks.index(mm.rank)

        def global_counts(local):
            rows = comm.all_gather(local.contiguous(), group,
                                   tiled=False)          # [W, k, E]
            total = rows.sum(dim=0)
            base = torch.cumsum(total, dim=0) - total + rows[:r].sum(dim=0)
            return base, total[0], T * W

        def aux_fn(probs, mask1):
            return _aux_over(group, probs, mask1)

    # a sharded batch's rows of the draw over the global batch, as JAX's
    # GSPMD gate draws jax.random.normal(rng, global logits.shape)
    noise = None
    if rng is not None and noise_std > 0.0:
        noise = G.gate_noise(rng, (T * max(W, 1), E))[r * T:(r + 1) * T]
    gate: GateOutput = topk_gating(
        logits, k=k, capacity_factor=capacity_factor,
        min_capacity=min_capacity, rng=rng, noise_std=noise_std,
        normalize=route_norm, score_func=score_func, select_bias=gate_bias,
        n_group=n_group, topk_group=topk_group, global_counts=global_counts,
        noise=noise, aux_fn=aux_fn)
    dt = xt.dtype
    xe = torch.einsum("tec,th->ech", gate.dispatch.to(dt), xt)
    up = torch.einsum("ech,ehf->ecf", xe, experts["w_up"].to(dt))
    g = (torch.einsum("ech,ehf->ecf", xe, experts["w_gate"].to(dt))
         if "w_gate" in experts else None)
    act = _expert_act(up, g, activation)
    ye = torch.einsum("ecf,efh->ech", act, experts["w_down"].to(dt))
    y = torch.einsum("tec,ech->th", gate.combine.to(dt), ye)
    return y, gate.aux_loss


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor,
            experts: Dict[str, torch.Tensor], activation: str = "gelu",
            k: int = 2, capacity_factor: float = 1.25, min_capacity: int = 4,
            rng: Optional[torch.Generator] = None, noise_std: float = 0.0,
            score_func: str = "softmax", route_norm: bool = True,
            route_scale: float = 1.0,
            shared: Optional[Dict[str, torch.Tensor]] = None,
            gate_bias: Optional[torch.Tensor] = None,
            n_group: int = 1, topk_group: int = 1, dispatch: str = "auto",
            use_kernels: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixture-of-experts FFN (JAX's signature, plus ``use_kernels``).

    x [B, S, H] (this rank's rows); gate_w [H, E]; experts: w_up
    [E, H, F], w_down [E, F, H], optional w_gate [E, H, F] (swiglu) — under
    an ``expert`` axis of X ranks, this rank's E/X of them. Returns (y
    [B, S, H], aux loss). ``dispatch`` 'auto' | 'ragged' | 'dense';
    ``capacity_factor`` / ``min_capacity`` and noisy gating (``rng`` a
    ``torch.Generator``, ``noise_std``) belong to the dense gate.
    ``route_scale`` scales the routed output; ``shared`` adds an always-on
    expert (sw_up [H, Fs], sw_down [Fs, H], optional sw_gate [H, Fs] and
    shared_gate_w [H, 1], a sigmoid gate). ``use_kernels=False`` runs the
    grouped GEMMs' plain versions."""
    B, S, H = x.shape
    dt = x.dtype
    E = gate_w.shape[1]
    xt = x.reshape(B * S, H)
    mode = resolve_dispatch(dispatch, rng, noise_std, B, S, E)
    kind, plan = ragged_mesh_plan(_mesh(), B, S, E)
    if kind == "indivisible":
        raise ValueError(f"n_experts={E} not divisible by the expert mesh "
                         "axis")
    if mode == "ragged":
        y, aux = _ragged_routed(
            xt, gate_w, experts, gate_bias, plan, activation=activation,
            k=k, score_func=score_func, route_norm=route_norm,
            n_group=n_group, topk_group=topk_group, use_kernels=use_kernels)
    else:
        y, aux = _dense_routed(
            xt, gate_w, experts, gate_bias, plan, activation=activation,
            k=k, capacity_factor=capacity_factor, min_capacity=min_capacity,
            rng=rng, noise_std=noise_std, score_func=score_func,
            route_norm=route_norm, n_group=n_group, topk_group=topk_group)
    if route_scale != 1.0:
        # the scale rounded to the compute dtype on the host, as JAX's
        # jnp.asarray(route_scale, dt), then a Python float: no copy
        y = y * torch.tensor(route_scale, dtype=dt).item()
    if shared:
        ys = _dense_ffn(xt, shared["sw_up"], shared["sw_down"],
                        shared.get("sw_gate"), activation)
        if "shared_gate_w" in shared:
            sg = torch.sigmoid(xt.float() @ shared["shared_gate_w"].float())
            ys = ys * sg.to(dt)
        y = y + ys
    return y.reshape(B, S, H), aux
