"""MoE expert layer: the dropless ragged dispatch on one process.

Ports the local path of ``deepspeed_tpu/moe/layer.py`` ``moe_ffn`` (:752):
``grouped_dot`` (:136), ``ragged_expert_ffn`` (:189), ``expert_sort``
(:213), ``dispatch_gather`` (:321) and ``combine_gather`` (:346) with their
gather-only backward passes, ``_expert_act``, ``_dense_ffn`` (the shared
expert), ``_gate_indices`` (:532) and ``_ragged_dispatch_local`` (:377).

One layer: the fp32 router picks k experts per token; a counting sort lays
the T·k token choices out by expert; each expert weight is applied by ONE
grouped GEMM (``ops/grouped_gemm.py``, the hand-written CUDA kernels on a
card) over the expert-sorted rows; the combine gathers each token's k rows
back, weighted by the gate. No [T, E, C] tensor, no capacity, no dropped
token. Both directions of dispatch and combine are gathers and sums, as in
JAX, never ``index_add_``: CUDA's atomics would make the gradients change
from run to run.

Casts follow the JAX package: router logits in fp32 from fp32 upcasts,
expert weights cast to the compute dtype before the GEMMs, combine weights
cast to the compute dtype, and the combine's weight gradient summed in fp32
before its cast.

Later slices (each raises ``NotImplementedError``): ``dispatch="dense"``
(the GShard capacity einsums), noisy gating, and every mesh lowering —
expert parallelism over ``torch.distributed`` and the per-shard sort.
``dispatch="auto"`` resolves to ragged, as it does in JAX without a mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from deepspeed_tpu_torch.moe.gating import IndexGateOutput, topk_gating_indices
from deepspeed_tpu_torch.ops import grouped_gemm as GG
from deepspeed_tpu_torch.runtime.config_utils import later_slice


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


def resolve_dispatch(dispatch: str, rng=None, noise_std: float = 0.0) -> str:
    """'auto' → 'ragged' (what JAX resolves to without a mesh); 'ragged'
    stays; 'dense' and noisy gating are later slices."""
    if dispatch not in ("auto", "ragged", "dense"):
        raise ValueError(
            f"moe dispatch must be auto|ragged|dense, got {dispatch!r}")
    if dispatch == "dense":
        raise later_slice("the dense GShard MoE dispatch (dispatch='dense')")
    if rng is not None and noise_std > 0.0:
        raise later_slice("noisy gating (noise_std > 0)")
    return "ragged"


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor,
            experts: Dict[str, torch.Tensor], activation: str = "gelu",
            k: int = 2, rng=None, noise_std: float = 0.0,
            score_func: str = "softmax",
            route_norm: bool = True, route_scale: float = 1.0,
            shared: Optional[Dict[str, torch.Tensor]] = None,
            gate_bias: Optional[torch.Tensor] = None,
            n_group: int = 1, topk_group: int = 1, dispatch: str = "auto",
            use_kernels: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixture-of-experts FFN (the JAX signature, less the dense dispatch's
    ``capacity_factor`` and ``min_capacity``).

    x [B, S, H]; gate_w [H, E]; experts: w_up [E, H, F], w_down [E, F, H],
    optional w_gate [E, H, F] (swiglu). Returns (y [B, S, H], aux loss).
    ``route_scale`` scales the routed output; ``shared`` adds an always-on
    expert (sw_up [H, Fs], sw_down [Fs, H], optional sw_gate [H, Fs] and
    shared_gate_w [H, 1], a sigmoid gate). ``use_kernels=False`` runs the
    grouped GEMMs' plain versions."""
    resolve_dispatch(dispatch, rng, noise_std)
    B, S, H = x.shape
    dt = x.dtype
    xt = x.reshape(B * S, H)
    with record_function("moe_gate"):
        gate = _gate_indices(xt, gate_w, gate_bias, k, score_func,
                             route_norm, n_group, topk_group)
    y = _ragged_dispatch_local(xt, gate.weights, gate.experts, experts,
                               activation, use_kernels)
    if route_scale != 1.0:
        y = y * torch.tensor(route_scale, dtype=dt, device=y.device)
    if shared:
        ys = _dense_ffn(xt, shared["sw_up"], shared["sw_down"],
                        shared.get("sw_gate"), activation)
        if "shared_gate_w" in shared:
            sg = torch.sigmoid(xt.float() @ shared["shared_gate_w"].float())
            ys = ys * sg.to(dt)
        y = y + ys
    return y.reshape(B, S, H), gate.aux_loss
