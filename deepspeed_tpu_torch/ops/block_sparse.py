"""Block-sparse attention: the layout builders, the CUDA kernels' wrappers,
their plain PyTorch versions, and the differentiable
``block_sparse_attention``.

Ports ``deepspeed_tpu/ops/pallas/block_sparse.py`` — the numpy layout
builders (copied: they are host configuration) and ``_fwd_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` behind the ``jax.custom_vjp``
``_sparse_attn`` — to the ``block_sparse_*`` kernels of
``ops/csrc/flash_attention.cu`` (the flash kernels' bodies walking the
layout's active squares) behind one ``torch.autograd.Function``.

Semantics are the Pallas kernels': flash attention restricted to the
``block`` x ``block`` squares that an [nq, nkv] {0,1} layout marks active,
the causal mask inside diagonal squares, ``col < seq_len``; a row with no
active square gives o = 0 and lse = -1e30 (``NEG_INF``, not -inf), and
gradients are 0 outside the layout.

The kernels take q [B, S, N, D] and k/v [B, S, K, D] through their strides
(K divides N: query head n reads kv head n // (N/K), dk/dv summed over the
group in the block), so the model path's transposes are views and GQA needs
no repeat. The layout's CSR rows (forward, dq) and CSC columns (dkv) are
built on the host once per (layout, device) and cached on the device.
D in {64, 128}, block a multiple of 64, on the card; the plain versions take
any. :func:`block_sparse_fwd` / :func:`block_sparse_bwd` run the plain
versions for tensors on the CPU and launch the kernels for tensors on a CUDA
device — or raise; they never fall back. ``launches`` counts kernel
launches per kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import on_device
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops import flash_attention as PF

NEG_INF = -1e30
KERNEL_BLOCK = 64           # the kernels' block sizes are multiples of this

launches: Dict[str, int] = {"block_sparse_fwd": 0, "block_sparse_bwd_dq": 0,
                            "block_sparse_bwd_dkv": 0}

# --------------------------------------------------------------------------- #
# layout builders (copies of the JAX package's, bit for bit)
# --------------------------------------------------------------------------- #


def dense_layout(n_blocks: int) -> np.ndarray:
    return np.ones((n_blocks, n_blocks), np.int32)


def fixed_layout(n_blocks: int, local_window: int = 4,
                 global_stride: int = 4) -> np.ndarray:
    """'Fixed' pattern: local banded window + periodic global columns
    (reference ``FixedSparsityConfig``)."""
    lay = np.zeros((n_blocks, n_blocks), np.int32)
    for i in range(n_blocks):
        lo = max(0, i - local_window + 1)
        lay[i, lo:i + 1] = 1
    lay[:, ::global_stride] = 1
    return np.ascontiguousarray(np.tril(lay) + np.triu(lay, 1) * lay)


def bigbird_layout(n_blocks: int, num_random: int = 2, num_local: int = 3,
                   num_global: int = 1, seed: int = 0) -> np.ndarray:
    """BigBird: global + sliding window + random blocks
    (reference ``BigBirdSparsityConfig``)."""
    rng = np.random.RandomState(seed)
    lay = np.zeros((n_blocks, n_blocks), np.int32)
    half = num_local // 2
    for i in range(n_blocks):
        lay[i, max(0, i - half):min(n_blocks, i + half + 1)] = 1
        if num_random > 0:
            lay[i, rng.choice(n_blocks, size=min(num_random, n_blocks),
                              replace=False)] = 1
    lay[:num_global, :] = 1
    lay[:, :num_global] = 1
    return lay


def bslongformer_layout(n_blocks: int, window: int = 3,
                        global_blocks: Tuple[int, ...] = (0,)) -> np.ndarray:
    """BSLongformer: symmetric sliding window + designated global blocks
    (reference ``BSLongformerSparsityConfig``)."""
    lay = np.zeros((n_blocks, n_blocks), np.int32)
    half = window // 2
    for i in range(n_blocks):
        lay[i, max(0, i - half):min(n_blocks, i + half + 1)] = 1
    for g in global_blocks:
        lay[g, :] = 1
        lay[:, g] = 1
    return lay


def variable_layout(n_blocks: int, local_windows: Tuple[int, ...] = (4,),
                    global_indices: Tuple[int, ...] = (0,)) -> np.ndarray:
    """Variable: per-row local windows cycling through ``local_windows`` +
    global columns (reference ``VariableSparsityConfig``)."""
    lay = np.zeros((n_blocks, n_blocks), np.int32)
    for i in range(n_blocks):
        w = local_windows[i % len(local_windows)]
        lay[i, max(0, i - w + 1):i + 1] = 1
    for g in global_indices:
        lay[:, g] = 1
    return lay


def causal_layout(layout: np.ndarray) -> np.ndarray:
    """Restrict any layout to the lower block triangle (decoder use)."""
    return np.ascontiguousarray(np.tril(layout).astype(np.int32))


# the model path's kinds (``attention="sparse:<kind>"``), as in JAX
MODEL_LAYOUTS = {"fixed": fixed_layout, "bigbird": bigbird_layout,
                 "bslongformer": bslongformer_layout}


# --------------------------------------------------------------------------- #
# plain versions: the Pallas kernels' fp32 arithmetic as whole tensors
# --------------------------------------------------------------------------- #

def _as_layout(layout) -> np.ndarray:
    if isinstance(layout, torch.Tensor):
        layout = layout.detach().cpu().numpy()
    return np.asarray(layout, np.int32)


def _mask(layout: np.ndarray, block: int, S: int, causal: bool,
          device) -> torch.Tensor:
    """[S, S] bool: the layout's active squares, and col <= row if causal."""
    lay = torch.from_numpy(np.asarray(layout) != 0).to(device)
    mask = lay.repeat_interleave(block, 0).repeat_interleave(block, 1)
    if causal:
        mask = mask & PF._mask(S, S, True, device)
    return mask


def block_sparse_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         layout, block: int, causal: bool = True,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, S, N, D] in q's dtype, lse fp32 [B*N, S]) for q [B, S, N, D],
    k/v [B, S, K, D]. A row with no active square gives o = 0 and
    lse = -1e30."""
    scale = _default_scale(q, scale)
    return PF.masked_fwd_ref(q, k, v, _mask(_as_layout(layout), block,
                                            q.shape[1], causal, q.device),
                             scale)


def block_sparse_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                         layout, block: int, causal: bool = True,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the dtypes of q, k, v: p recomputed from lse, delta =
    rowsum(do * o), dk and dv summed over each GQA group; 0 outside the
    layout."""
    scale = _default_scale(q, scale)
    return PF.masked_bwd_ref(q, k, v, o, lse, do,
                             _mask(_as_layout(layout), block, q.shape[1],
                                   causal, q.device), scale)


def _default_scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #

_fns: Dict[str, object] = {}     # bound C entry points, set at first launch
# (leading pointers, strided operands) of each entry point
_ARGS = {"dstpu_block_sparse_fwd": (5, 3), "dstpu_block_sparse_bwd_dq": (7, 4),
         "dstpu_block_sparse_bwd_dkv": (8, 4)}
# device lists of each (layout, device): (row_ptr, col_idx, col_ptr, row_idx)
_lists: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def _bind(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("flash_attention"), name)
        n_ptr, n_strided = _ARGS[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * (3 * n_strided)
                       + [ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_void_p] * 2
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def layout_lists(layout, device) -> Tuple[torch.Tensor, ...]:
    """int32 (row_ptr [nq+1], col_idx, col_ptr [nkv+1], row_idx) of a layout
    on ``device``: its active squares by row (CSR, column order) and by
    column (CSC, row order). Built once per (layout, device) and cached, so
    a training step uploads nothing."""
    lay = _as_layout(layout)
    key = (lay.shape, lay.tobytes(), str(device))
    got = _lists.get(key)
    if got is None:
        nz = lay != 0
        row_ptr = np.concatenate([[0], np.cumsum(nz.sum(1))])
        col_ptr = np.concatenate([[0], np.cumsum(nz.sum(0))])
        col_idx = np.nonzero(nz)[1]
        row_idx = np.nonzero(nz.T)[1]
        got = tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                    for a in (row_ptr, col_idx, col_ptr, row_idx))
        _lists[key] = got
    return got


def _check_block(q: torch.Tensor, layout: np.ndarray, block: int) -> None:
    S = q.shape[1]
    if block % KERNEL_BLOCK:
        raise ValueError(f"block-sparse attention: block {block}; the kernels "
                         f"take multiples of {KERNEL_BLOCK}")
    if S % block or layout.shape != (S // block, S // block):
        raise ValueError(f"block-sparse attention: layout {layout.shape} and "
                         f"block {block} do not tile seq len {S}")


def _launched(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def _on_cuda(q: torch.Tensor, fn: str) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    return True


def block_sparse_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layout, block: int, causal: bool = True,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the plain version on the CPU, the CUDA kernel on a GPU."""
    if not _on_cuda(q, "block_sparse_fwd"):
        return block_sparse_fwd_ref(q, k, v, layout, block, causal, scale)
    lay = _as_layout(layout)
    PF._check(q, k, v, what="block-sparse attention")
    _check_block(q, lay, block)
    B, S, N, D = q.shape
    row_ptr, col_idx, _, _ = layout_lists(lay, q.device)
    o = torch.empty(B, S, N, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B * N, S, dtype=torch.float32, device=q.device)
    with on_device(q.device):
        err = _bind("dstpu_block_sparse_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, S, N, k.shape[2], D, *PF._strides(q),
            *PF._strides(k), *PF._strides(v), _default_scale(q, scale),
            int(causal), row_ptr.data_ptr(), col_idx.data_ptr(), block,
            PF._DTYPES[q.dtype], PF._stream(q))
    _launched("block_sparse_fwd", err)
    return o, lse


def block_sparse_bwd_dq(q, k, v, do, lse, delta, layout, block: int,
                        causal: bool = True, scale: Optional[float] = None):
    """dq from one launch of the dq kernel (CUDA tensors only)."""
    lay = _as_layout(layout)
    PF._check_bwd(q, k, v, do, lse, delta, what="block-sparse attention")
    _check_block(q, lay, block)
    row_ptr, col_idx, _, _ = layout_lists(lay, q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with on_device(q.device):
        err = _bind("dstpu_block_sparse_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *PF._bwd_args(q, k), *PF._strides(v), *PF._strides(do),
            _default_scale(q, scale), int(causal), row_ptr.data_ptr(),
            col_idx.data_ptr(), block, PF._DTYPES[q.dtype], PF._stream(q))
    _launched("block_sparse_bwd_dq", err)
    return dq


def block_sparse_bwd_dkv(q, k, v, do, lse, delta, layout, block: int,
                         causal: bool = True, scale: Optional[float] = None):
    """(dk, dv) from one launch of the dkv kernel (CUDA tensors only)."""
    lay = _as_layout(layout)
    PF._check_bwd(q, k, v, do, lse, delta, what="block-sparse attention")
    _check_block(q, lay, block)
    _, _, col_ptr, row_idx = layout_lists(lay, q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    with on_device(q.device):
        err = _bind("dstpu_block_sparse_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *PF._bwd_args(q, k), *PF._strides(v), *PF._strides(do),
            _default_scale(q, scale), int(causal), col_ptr.data_ptr(),
            row_idx.data_ptr(), block, PF._DTYPES[q.dtype], PF._stream(q))
    _launched("block_sparse_bwd_dkv", err)
    return dk, dv


def block_sparse_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     layout, block: int, causal: bool = True,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the plain version on the CPU; on a GPU delta =
    rowsum(do * o) (one PyTorch reduction, as JAX leaves it to XLA), then
    the dq kernel and the dk+dv kernel."""
    if not _on_cuda(q, "block_sparse_bwd"):
        return block_sparse_bwd_ref(q, k, v, o, lse, do, layout, block,
                                    causal, scale)
    delta = PF.flash_bwd_delta(o, do)
    dq = block_sparse_bwd_dq(q, k, v, do, lse, delta, layout, block, causal,
                             scale)
    dk, dv = block_sparse_bwd_dkv(q, k, v, do, lse, delta, layout, block,
                                  causal, scale)
    return dq, dk, dv


class _BlockSparse(torch.autograd.Function):
    """The ``jax.custom_vjp`` ``_sparse_attn``: forward saves (q, k, v, o,
    lse); backward recomputes p from lse."""

    @staticmethod
    def forward(ctx, q, k, v, layout, block, causal, scale):
        o, lse = block_sparse_fwd(q, k, v, layout, block, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (layout, block, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = block_sparse_bwd(q, k, v, o, lse, do.contiguous(),
                                      *ctx.args)
        return dq, dk, dv, None, None, None, None


def _validate(q: torch.Tensor, k: torch.Tensor, layout, block_size: int
              ) -> np.ndarray:
    """JAX's ``ValueError``s (S not a multiple of the block, a layout of the
    wrong shape) on q [B, S, N, D]."""
    s = q.shape[1]
    if s % block_size:
        raise ValueError(f"seq len {s} not a multiple of block {block_size}")
    n_blocks = s // block_size
    lay = _as_layout(layout)
    if lay.shape != (n_blocks, n_blocks):
        raise ValueError(f"layout {lay.shape} != {(n_blocks, n_blocks)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not divisible by kv heads "
                         f"{k.shape[2]}")
    return lay


def sparse_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout,
                  block_size: int, causal: bool = True,
                  scale: Optional[float] = None,
                  use_kernels: bool = True) -> torch.Tensor:
    """Block-sparse attention on the model layout: q [B, S, N, D], k/v
    [B, S, K, D] → [B, S, N, D]. ``use_kernels=False`` runs the plain
    version under autograd on any device (the card's kernel-vs-plain
    checks)."""
    lay = _validate(q, k, layout, block_size)
    if not use_kernels:
        return block_sparse_fwd_ref(q, k, v, lay, block_size, causal,
                                    scale)[0]
    return _BlockSparse.apply(q, k, v, lay, block_size, bool(causal), scale)


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           layout, block_size: int = 128, causal: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse attention over a [n_blocks, n_blocks] {0,1} layout.

    q: [batch, heads, seq, head_dim], k/v: [batch, kv_heads, seq, head_dim]
    (kv_heads divides heads); seq must be a multiple of ``block_size``.
    Returns [batch, heads, seq, dim] (a transposed view of the kernels'
    [B, S, N, D] output). Layout rows with no active block produce zero
    output rows."""
    out = sparse_attend(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), layout, block_size, causal, scale)
    return out.transpose(1, 2)


def block_sparse_attention_reference(q, k, v, layout, block_size=128,
                                     causal=True, scale=None):
    """The plain version on [B, H, S, D] (JAX's
    ``block_sparse_attention_reference``: the full mask materialized)."""
    o, _ = block_sparse_fwd_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), layout, block_size,
                                causal, scale)
    return o.transpose(1, 2)


def sparse_attention(kind: str = "fixed", use_kernels: bool = True):
    """The model path's attention for ``attention="sparse:<kind>"`` (JAX
    ``models/api.py`` ``sparse_attn``): ``fn(q, k, v, causal=True,
    block_size=64)`` on [B, S, N, D] with the ``kind`` layout for S //
    block_size blocks, restricted by ``causal_layout`` when causal. GQA
    reads kv head n // (N/K) in place where JAX repeats kv heads; the
    results are the same."""
    if kind not in MODEL_LAYOUTS:
        raise ValueError(f"unknown sparse pattern {kind!r}; "
                         f"supported: {sorted(MODEL_LAYOUTS)}")

    # one layout per (sequence length, causal): the callers never write it
    @functools.lru_cache(maxsize=None)
    def layout_for(n_blocks: int, causal: bool) -> np.ndarray:
        lay = MODEL_LAYOUTS[kind](n_blocks)
        return causal_layout(lay) if causal else lay

    def sparse_attn(q, k, v, causal=True, block_size=64):
        lay = layout_for(q.shape[1] // block_size, bool(causal))
        return sparse_attend(q, k, v, lay, block_size, causal,
                             use_kernels=use_kernels)

    return sparse_attn
