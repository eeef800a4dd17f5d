"""Grouped GEMM for the dropless MoE FFN: the CUDA kernels' wrappers, their
plain PyTorch versions, and the differentiable ``grouped_matmul``.

Ports the grouped GEMM the JAX package's MoE runs on
(``deepspeed_tpu/moe/layer.py`` ``grouped_dot``: megablox ``gmm`` on a TPU,
``lax.ragged_dot`` elsewhere) and megablox's custom VJP (``gmm`` with
``transpose_rhs`` for the input gradient, ``tgmm`` for the weight gradient)
to the hand-written kernels in ``ops/csrc/grouped_gemm.cu``.

Rows of ``lhs`` are sorted by group: group e owns the contiguous rows
[off_e, off_e + group_sizes[e]), off_e the exclusive prefix sum of the
int32 ``group_sizes`` [E] (a negative size counts as empty, offsets are
clamped to M). Rows past ``sum(group_sizes)`` come out as zeros, as under
``lax.ragged_dot``. Products are summed in fp32 and rounded once to the
output dtype (the inputs').

* :func:`gmm` — ``out[rows of e] = lhs[rows of e] @ rhs[e]``, rhs
  [E, K, N]; with ``transpose_rhs`` rhs is [E, N, K] and the product takes
  ``rhs[e]ᵀ``.
* :func:`tgmm` — ``out[e] = lhs[rows of e]ᵀ @ grad[rows of e]`` → [E, K, N];
  an empty group gives zeros, as ``ragged_dot``'s VJP does.

Both run their plain versions (:func:`gmm_ref`, :func:`tgmm_ref`) for
tensors on the CPU and launch the kernels for tensors on a CUDA device — or
raise; they never fall back. ``launches["gmm"]`` / ``launches["tgmm"]``
count kernel launches. The kernels read ``group_sizes`` on the device: no
launch reads it back to the host.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from deepspeed_tpu_torch.accelerator import on_device
from deepspeed_tpu_torch.ops import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_ROW_TILE = 128          # the kernels' output tile rows (BM in the source)

launches: Dict[str, int] = {"gmm": 0, "tgmm": 0}


# --------------------------------------------------------------------------- #
# plain versions: one torch.mm per group on narrowed row ranges
# --------------------------------------------------------------------------- #

def _bounds(group_sizes: torch.Tensor, M: int):
    """[(start, end)] of each group's rows, clamped to [0, M] (host ints)."""
    out, off = [], 0
    for s in group_sizes.tolist():
        start = min(off, M)
        off += max(int(s), 0)
        out.append((start, min(off, M)))
    return out


def gmm_ref(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
            transpose_rhs: bool = False) -> torch.Tensor:
    """The kernel's function: per group, the fp32 product of the upcast
    operands (exact products, fp32 sums), rounded once to ``lhs.dtype``;
    rows past the groups are zeros. Differentiable by autograd."""
    M, N = lhs.shape[0], rhs.shape[1 if transpose_rhs else 2]
    bounds = _bounds(group_sizes, M)
    parts = []
    for e, (start, end) in enumerate(bounds):
        w = rhs[e].float()
        parts.append(torch.mm(lhs[start:end].float(),
                              w.t() if transpose_rhs else w))
    tail = M - (bounds[-1][1] if bounds else 0)
    parts.append(lhs.new_zeros((tail, N), dtype=torch.float32))
    return torch.cat(parts).to(lhs.dtype)


def tgmm_ref(lhs: torch.Tensor, grad: torch.Tensor,
             group_sizes: torch.Tensor) -> torch.Tensor:
    """``out[e] = lhs[rows of e]ᵀ @ grad[rows of e]`` → [E, K, N] in
    ``lhs.dtype``, fp32 sums; an empty group gives zeros."""
    M = lhs.shape[0]
    return torch.stack([
        torch.mm(lhs[start:end].float().t(), grad[start:end].float())
        for start, end in _bounds(group_sizes, M)]).to(lhs.dtype)


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #

_fns: Dict[str, object] = {}     # bound C entry points, set at first launch


def _bind(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("grouped_gemm"), name)
        n_int = 6 if name == "dstpu_gmm" else 5
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(name: str, a: torch.Tensor, b: torch.Tensor,
           group_sizes: torch.Tensor, E: int, K: int, N: int) -> None:
    if a.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {a.dtype}; the kernels take float32 "
                        "or bfloat16")
    for label, t in (("rhs", b), ("group_sizes", group_sizes)):
        if t.device != a.device:
            raise ValueError(f"{name}: {label} on {t.device}, lhs on "
                             f"{a.device}")
    if b.dtype != a.dtype:
        raise TypeError(f"{name}: operands are {a.dtype} and {b.dtype}; the "
                        "kernels take one dtype (cast the weights first)")
    if group_sizes.dtype != torch.int32 or group_sizes.dim() != 1 \
            or group_sizes.numel() != E or not group_sizes.is_contiguous():
        raise ValueError(f"{name}: group_sizes must be a contiguous int32 "
                         f"[{E}] tensor, got {group_sizes.dtype} "
                         f"{tuple(group_sizes.shape)}")
    for label, t in (("lhs", a), ("rhs", b)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and "
                             "16-byte aligned")
    if K % 8 or N % 8:
        raise ValueError(f"{name}: K {K} and N {N} must be multiples of 8 "
                         "(16-byte rows)")


def _launched(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
        transpose_rhs: bool = False) -> torch.Tensor:
    """lhs [M, K] @ rhs[e] ([E, K, N], or [E, N, K] with ``transpose_rhs``)
    per group → [M, N] in ``lhs.dtype``: the plain version on the CPU, the
    CUDA kernel on a GPU."""
    if lhs.dim() != 2 or rhs.dim() != 3 \
            or lhs.shape[1] != rhs.shape[2 if transpose_rhs else 1]:
        raise ValueError(f"gmm: want lhs [M, K] and rhs [E, "
                         f"{'N, K' if transpose_rhs else 'K, N'}], got "
                         f"{tuple(lhs.shape)} and {tuple(rhs.shape)}")
    if lhs.device.type == "cpu":
        return gmm_ref(lhs, rhs, group_sizes, transpose_rhs)
    if lhs.device.type != "cuda":
        raise ValueError(f"gmm: unsupported device {lhs.device}")
    E = rhs.shape[0]
    M, K = lhs.shape
    N = rhs.shape[1 if transpose_rhs else 2]
    _check("gmm", lhs, rhs, group_sizes, E, K, N)
    if -(-M // _ROW_TILE) + E > _MAX_GRID_Y:
        raise ValueError(f"gmm: {M} rows in {E} groups exceed the grid")
    out = torch.empty(M, N, dtype=lhs.dtype, device=lhs.device)
    if M == 0 or N == 0:
        return out
    with on_device(lhs.device):
        err = _bind("dstpu_gmm")(
            lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), M, K, N, E, int(bool(transpose_rhs)),
            _DTYPES[lhs.dtype],
            torch.cuda.current_stream(lhs.device).cuda_stream)
    _launched("gmm", err)
    return out


def tgmm(lhs: torch.Tensor, grad: torch.Tensor,
         group_sizes: torch.Tensor) -> torch.Tensor:
    """lhs [M, K], grad [M, N] → [E, K, N] in ``lhs.dtype``,
    ``out[e] = lhs[rows of e]ᵀ @ grad[rows of e]``: the plain version on the
    CPU, the CUDA kernel on a GPU."""
    if lhs.dim() != 2 or grad.dim() != 2 or lhs.shape[0] != grad.shape[0]:
        raise ValueError(f"tgmm: want lhs [M, K] and grad [M, N], got "
                         f"{tuple(lhs.shape)} and {tuple(grad.shape)}")
    if lhs.device.type == "cpu":
        return tgmm_ref(lhs, grad, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"tgmm: unsupported device {lhs.device}")
    E = group_sizes.numel()
    M, K = lhs.shape
    N = grad.shape[1]
    _check("tgmm", lhs, grad, group_sizes, E, K, N)
    out = torch.empty(E, K, N, dtype=lhs.dtype, device=lhs.device)
    if out.numel() == 0:
        return out
    with on_device(lhs.device):
        err = _bind("dstpu_tgmm")(
            lhs.data_ptr(), grad.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), M, K, N, E, _DTYPES[lhs.dtype],
            torch.cuda.current_stream(lhs.device).cuda_stream)
    _launched("tgmm", err)
    return out


class _GroupedMatmul(torch.autograd.Function):
    """Megablox's ``gmm`` custom VJP: dlhs = gmm(grad, rhs, transpose_rhs),
    drhs = tgmm(lhs, grad), each launched only when its input needs it."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes = ctx.saved_tensors
        grad = grad.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm(grad, rhs, group_sizes, transpose_rhs=True)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs, grad, group_sizes)
        return dlhs, drhs, None


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """Differentiable grouped GEMM ``lhs[rows of e] @ rhs[e]`` → [M, N]
    through the kernels (the plain versions for CPU tensors)."""
    if rhs.dtype != lhs.dtype:
        raise TypeError(f"grouped_matmul: lhs {lhs.dtype}, rhs {rhs.dtype}; "
                        "cast the weights to the compute dtype first")
    return _GroupedMatmul.apply(lhs, rhs, group_sizes)
