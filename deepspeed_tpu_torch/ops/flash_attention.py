"""Flash attention: the CUDA kernels' wrappers, their plain PyTorch versions,
and the differentiable ``flash_attention``.

Ports ``deepspeed_tpu/ops/pallas/flash_attention.py`` — ``_fwd_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` behind the ``jax.custom_vjp``
``_flash`` — to the hand-written CUDA kernels in
``ops/csrc/flash_attention.cu`` behind one ``torch.autograd.Function``.

Layouts are the JAX package's: q [B, S, N, D], k/v [B, Skv, K, D] (K
divides N: GQA, query head n reads kv head n // (N/K)); lse is the forward's
per-row logsumexp, fp32 [B*N, S] (the Pallas kernel's [B*N, S, 1] without
the trailing 1). The kernels read q/k/v through their strides and mask the
ragged edge, so no transpose, repeat or padding copy happens here.

:func:`flash_fwd` / :func:`flash_bwd` run the plain versions
(:func:`flash_fwd_ref` / :func:`flash_bwd_ref`) for tensors on the CPU and
launch the kernels for tensors on a CUDA device — or raise; they never fall
back. ``launches`` counts kernel launches per kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.accelerator import on_device
from deepspeed_tpu_torch.ops import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

launches: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}


# --------------------------------------------------------------------------- #
# plain versions: the Pallas kernels' fp32 arithmetic as whole tensors
# --------------------------------------------------------------------------- #

def _scale(D: int) -> float:
    return 1.0 / math.sqrt(D)


def _mask(Sq: int, Skv: int, causal: bool, device) -> torch.Tensor:
    """[Sq, Skv] bool: key col < Skv always; col <= row when causal (the
    Pallas ``_block_mask``, top-left aligned)."""
    if not causal:
        return torch.ones(Sq, Skv, dtype=torch.bool, device=device)
    row = torch.arange(Sq, device=device)[:, None]
    col = torch.arange(Skv, device=device)[None, :]
    return col <= row


def _heads_first(x: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, S, K, D] → fp32 [B, K*rep, S, D] (kv head k serves query heads
    k*rep .. k*rep+rep-1)."""
    x = x.float()
    if rep > 1:
        x = x.repeat_interleave(rep, dim=2)
    return x.transpose(1, 2)


def masked_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of every attention kernel here under an [Sq, Skv] bool
    ``mask``: (o [B, S, N, D] in q's dtype, lse fp32 [B*N, S]). A row with
    no valid key gives o = 0 and lse = -1e30 (the Pallas ``_finalize``)."""
    B, Sq, N, D = q.shape
    rep = N // k.shape[2]
    q32 = q.float().transpose(1, 2)                       # [B, N, Sq, D]
    k32, v32 = _heads_first(k, rep), _heads_first(v, rep)
    s = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones((), device=q.device), l)
    o = torch.matmul(p, v32) / l_safe                     # [B, N, Sq, D]
    lse = torch.where(empty, torch.full((), NEG_INF, device=q.device),
                      m + torch.log(l_safe))
    return (o.transpose(1, 2).to(q.dtype),
            lse.reshape(B * N, Sq))


def masked_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   mask: torch.Tensor, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the dtypes of q, k, v under an [Sq, Skv] bool
    ``mask``; p recomputed from lse, delta = rowsum(do * o) in fp32, dk and
    dv summed over each GQA group."""
    B, Sq, N, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    rep = N // K
    q32 = q.float().transpose(1, 2)
    do32 = do.float().transpose(1, 2)
    k32, v32 = _heads_first(k, rep), _heads_first(v, rep)
    s = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse.reshape(B, N, Sq, 1)),
                    torch.zeros((), device=q.device))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, k32).transpose(1, 2)                # [B, Sq, N, D]
    dk = torch.matmul(ds.transpose(-1, -2), q32)              # [B, N, Skv, D]
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dk = dk.reshape(B, K, rep, Skv, D).sum(2).transpose(1, 2)
    dv = dv.reshape(B, K, rep, Skv, D).sum(2).transpose(1, 2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, S, N, D] in q's dtype, lse fp32 [B*N, S]). A row with no valid
    key gives o = 0 and lse = -1e30 (the Pallas ``_finalize``)."""
    return masked_fwd_ref(q, k, v, _mask(q.shape[1], k.shape[1], causal,
                                         q.device), _scale(q.shape[3]))


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the dtypes of q, k, v; p recomputed from lse, delta =
    rowsum(do * o) in fp32, dk and dv summed over each GQA group."""
    return masked_bwd_ref(q, k, v, o, lse, do,
                          _mask(q.shape[1], k.shape[1], causal, q.device),
                          _scale(q.shape[3]))


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #

_fns: Dict[str, object] = {}     # bound C entry points, set at first launch

_PTRS = {"dstpu_flash_fwd": 5, "dstpu_flash_bwd_dq": 7,
         "dstpu_flash_bwd_dkv": 8}
_STRIDED = {"dstpu_flash_fwd": 3, "dstpu_flash_bwd_dq": 4,
            "dstpu_flash_bwd_dkv": 4}


def _bind(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("flash_attention"), name)
        fn.argtypes = ([ctypes.c_void_p] * _PTRS[name] + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * (3 * _STRIDED[name])
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(q, k, v, *more, what: str = "flash attention") -> None:
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"{what}: want q [B, S, N, D] and k/v [B, Skv, K, D], "
            f"got q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, N, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or N % k.shape[2]:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (batch, head dim, "
                         "or kv heads not dividing q heads)")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype}; the kernels take "
                        "float32 or bfloat16")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D}; the kernels take "
                         f"D in {_HEAD_DIMS}")
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)) + more:
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.stride(3) != 1 or any(t.stride(i) % align for i in range(3)) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{what}: {name} must have a contiguous head dim "
                "and 16-byte aligned rows (strides "
                f"{tuple(t.stride())})")


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _launched(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the plain version on the CPU, the CUDA kernel on a GPU."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    _check(q, k, v)
    B, Sq, N, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    o = torch.empty(B, Sq, N, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B * N, Sq, dtype=torch.float32, device=q.device)
    with on_device(q.device):
        err = _bind("dstpu_flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Sq, Skv, N, K, D, *_strides(q), *_strides(k),
            *_strides(v), _scale(D), int(causal), _DTYPES[q.dtype],
            _stream(q))
    _launched("flash_fwd", err)
    return o, lse


def flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in fp32, [B*N, S]: one PyTorch reduction
    before the backward launches, as the JAX package leaves it to XLA."""
    B, S, N, _ = o.shape
    return torch.einsum("bsnd,bsnd->bns", do.float(), o.float()) \
        .reshape(B * N, S).contiguous()


def _check_bwd(q, k, v, do, lse, delta,
               what: str = "flash attention") -> None:
    _check(q, k, v, ("do", do), what=what)
    B, Sq, N, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B * N, Sq) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{what} backward: {name} must be contiguous "
                             f"float32 [{B * N}, {Sq}] on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _bwd_args(q, k):
    B, Sq, N, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    return (B, Sq, Skv, N, K, D, *_strides(q), *_strides(k))


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True):
    """dq from one launch of the dq kernel (CUDA tensors only)."""
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with on_device(q.device):
        err = _bind("dstpu_flash_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_bwd_args(q, k), *_strides(v), *_strides(do),
            _scale(q.shape[3]), int(causal), _DTYPES[q.dtype], _stream(q))
    _launched("flash_bwd_dq", err)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """(dk, dv) from one launch of the dkv kernel (CUDA tensors only)."""
    _check_bwd(q, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    with on_device(q.device):
        err = _bind("dstpu_flash_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_bwd_args(q, k), *_strides(v), *_strides(do),
            _scale(q.shape[3]), int(causal), _DTYPES[q.dtype], _stream(q))
    _launched("flash_bwd_dkv", err)
    return dk, dv


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the plain version on the CPU; on a GPU delta, then the
    dq kernel and the dk+dv kernel."""
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, o, lse, do, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    delta = flash_bwd_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The ``jax.custom_vjp`` ``_flash``: forward saves (q, k, v, o, lse);
    backward recomputes p from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The plain path: :func:`flash_fwd_ref` on any device, differentiated
    by autograd (``use_kernels=False`` models and the card's checks)."""
    return flash_fwd_ref(q, k, v, causal)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    segment_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Drop-in for ``models.transformer.dot_product_attention`` (the JAX
    signature and layout): q [B, S, N, D], k/v [B, S, K, D] → [B, S, N, D].
    An arbitrary ``segment_mask`` goes to the plain attention, as in JAX;
    the kernels take causal or full attention only."""
    if segment_mask is not None:
        from deepspeed_tpu_torch.models.transformer import (
            dot_product_attention,
        )

        return dot_product_attention(q, k, v, causal=causal,
                                     segment_mask=segment_mask)
    N, K = q.shape[2], k.shape[2]
    if N % K != 0:
        raise ValueError(f"q heads {N} not divisible by kv heads {K}")
    return _Flash.apply(q, k, v, bool(causal))
