"""RMSNorm / LayerNorm: Triton forward kernels, their plain versions, and
the gradients.

Ports ``deepspeed_tpu/ops/pallas/norms.py`` (``_rms_kernel`` / ``_ln_kernel``
via ``rms_norm`` / ``layer_norm``). The function is
``models/transformer.py:_norm``: fp32 statistics, scale (and bias) read in
their own dtype and applied in fp32, the result cast back to x's dtype.

The gradients port the JAX package's analytic VJPs ``_rms_bwd`` /
``_ln_bwd``, which are jnp beside the Pallas forward, not kernels: here they
are plain PyTorch (fp32 math, dscale and dbias summed over rows) in the
backward of a ``torch.autograd.Function`` around the forward wrapper. The
wrappers take that Function only when autograd needs it, so serving under
``torch.no_grad`` launches exactly the forward kernel.

What bounds it on the H100: bytes — one read and one write of [R, H] and a
few flops per element. Eager PyTorch runs the same expression as about six
launches with fp32 intermediates written to device memory; the kernel reads
each row once into registers (one program per row, ``BLOCK_H`` =
next_pow2(H), masked coalesced vector loads), reduces in fp32 and writes
once. No tensor cores, TMA or copy pipeline are needed for that.

The wrappers run the plain version for a CPU tensor and launch the kernel
for a CUDA tensor, or raise. ``launches`` counts kernel launches. Triton is
imported, and the kernels compiled, at the first launch only.
"""
import os
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from deepspeed_tpu_torch.accelerator import on_device
from deepspeed_tpu_torch.ops import build

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_H = 65536

launches: Dict[str, int] = {"rms_norm": 0, "layer_norm": 0}
# calls of the (plain PyTorch) backward: not kernel launches, so apart
backward_calls: Dict[str, int] = {"rms_norm": 0, "layer_norm": 0}

triton = tl = None          # bound at the first launch (see _kernels)
_compiled: Optional[Dict[str, object]] = None


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layer_norm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


# Triton kernel sources: plain functions here, ``triton.jit``-ed at first use
# so that this module imports where Triton is absent.
def _rms_norm_fwd(X, S, Y, H, eps, BLOCK_H: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_H)
    mask = cols < H
    x = tl.load(X + row * H + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / H
    rstd = 1.0 / tl.sqrt(var + eps)
    s = tl.load(S + cols, mask=mask, other=0.0).to(tl.float32)
    y = x * rstd * s
    tl.store(Y + row * H + cols, y.to(Y.dtype.element_ty), mask=mask)


def _layer_norm_fwd(X, S, B, Y, H, eps, BLOCK_H: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_H)
    mask = cols < H
    x = tl.load(X + row * H + cols, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / H
    xc = tl.where(mask, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / H
    rstd = 1.0 / tl.sqrt(var + eps)
    s = tl.load(S + cols, mask=mask, other=0.0).to(tl.float32)
    b = tl.load(B + cols, mask=mask, other=0.0).to(tl.float32)
    y = xc * rstd * s + b
    tl.store(Y + row * H + cols, y.to(Y.dtype.element_ty), mask=mask)


def _kernels() -> Dict[str, object]:
    global triton, tl, _compiled
    if _compiled is None:
        # Triton's compile cache lives beside the CUDA builds, inside the
        # checkout, unless the caller chose another place
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(build.build_dir() / "triton"))
        import triton as _triton
        import triton.language as _tl

        triton, tl = _triton, _tl
        _compiled = {"rms_norm": triton.jit(_rms_norm_fwd),
                     "layer_norm": triton.jit(_layer_norm_fwd)}
    return _compiled


def _check(name: str, x: torch.Tensor, *params: torch.Tensor) -> int:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x dtype {x.dtype}; the kernel takes "
                        "float32 or bfloat16")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous [..., H]")
    H = x.shape[-1]
    if not 0 < H <= _MAX_H:
        raise ValueError(f"{name}: H={H} outside (0, {_MAX_H}]")
    for p in params:
        if p.device != x.device or tuple(p.shape) != (H,) \
                or not p.is_contiguous() or p.dtype not in _DTYPES:
            raise ValueError(
                f"{name}: scale/bias must be contiguous [{H}] float32 or "
                f"bfloat16 on {x.device}, got {p.dtype} {tuple(p.shape)} on "
                f"{p.device}")
    return H


def _launch(name: str, x: torch.Tensor, eps: float,
            *params: torch.Tensor) -> torch.Tensor:
    H = _check(name, x, *params)
    out = torch.empty_like(x)
    R = x.numel() // H
    if R:
        block_h = 1 << (H - 1).bit_length()
        warps = 8 if block_h >= 4096 else 4 if block_h >= 1024 else 2
        kernel = (_compiled or _kernels())[name]
        with on_device(x.device):
            kernel[(R,)](x, *params, out, H, float(eps),
                         BLOCK_H=block_h, num_warps=warps)
        launches[name] += 1
    return out


def _rms_forward(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rms_norm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    return _launch("rms_norm", x, eps, scale)


def _ln_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return layer_norm_ref(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    return _launch("layer_norm", x, eps, scale, bias)


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                 eps: float = 1e-5):
    """``_rms_bwd``: (dx in x's dtype, dscale in scale's dtype)."""
    H = x.shape[-1]
    x32, g32 = x.float(), g.float()
    inv = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    xhat = x32 * inv
    gs = g32 * scale.float()
    dx = inv * (gs - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    dscale = (g32 * xhat).reshape(-1, H).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                   eps: float = 1e-5):
    """``_ln_bwd``: (dx, dscale, dbias), dscale/dbias in scale's dtype."""
    H = x.shape[-1]
    x32, g32 = x.float(), g.float()
    mean = x32.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((x32 - mean).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (x32 - mean) * inv
    gs = g32 * scale.float()
    dx = inv * (gs - gs.mean(dim=-1, keepdim=True)
                - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    dscale = (g32 * xhat).reshape(-1, H).sum(dim=0)
    dbias = g32.reshape(-1, H).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with record_function("norm_backward"):
            dx, dscale = rms_norm_bwd(x, scale, g, ctx.eps)
        backward_calls["rms_norm"] += 1
        return dx, dscale, None


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _ln_forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with record_function("norm_backward"):
            dx, dscale, dbias = layer_norm_bwd(x, scale, g, ctx.eps)
        backward_calls["layer_norm"] += 1
        return dx, dscale, dbias, None


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x [..., H] * rsqrt(mean(x²) + eps) * scale, fp32 stats;
    differentiable (backward :func:`rms_norm_bwd`)."""
    if _needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    return _rms_forward(x, scale, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias, fp32 stats;
    differentiable (backward :func:`layer_norm_bwd`)."""
    if _needs_grad(x, scale, bias):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _ln_forward(x, scale, bias, eps)
