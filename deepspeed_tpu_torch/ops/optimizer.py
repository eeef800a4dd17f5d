"""Optimizers of the port: Adam / AdamW through the fused-Adam kernel.

Ports ``deepspeed_tpu/ops/optimizer.py`` — ``TPUOptimizer`` (:33),
``FusedAdam`` (:56) with its ``adam_w_mode`` semantics and arithmetic order
(``upd = (m / bc1) / (sqrt(v / bc2) + eps)``, ``bc = 1 - beta ** step`` in
fp32; not the ``torch.optim`` form), and ``get_optimizer`` (:483) for adam,
adamw and fusedadam. The other optimizers of the JAX registry raise
``NotImplementedError`` naming the later slice.

State layout: the engine keeps master, gradients and each moment as one
flat fp32 buffer (every parameter a view into them), so ``update`` is one
in-place call of :func:`~deepspeed_tpu_torch.ops.fused_adam.fused_adam`:
the CUDA kernel for CUDA state, its plain version for CPU state.
``host_update`` is the host-executed step's: the same update through the
compiled host library (``ops/cpu_adam.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import cpu_adam
from deepspeed_tpu_torch.ops.fused_adam import bias_corrections, fused_adam
from deepspeed_tpu_torch.runtime.config_utils import later_slice, logger


@dataclasses.dataclass
class TPUOptimizer:
    """Base: subclasses define the update; state holds one flat buffer per
    moment (``moment_names``) and the step count."""

    lr: float = 1e-3
    weight_decay: float = 0.0
    moment_names: Tuple[str, ...] = ()

    def init(self, params: torch.Tensor) -> Dict[str, Any]:
        state: Dict[str, Any] = {name: torch.zeros_like(params)
                                 for name in self.moment_names}
        state["step"] = 0
        return state

    def update(self, grads: torch.Tensor, state: Dict[str, Any],
               params: torch.Tensor, lr: Optional[float] = None,
               out: Optional[torch.Tensor] = None):
        raise NotImplementedError

    def host_update(self, grads: torch.Tensor, state: Dict[str, Any],
                    params: torch.Tensor, lr: Optional[float] = None,
                    out: Optional[torch.Tensor] = None,
                    clip: Optional[float] = None,
                    threads: Optional[int] = None):
        """``update`` on flat fp32 host buffers by the host step's
        compiled library (``ops/cpu_adam.py``); ``clip`` scales the
        gradient first."""
        raise NotImplementedError


@dataclasses.dataclass
class FusedAdam(TPUOptimizer):
    """Adam/AdamW (reference ``ops/adam/fused_adam.py``; ``adam_w_mode``
    semantics): decoupled weight decay when ``adam_w_mode``, L2 added to
    the gradient otherwise."""

    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    adam_w_mode: bool = True
    bias_correction: bool = True
    moment_names: Tuple[str, ...] = ("exp_avg", "exp_avg_sq")

    def update(self, grads, state, params, lr=None, out=None):
        """One step, in place, on flat fp32 ``params`` / ``state`` moments
        from flat fp32 ``grads``; ``out`` (bf16, optional) receives the new
        params rounded to bf16. Returns ``(params, state)``."""
        hyper = self.begin_step(state, lr)
        self.apply(params, grads, state["exp_avg"], state["exp_avg_sq"],
                   hyper, out)
        self.end_step(state)
        return params, state

    # the same step by parts (the engines' update buckets and streamed
    # chunks): ``begin_step``, ``apply`` on each part, ``end_step``; an
    # elementwise update, so the parts give the bits of one call
    def begin_step(self, state, lr=None) -> Tuple[float, float, float]:
        """(lr, bc1, bc2) of the step after ``state``'s."""
        lr = self.lr if lr is None else lr
        bc1, bc2 = bias_corrections(state["step"] + 1, self.betas,
                                    self.bias_correction)
        return float(lr), bc1, bc2

    def apply(self, params, grads, m, v, hyper, out=None) -> None:
        lr, bc1, bc2 = hyper
        fused_adam(params, grads, m, v, lr, tuple(self.betas), self.eps,
                   self.weight_decay, bc1, bc2, adam_w=self.adam_w_mode,
                   out=out)

    def end_step(self, state) -> None:
        state["step"] += 1

    def host_update(self, grads, state, params, lr=None, out=None,
                    clip=None, threads=None):
        """``update`` through the C++ host Adam (``ops/cpu_adam.adam``);
        ``out`` of another dtype than bf16 is copied from the new params
        after it."""
        lr = self.lr if lr is None else lr
        step = state["step"] + 1
        bc1, bc2 = bias_corrections(step, self.betas, self.bias_correction)
        bf16 = out is not None and out.dtype == torch.bfloat16
        cpu_adam.adam(params, grads, state["exp_avg"], state["exp_avg_sq"],
                      float(lr), tuple(self.betas), self.eps,
                      self.weight_decay, bc1, bc2, adam_w=self.adam_w_mode,
                      out=out if bf16 else None, clip=clip, threads=threads)
        if out is not None and not bf16:
            out.copy_(params)
        state["step"] = step
        return params, state


_OPTIMIZERS = {"adam": FusedAdam, "adamw": FusedAdam, "fusedadam": FusedAdam}
# the rest of the JAX registry, ported in a later slice
_LATER = ("lion", "fusedlion", "lamb", "fusedlamb", "adagrad", "adafactor",
          "sgd", "muon", "onebitadam", "zerooneadam", "onebitlamb")


def get_optimizer(name: str, params: Dict[str, Any]) -> TPUOptimizer:
    key = name.lower().replace("_", "")
    if key in _LATER:
        raise later_slice(f"optimizer {name!r}")
    if key not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; supported: "
                         f"{sorted(_OPTIMIZERS)}")
    cls = _OPTIMIZERS[key]
    kwargs = dict(params)
    if "betas" in kwargs:
        kwargs["betas"] = tuple(kwargs["betas"])
    kwargs.pop("torch_adam", None)
    field_names = {f.name for f in dataclasses.fields(cls)}
    for k in set(kwargs) - field_names:
        logger.warning(f"optimizer param {k!r} not supported by "
                       f"{cls.__name__} — ignored")
        kwargs.pop(k)
    return cls(**kwargs)
