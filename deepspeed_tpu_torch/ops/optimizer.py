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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

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
        lr = self.lr if lr is None else lr
        step = state["step"] + 1
        bc1, bc2 = bias_corrections(step, self.betas, self.bias_correction)
        fused_adam(params, grads, state["exp_avg"], state["exp_avg_sq"],
                   float(lr), tuple(self.betas), self.eps, self.weight_decay,
                   bc1, bc2, adam_w=self.adam_w_mode, out=out)
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
