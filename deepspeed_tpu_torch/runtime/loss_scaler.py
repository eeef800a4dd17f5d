"""Static + dynamic loss scaling for fp16 training, global grad norm, clip.

Ports ``deepspeed_tpu/runtime/loss_scaler.py`` (reference
``runtime/fp16/loss_scaler.py``). The JAX scaler state is a pytree carried
inside the jitted step with a ``lax.cond`` skip branch; in eager PyTorch the
state is a few host numbers and the engine decides the skip on the host
(one device-to-host read of the grad norm per fp16 step). The norm and the
clip stay tensor ops on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass
class LossScaleState:
    scale: float          # current loss scale
    good_steps: int       # consecutive overflow-free steps
    hysteresis: int       # remaining tolerated overflows

    @staticmethod
    def create(initial_scale: float, hysteresis: int = 2) -> "LossScaleState":
        return LossScaleState(scale=float(initial_scale), good_steps=0,
                              hysteresis=int(hysteresis))


@dataclasses.dataclass
class DynamicLossScaler:
    """Config + update rules (the state lives in the engine)."""

    initial_scale: float = 2.0 ** 16
    scale_factor: float = 2.0
    scale_window: int = 1000
    min_scale: float = 1.0
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    dynamic: bool = True

    @staticmethod
    def from_config(fp16_config) -> "DynamicLossScaler":
        if not fp16_config.dynamic_loss_scale:
            return DynamicLossScaler(initial_scale=fp16_config.loss_scale,
                                     dynamic=False)
        return DynamicLossScaler(
            initial_scale=2.0 ** fp16_config.initial_scale_power,
            scale_window=fp16_config.loss_scale_window,
            min_scale=fp16_config.min_loss_scale,
            hysteresis=fp16_config.hysteresis,
            consecutive_hysteresis=fp16_config.consecutive_hysteresis,
        )

    def init_state(self) -> LossScaleState:
        return LossScaleState.create(self.initial_scale, self.hysteresis)

    def update(self, state: LossScaleState, overflow: bool) -> LossScaleState:
        if not self.dynamic:
            return state
        if overflow:
            hyst = state.hysteresis - 1
            scale = (max(state.scale / self.scale_factor, self.min_scale)
                     if hyst <= 0 else state.scale)
            return LossScaleState(scale=scale, good_steps=0,
                                  hysteresis=max(hyst, 1))
        good = state.good_steps + 1
        scale = (state.scale * self.scale_factor
                 if good % self.scale_window == 0 else state.scale)
        hyst = self.hysteresis if self.consecutive_hysteresis \
            else state.hysteresis
        return LossScaleState(scale=scale, good_steps=good, hysteresis=hyst)


def global_grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every gradient (fp32 sums), a 0-dim device tensor."""
    total = None
    for g in grads:
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> None:
    """Scale every gradient in place by min(1, max_norm / (norm + 1e-6))
    (in fp32, written back in each gradient's dtype)."""
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        if g.dtype == torch.float32:
            g.mul_(factor)
        else:
            g.copy_(g.float() * factor)
