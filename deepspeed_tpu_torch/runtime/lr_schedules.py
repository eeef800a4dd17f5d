"""LR schedules: LRRangeTest / OneCycle / WarmupLR / WarmupDecayLR / WarmupCosineLR.

Ports ``deepspeed_tpu/runtime/lr_schedules.py`` (reference
``runtime/lr_schedules.py:277-784``): pure ``step → lr`` functions, here on
host Python floats (the engine passes the lr to the update kernel as an
argument, so a new lr never rebuilds anything), wrapped in stateful classes
exposing the reference's ``step()`` / ``get_last_lr()`` / ``state_dict()``
API for user code. The JAX functions compute in fp32; these in double, so
the two agree to fp32 rounding.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional


VALID_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR",
                   "WarmupCosineLR"]


def _clip(x: float) -> float:
    return min(max(x, 0.0), 1.0)


class LRSchedule:
    """Base: holds base lr; subclasses implement lr_at(step) → float."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.last_batch_iteration = -1

    def lr_at(self, step):
        raise NotImplementedError

    # --- torch-like stateful API (reference behavior) ---
    def step(self, last_batch_iteration: Optional[int] = None) -> None:
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self) -> List[float]:
        return [float(self.lr_at(max(0, self.last_batch_iteration)))]

    def get_last_lr(self) -> List[float]:
        return self.get_lr()

    def state_dict(self) -> Dict[str, Any]:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR(LRSchedule):
    """Linear warmup 0→base then constant (reference :672)."""

    def __init__(self, base_lr: float, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = "log", **_):
        super().__init__(warmup_max_lr)
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type

    def _warmup_frac(self, step):
        frac = _clip(float(step) / self.warmup_num_steps)
        if self.warmup_type == "log":
            frac = math.log1p(frac * (math.e - 1.0))
        return frac

    def lr_at(self, step):
        return self.min_lr + (self.max_lr - self.min_lr) * self._warmup_frac(step)


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to 0 at total_num_steps (reference :738)."""

    def __init__(self, base_lr: float, total_num_steps: int = 10000, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.total_num_steps = max(total_num_steps, self.warmup_num_steps)

    def lr_at(self, step):
        warm = super().lr_at(step)
        decay = _clip((self.total_num_steps - float(step))
                      / max(1, self.total_num_steps - self.warmup_num_steps))
        return warm if step < self.warmup_num_steps else self.max_lr * decay


class WarmupCosineLR(LRSchedule):
    """Linear warmup then cosine decay (reference :784)."""

    def __init__(self, base_lr: float, total_num_steps: int = 10000,
                 warmup_min_ratio: float = 0.0, warmup_num_steps: int = 1000,
                 cos_min_ratio: float = 0.0001, **_):
        super().__init__(base_lr)
        self.total_num_steps = total_num_steps
        self.warmup_min_ratio = warmup_min_ratio
        self.warmup_num_steps = max(1, warmup_num_steps)
        self.cos_min_ratio = cos_min_ratio

    def lr_at(self, step):
        step = float(step)
        warm_ratio = self.warmup_min_ratio + (1 - self.warmup_min_ratio) * _clip(
            step / self.warmup_num_steps)
        progress = _clip((step - self.warmup_num_steps)
                         / max(1, self.total_num_steps - self.warmup_num_steps))
        cos_ratio = self.cos_min_ratio + (1 - self.cos_min_ratio) * 0.5 * (
            1 + math.cos(math.pi * progress))
        ratio = warm_ratio if step < self.warmup_num_steps else cos_ratio
        return self.base_lr * ratio


class LRRangeTest(LRSchedule):
    """LR range sweep for tuning (reference :277)."""

    def __init__(self, base_lr: float, lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False, **_):
        super().__init__(lr_range_test_min_lr)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def lr_at(self, step):
        count = float(step) / self.step_size
        if self.staircase:
            count = math.floor(count)
        return self.min_lr * (1 + self.step_rate * count)


class OneCycle(LRSchedule):
    """1-cycle policy (reference :391): lr up then down then decay."""

    def __init__(self, base_lr: float, cycle_min_lr: float = 0.0, cycle_max_lr: float = 0.001,
                 decay_lr_rate: float = 0.0, cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 decay_step_size: int = 0, **_):
        super().__init__(cycle_max_lr)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first = cycle_first_step_size
        self.second = cycle_second_step_size or cycle_first_step_size
        self.decay_step_size = max(decay_step_size, 1)

    def lr_at(self, step):
        step = float(step)
        up = self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * _clip(
            step / self.first)
        down_progress = _clip((step - self.first) / self.second)
        down = self.cycle_max_lr - (self.cycle_max_lr - self.cycle_min_lr) * down_progress
        end_cycle = self.first + self.second
        decay_steps = max(0.0, step - end_cycle) / self.decay_step_size
        decayed = self.cycle_min_lr / (1.0 + self.decay_lr_rate * decay_steps)
        if step <= self.first:
            return up
        return down if step <= end_cycle else decayed


_SCHEDULES = {
    "WarmupLR": WarmupLR,
    "WarmupDecayLR": WarmupDecayLR,
    "WarmupCosineLR": WarmupCosineLR,
    "LRRangeTest": LRRangeTest,
    "OneCycle": OneCycle,
}


def get_lr_schedule(name: Optional[str], params: Dict[str, Any],
                    base_lr: float) -> Optional[LRSchedule]:
    if name is None:
        return None
    if name not in _SCHEDULES:
        raise ValueError(f"unknown scheduler {name!r}; supported: {sorted(_SCHEDULES)}")
    return _SCHEDULES[name](base_lr, **params)
