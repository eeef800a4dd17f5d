"""DeepSpeedTPUEngine — the single-process training engine of the port.

Ports the single-process subset of ``deepspeed_tpu/runtime/engine.py``
(``DeepSpeedTPUEngine``; the class name is kept so its counterpart is easy
to find): ``_init_state`` (:1709), ``_compute_params`` (:1736),
``_loss_and_grads`` (:1783), ``accumulate_microbatches`` (:1946),
``_apply_update`` (:1832), ``train_batch`` (:2626), ``train_batches``
(:2719), ``global_steps`` / ``micro_steps``. One step:

    gas micro-batches of forward → LM loss → backward (remat per layer)
    → fp32 gradient accumulation → unscale, global norm, clip (fp16:
    overflow skip + dynamic loss scale) → fused-Adam update of the fp32
    master → compute-dtype copy for the next step's forward

State layout (the multi-tensor-apply analog): master (fp32), each Adam
moment (fp32), the gradient accumulator (fp32, or ``data_types.
grad_accum_dtype``), the compute copy and the per-micro-batch gradient
(compute dtype) are ONE flat buffer each. Every parameter is a view into
them, so the optimizer is one kernel launch over the whole model with no
flatten copy. The forward's parameters are per-layer leaves — layer l of
``blocks.wq [L, H, N·D]`` is its own leaf, a view into the compute buffer —
whose ``.grad`` is preset to the matching view of the gradient buffer:
autograd accumulates each gradient in place there (indexing a stacked
[L, ...] tensor inside the layer loop would make every layer's backward
allocate and add a zero tensor of the whole stack).

Gradient semantics match the JAX engine, which differentiates the fp32
master through ``astype(compute dtype)``: each micro-batch's gradient is
rounded to the compute dtype, added into the fp32 accumulator, and divided
by gas × loss scale in the update. The compute copy is cast once per step
(by the Adam kernel itself for bf16), which gives the values the JAX
per-micro-batch cast gives.

Out of this slice, raising ``NotImplementedError``: ZeRO stage >= 2, more
than one process, offload, ZenFlow, ZeRO++ wires, remat policies other than
none/full, and the config sections ``load_config`` refuses.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.models.api import ModelSpec
from deepspeed_tpu_torch.ops.optimizer import TPUOptimizer, get_optimizer
from deepspeed_tpu_torch.runtime.config import (
    ActivationCheckpointingConfig,
    DeepSpeedTPUConfig,
    load_config,
)
from deepspeed_tpu_torch.runtime.config_utils import later_slice, logger
from deepspeed_tpu_torch.runtime.dataloader import stack_micros
from deepspeed_tpu_torch.runtime.loss_scaler import (
    DynamicLossScaler,
    clip_by_global_norm,
    global_grad_norm,
)
from deepspeed_tpu_torch.runtime.lr_schedules import (
    LRSchedule,
    get_lr_schedule,
)

_ALIGN = 64            # elements: every parameter view starts 256-byte aligned
_DTYPE_ALIAS = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}
_STACKED = "blocks"    # top-level key whose leaves stack the layers


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """(path, tensor) in sorted-key order (the JAX tree-flatten order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _world_size() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


@dataclasses.dataclass
class _Slot:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    offset: int

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))


class DeepSpeedTPUEngine:
    def __init__(self, model: ModelSpec, config: Any,
                 optimizer: Optional[TPUOptimizer] = None,
                 lr_scheduler: Optional[LRSchedule] = None,
                 seed: Optional[int] = None, device=None):
        self.config: DeepSpeedTPUConfig = load_config(config)
        self.device = resolve_device(device)
        self._check_slice()
        self.dp_world_size = 1
        self.config.resolve_batch_size(self.dp_world_size)
        self.zero_stage = self.config.zero_optimization.stage

        # activation_checkpointing.policy → the spec's remat policy, rebuilt
        # through the spec's own builder (as the JAX engine does)
        ac_policy = self.config.activation_checkpointing.policy
        if ac_policy and ac_policy != "none":
            spec_cfg = getattr(model, "config", None)
            if spec_cfg is None or getattr(spec_cfg, "remat", None) != ac_policy:
                if model.builder is None:
                    raise ValueError(
                        f"activation_checkpointing.policy={ac_policy!r}: the "
                        "model spec carries no builder to rebuild with")
                model = model.builder(remat=ac_policy)
        self.model_spec = model

        self.precision = self.config.precision_dtype
        self.fp16_enabled = self.precision == "float16"
        self.compute_dtype = getattr(torch, self.precision)
        self.scaler = DynamicLossScaler.from_config(self.config.fp16) \
            if self.fp16_enabled else None
        self._scaler_state = self.scaler.init_state() if self.scaler else None

        if optimizer is None:
            opt_cfg = self.config.optimizer
            if opt_cfg is None:
                raise ValueError("config must define an optimizer (or pass "
                                 "one in)")
            optimizer = get_optimizer(opt_cfg.type, opt_cfg.params)
        self.optimizer = optimizer
        if lr_scheduler is None and self.config.scheduler \
                and self.config.scheduler.type:
            lr_scheduler = get_lr_schedule(
                self.config.scheduler.type, self.config.scheduler.params,
                base_lr=self.optimizer.lr)
        self.lr_scheduler = lr_scheduler

        seed = self.config.seed if seed is None else seed
        self._init_state(seed)

        self.global_steps = 0
        self.micro_steps = 0
        self._skips = 0
        self._last_metrics: Dict[str, Any] = {}
        logger.info(
            f"engine up: model={model.name} params={model.num_params or '?'} "
            f"zero_stage={self.zero_stage} precision={self.precision} "
            f"device={self.device} flat elements={self._numel}")

    # ------------------------------------------------------------------ #
    def _check_slice(self) -> None:
        """Options of the JAX engine that this slice does not run."""
        cfg = self.config
        z = cfg.zero_optimization
        if _world_size() > 1:
            raise later_slice("training on more than one process")
        if z.stage >= 2:
            raise later_slice(f"zero_optimization.stage={z.stage} (this "
                              "slice runs stages 0 and 1)")
        for name, off in (("offload_optimizer", z.offload_optimizer),
                          ("offload_param", z.offload_param)):
            if off.device not in ("none", None) or off.host_step:
                raise later_slice(f"zero_optimization.{name}")
        for key in ("super_offload", "zero_quantized_weights",
                    "zero_quantized_gradients",
                    "zero_quantized_nontrainable_weights",
                    "loco_error_feedback"):
            if getattr(z, key):
                raise later_slice(f"zero_optimization.{key}")
        if z.zenflow.enabled:
            raise later_slice("zero_optimization.zenflow")
        if z.mics_shard_size > 1 or z.zero_hpz_partition_size > 1:
            raise later_slice("ZeRO subgroups (mics_shard_size / "
                              "zero_hpz_partition_size)")
        ac = cfg.activation_checkpointing
        if ac.policy not in T.REMAT_POLICIES:
            raise later_slice(f"activation_checkpointing.policy={ac.policy!r}"
                              " (this slice runs none|full)")
        if dataclasses.replace(ac, policy="none") \
                != ActivationCheckpointingConfig():
            raise later_slice("activation_checkpointing options other than "
                              "policy")
        if cfg.precision_dtype == "bfloat16" and not cfg.bf16.fp32_master:
            raise later_slice("bf16.fp32_master=false (needs a "
                              "stochastic-rounding optimizer)")

    # ------------------------------------------------------------------ #
    # state: flat buffers and the views into them
    # ------------------------------------------------------------------ #
    def _accum_dtype(self) -> torch.dtype:
        """GAS accumulator dtype: fp32, or ``data_types.grad_accum_dtype``
        (with the reference's bf16/fp16/fp32 spellings)."""
        name = self.config.data_types.grad_accum_dtype
        return getattr(torch, _DTYPE_ALIAS.get(name, name)) if name \
            else torch.float32

    def _init_state(self, seed: int) -> None:
        gen = torch.Generator(self.device).manual_seed(seed)
        tree = self.model_spec.init_fn(gen, self.device)
        self._slots: List[_Slot] = []
        off = 0
        for path, t in _flatten(tree):
            self._slots.append(_Slot(path, tuple(t.shape), off))
            off += -(-t.numel() // _ALIGN) * _ALIGN
        self._numel = off
        dev = self.device
        self.flat_master = torch.zeros(off, dtype=torch.float32, device=dev)
        self.flat_compute = torch.zeros(off, dtype=self.compute_dtype,
                                        device=dev)
        self.flat_grad = torch.zeros(off, dtype=self.compute_dtype, device=dev)
        self.flat_grad_acc = torch.zeros(off, dtype=self._accum_dtype(),
                                         device=dev)
        self.state: Dict[str, Any] = {
            "step": 0, "master": self._views(self.flat_master),
            "opt": self.optimizer.init(self.flat_master)}
        for slot, (_, t) in zip(self._slots, _flatten(tree)):
            self._view(self.flat_master, slot).copy_(t)
        del tree
        self._params = self._leaves()
        self._compute_params()

    def _view(self, flat: torch.Tensor, slot: _Slot) -> torch.Tensor:
        return flat[slot.offset:slot.offset + slot.numel].view(slot.shape)

    def _views(self, flat: torch.Tensor) -> Dict[str, Any]:
        """The parameter tree (JAX keys and shapes) as views into ``flat``."""
        tree: Dict[str, Any] = {}
        for slot in self._slots:
            _set_path(tree, slot.path, self._view(flat, slot))
        return tree

    def _leaves(self) -> Dict[str, Any]:
        """The forward's parameter tree: views into the compute buffer as
        autograd leaves, their ``.grad`` preset to the matching views of the
        gradient buffer; ``blocks`` is a list of per-layer dicts."""
        def leaf(value: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
            t = value.detach().requires_grad_(True)
            t.grad = grad
            return t

        tree: Dict[str, Any] = {}
        layers: List[Dict[str, Any]] = []
        for slot in self._slots:
            value = self._view(self.flat_compute, slot)
            grad = self._view(self.flat_grad, slot)
            if slot.path[0] == _STACKED:
                for layer in range(slot.shape[0]):
                    while len(layers) <= layer:
                        layers.append({})
                    _set_path(layers[layer], slot.path[1:],
                              leaf(value[layer], grad[layer]))
            else:
                _set_path(tree, slot.path, leaf(value, grad))
        if layers:
            tree[_STACKED] = layers
        return tree

    def _compute_params(self) -> None:
        """``_compute_params``: the compute copy of the master."""
        with torch.no_grad():
            self.flat_compute.copy_(self.flat_master)

    # ------------------------------------------------------------------ #
    # public batch-size / state queries (reference engine API)
    # ------------------------------------------------------------------ #
    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def train_micro_batch_size(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def get_lr(self) -> List[float]:
        if self.lr_scheduler is not None:
            return [float(self.lr_scheduler.lr_at(self.global_steps))]
        return [self.optimizer.lr]

    def get_global_grad_norm(self) -> Optional[float]:
        norm = self._last_metrics.get("grad_norm")
        return None if norm is None else float(norm)

    @property
    def skipped_steps(self) -> int:
        return self._skips

    @property
    def loss_scale(self) -> float:
        return self._scaler_state.scale if self.fp16_enabled else 1.0

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #
    def _to_device(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.ascontiguousarray(batch))
        return batch.to(self.device, non_blocking=True)

    def _loss_and_grads(self, mb, scale: Optional[float]) -> torch.Tensor:
        """One micro-batch: forward, loss, backward. The gradient of the
        (scaled) loss lands in ``flat_grad`` in the compute dtype; returns
        the unscaled loss."""
        self.flat_grad.zero_()
        loss = self.model_spec.loss_fn(self._params, mb)
        (loss * scale if scale is not None else loss).backward()
        return loss.detach()

    @staticmethod
    def accumulate_microbatches(micro_fn, acc: torch.Tensor, grad: torch.Tensor,
                                batch, gas: int) -> torch.Tensor:
        """The JAX ``accumulate_microbatches``: for each micro-batch along
        the leading axis, ``micro_fn(mb) → loss`` leaves its gradient in
        ``grad``, which is added into ``acc`` in ``acc``'s dtype. Returns the
        mean loss."""
        losses = []
        for i in range(gas):
            mb = ({k: v[i] for k, v in batch.items()}
                  if isinstance(batch, dict) else batch[i])
            losses.append(micro_fn(mb))
            acc.add_(grad)
        return losses[0] if gas == 1 else torch.stack(losses).mean()

    def _lr_at(self, step: int) -> float:
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler.lr_at(step))
        return float(self.optimizer.lr)

    def _apply_update(self, grads: torch.Tensor, grad_scale: float
                      ) -> Dict[str, Any]:
        """Unscale, global norm, clip, (fp16: skip on overflow), optimizer
        update, compute copy."""
        scale_t = torch.full((), grad_scale, dtype=torch.float32,
                             device=self.device)
        if grads.dtype == torch.float32:
            g = grads.div_(scale_t)        # true division, as in JAX
        else:
            g = grads.float() / scale_t
        lr = self._lr_at(self.state["step"])
        norm = global_grad_norm([g])
        if self.config.gradient_clipping > 0:
            clip_by_global_norm([g], self.config.gradient_clipping, norm)
        overflow = False
        if self.fp16_enabled:
            overflow = not bool(torch.isfinite(norm))   # host read
        if not overflow:
            out = self.flat_compute \
                if self.flat_compute.dtype == torch.bfloat16 else None
            self.optimizer.update(g, self.state["opt"], self.flat_master,
                                  lr=lr, out=out)
            if out is None:
                self._compute_params()
        else:
            self._skips += 1
        metrics: Dict[str, Any] = {"grad_norm": norm, "lr": lr,
                                   "overflow": float(overflow)}
        if self.fp16_enabled:
            self._scaler_state = self.scaler.update(self._scaler_state,
                                                    overflow)
            metrics["loss_scale"] = self._scaler_state.scale
        self.state["step"] += 1
        return metrics

    def train_batch(self, data_iter: Iterator[Any]) -> torch.Tensor:
        """Pull gas micro-batches and run one optimizer step. Returns the
        mean loss (a 0-dim device tensor: reading it synchronises)."""
        gas = self.gradient_accumulation_steps()
        stacked = stack_micros([next(data_iter) for _ in range(gas)])
        return self._dispatch_train_step(stacked, gas)

    def _dispatch_train_step(self, stacked, gas: int) -> torch.Tensor:
        batch = self._to_device(stacked)
        scale = self._scaler_state.scale if self.fp16_enabled else None
        self.flat_grad_acc.zero_()
        mean_loss = self.accumulate_microbatches(
            lambda mb: self._loss_and_grads(mb, scale), self.flat_grad_acc,
            self.flat_grad, batch, gas)
        grad_scale = float(gas) * (scale if scale is not None else 1.0)
        metrics = self._apply_update(self.flat_grad_acc, grad_scale)
        metrics["loss"] = mean_loss
        self.global_steps += 1
        self.micro_steps += gas
        self._after_step(metrics)
        return mean_loss

    def train_batches(self, data_iter: Iterator[Any],
                      n_steps: int) -> torch.Tensor:
        """``n_steps`` optimizer steps; returns their mean loss. A plain loop
        of ``train_batch`` (CUDA graphs of the step come later)."""
        losses = [self.train_batch(data_iter) for _ in range(max(1, n_steps))]
        return losses[0] if len(losses) == 1 else torch.stack(losses).mean()

    def _after_step(self, metrics: Dict[str, Any]) -> None:
        self._last_metrics = metrics
        if self.lr_scheduler is not None:
            self.lr_scheduler.step(self.global_steps)
        if self.global_steps % max(1, self.config.steps_per_print) == 0:
            host = {k: float(v) for k, v in metrics.items()}
            logger.info(
                f"step={self.global_steps} loss={host['loss']:.4f} "
                f"lr={host['lr']:.3e} grad_norm={host['grad_norm']:.3f}"
                + (f" loss_scale={host['loss_scale']:.0f}"
                   if self.fp16_enabled else ""))
