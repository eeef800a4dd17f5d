"""DeepSpeedTPUEngine — the training engine of the port, one process or many.

Ports ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedTPUEngine``; the class
name is kept so its counterpart is easy to find): ``_init_state`` (:1709),
``_compute_params`` (:1736), ``_loss_and_grads`` (:1783),
``accumulate_microbatches`` (:1946), ``_apply_update`` (:1832),
``_resolve_compressed_modes`` (:503), ``_wire_format`` (:2101),
``train_batch`` (:2626), ``train_batches`` (:2719), ``global_steps`` /
``micro_steps``. One step:

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

More than one process (the default process group up, world > 1) takes
:class:`DataParallelEngine`: ZeRO stages 0-2 over ``torch.distributed``,
with the exact wire or the ZeRO++ int8 wire (qgZ, qwZ, LoCo); at stage 3
:class:`Zero3Engine`, whose parameters are sharded too and gathered per
use, layer chunk by layer chunk (``parallel/stage3.py``). hpZ / MiCS
(``zero_hpz_partition_size`` / ``mics_shard_size`` above 1) resolve onto
the mesh's ``zshard`` axis, as in JAX (engine.py:87-131): ZeRO state is
sharded within the subgroup and replicated across ``data``, at every
stage. Every engine resolves JAX's overlap-scheduler plan
(``_setup_overlap_scheduler``, ``overlap_plan``): its layer chunks set
qwZ's quantization blocks, ZeRO-3's gathers and, on the exact stage 1-2
wire, the reduces issued during the backward (the other leaves by
``reduce_bucket_size`` buckets); ``overlap_step`` runs the update by
``update_bucket_size`` buckets, each bucket's publish issued as its update
is done. One process at stage 3 shards nothing and runs the stage-0 step,
as JAX at ``data = 1``. ZeRO-3 takes any model spec: ``causal_lm_spec``'s
layer loop gathers by chunks, any other spec gets its whole tree gathered
as one group a forward.

The offload family, as JAX resolves it (engine.py:251-302): the
optimizer tiers ``offload_optimizer`` cpu (each rank's moments in pinned
host memory between steps, brought back just before the update) and nvme
(the moments round-tripped through files, ``runtime/swap_tensor.py`` over
``ops/aio.py``); the ZeRO-3 parameter tier ``offload_param`` cpu / nvme
(the master, or a rank's master shard, in pinned host memory, and through
files between steps under nvme: on a card with the exact wire JAX's
in-step mode, the master streamed to the card a chunk at a time where the
step reads it, never whole there; with the int8 wires JAX's boundary
swap, the master parked between steps);
``offload_states`` / ``reload_states``; ZenFlow's importance-split update
(``runtime/zenflow.py``); and the host-executed step of SuperOffload
(``host_step``, ``runtime/host_step.py``, whose update runs in the
compiled host library ``ops/cpu_adam.py``; ``super_offload`` is cpu +
host_step + overlap_step), for the one-process engine.

Out of this slice, raising ``NotImplementedError``: remat policies other
than none/full, and the config sections ``load_config`` refuses. The qwZ
publish stays one pass after the (bucketed) update.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.accelerator import PinnedHost, resolve_device
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm import mesh as mesh_mod
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.models.api import ModelSpec
from deepspeed_tpu_torch.ops import quant_kernels as QK
from deepspeed_tpu_torch.ops.optimizer import (
    FusedAdam,
    TPUOptimizer,
    get_optimizer,
)
from deepspeed_tpu_torch.parallel import compressed as C
from deepspeed_tpu_torch.parallel import stage3 as S3
from deepspeed_tpu_torch.parallel.overlap import (
    OverlapConfig,
    chunk_layers,
    leaf_count,
    plan_buckets,
)
from deepspeed_tpu_torch.parallel.partitioning import ShardingPolicy
from deepspeed_tpu_torch.runtime.config import (
    ActivationCheckpointingConfig,
    DeepSpeedTPUConfig,
    load_config,
)
from deepspeed_tpu_torch.runtime.config_utils import (
    DeepSpeedConfigError,
    later_slice,
    logger,
)
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
from deepspeed_tpu_torch.runtime.swap_tensor import (
    OptimizerSwapper,
    ParamSwapper,
    Swapped,
)
from deepspeed_tpu_torch.runtime.zenflow import (
    Segment,
    ZenFlowOptimizer,
    maybe_wrap_zenflow,
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


def _process_world() -> int:
    """Processes of the default process group; a ``WORLD_SIZE`` above 1
    without one raises: the engine joins no process group itself."""
    world = comm.get_world_size()
    env = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and env > 1:
        raise RuntimeError(
            f"WORLD_SIZE={env} but the default process group is not "
            "initialized: call deepspeed_tpu_torch.init_distributed() first")
    return world


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
        self._resolve_subgroup()
        self.mesh_manager = mesh_mod.initialize_mesh(
            self.config.mesh.to_mesh_config())
        self.dp_world_size = self.mesh_manager.dp_world_size
        if self.dp_world_size > 1 and not isinstance(self,
                                                     DataParallelEngine):
            raise ValueError(
                f"{self.dp_world_size} processes: build the engine with "
                "deepspeed_tpu_torch.initialize (DataParallelEngine)")
        self.config.resolve_batch_size(self.dp_world_size)
        self.zero_stage = self.config.zero_optimization.stage
        self._resolve_compressed_modes(self.config.zero_optimization)
        self._check_expert_axis(model)

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
        # ZenFlow: importance-split hot/cold updates (runtime/zenflow.py)
        self.optimizer = maybe_wrap_zenflow(
            optimizer, self.config.zero_optimization.zenflow)
        if lr_scheduler is None and self.config.scheduler \
                and self.config.scheduler.type:
            lr_scheduler = get_lr_schedule(
                self.config.scheduler.type, self.config.scheduler.params,
                base_lr=self.optimizer.lr)
        self.lr_scheduler = lr_scheduler

        self._resolve_offload()
        self._host_runner = None
        if self._host_step:
            from deepspeed_tpu_torch.runtime.host_step import HostStepRunner

            if self._compressed:
                raise DeepSpeedConfigError(
                    "host_step cannot combine with compressed collectives")
            self._host_runner = HostStepRunner(self)

        seed = self.config.seed if seed is None else seed
        self._init_state(seed)
        if isinstance(self.optimizer, ZenFlowOptimizer):
            self.optimizer.bind(self._zenflow_segments())
        self._master_parked = False
        self._opt_on_host = False
        #: the host tiers' buffers, one a tensor, locked at first use
        self._host_bufs: Dict[str, PinnedHost] = {}
        self._opt_swapper: Optional[OptimizerSwapper] = None
        self._param_swapper: Optional[ParamSwapper] = None
        if self._offload_opt:
            self._opt_swap("out")
        if self._offload_param:
            self._park_master()

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
        _process_world()
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

    def _check_expert_axis(self, model: ModelSpec) -> None:
        """Under an ``expert`` axis this slice runs the exact ZeRO 0-2 wire
        with the ragged dispatch; what else JAX runs there is a later
        slice."""
        mm = self.mesh_manager
        if mm.ep_world_size <= 1:
            return
        cfg = getattr(model, "config", None)
        what = [name for name, on in (
            ("the ZeRO++ int8 wire (qgZ / qwZ)", self._compressed is not None),
            ("ZeRO-3", self.zero_stage >= 3),
            ("hpZ / MiCS (zshard > 1)",
             mm.axis_size(mesh_mod.ZSHARD_AXIS) > 1),
            ("the dense MoE dispatch", getattr(cfg, "n_experts", 0) > 0
             and getattr(cfg, "moe_dispatch", "auto") == "dense")) if on]
        if what:
            raise later_slice(f"{', '.join(what)} under an 'expert' mesh "
                              "axis")

    def _resolve_offload(self) -> None:
        """The offload tiers, with JAX's resolution and errors
        (engine.py:251-302): ``super_offload`` is cpu + ``host_step`` +
        ``overlap_step`` (an explicit ``overlap_step: false`` is kept, a
        conflicting device raises); ``host_step`` needs ``device='cpu'``;
        ``offload_param`` is a ZeRO-3 tier (below stage 3 it warns and is
        off) on none|cpu|nvme."""
        zcfg = self.config.zero_optimization
        off = zcfg.offload_optimizer
        if zcfg.super_offload:
            if off.device not in ("none", "cpu"):
                raise DeepSpeedConfigError(
                    f"super_offload conflicts with offload_optimizer.device="
                    f"{off.device!r}; it implies device='cpu'")
            off.device, off.host_step = "cpu", True
            if off.overlap_step is None:
                off.overlap_step = True
        if off.host_step and off.device != "cpu":
            raise DeepSpeedConfigError(
                "offload_optimizer.host_step requires device='cpu' (got "
                f"{off.device!r}) — the host CPU backend runs the update")
        self._host_step = off.device == "cpu" and off.host_step
        self._offload_opt = off.device == "cpu" and not self._host_step
        self._offload_nvme = off.device == "nvme"
        pcfg = zcfg.offload_param
        self._offload_param = self._offload_param_nvme = False
        if pcfg.device not in ("none", None):
            if pcfg.device not in ("cpu", "nvme"):
                raise DeepSpeedConfigError(
                    f"offload_param.device must be none|cpu|nvme, got "
                    f"{pcfg.device!r}")
            if self.zero_stage < 3:
                logger.warning(
                    "offload_param is a ZeRO-3 tier (reference "
                    "zero/offload_config.py) but zero_optimization.stage="
                    f"{self.zero_stage} — parameter offload is DISABLED. "
                    "Set stage: 3 to enable it.")
            elif not self._host_step:
                self._offload_param = True
                self._offload_param_nvme = pcfg.device == "nvme"
        # JAX's in-step mode (engine.py:316-318): the master stays in pinned
        # host memory through the step and streams to the card chunk by
        # chunk where the step reads it (``_stream_pass``), on the exact
        # wire; the int8 wires keep the boundary swap (the master parked
        # between steps, whole on the card for the step). ZenFlow's split
        # update reads whole leaves: boundary swap too. JAX streams on its
        # accelerator only; the port on the CPU too (host-to-host copies,
        # the same values), so that its CPU runs drive the mode.
        self._param_stream = (
            self._offload_param and self._compressed is None
            and not isinstance(self.optimizer, ZenFlowOptimizer))
        #: this step's chunk copies of the streamed master: host→device
        #: for the update and for the derived compute copy, device→host of
        #: the updated chunks, and ZeRO-3 fp32 gathers read from the host
        #: master
        self.stream_counts = {"update_h2d": 0, "update_d2h": 0,
                              "derive_h2d": 0, "gather_h2d": 0}
        self._stream_plan: Optional[List[Tuple[int, int]]] = None
        self._stream_bufs: List[torch.Tensor] = []
        self._stream_side = None

    def _resolve_subgroup(self) -> None:
        """MiCS / ZeRO++ hpZ (JAX engine.py:87-131, with its messages): the
        subgroup IS the ``zshard`` mesh axis. ``mics_shard_size`` wins over
        ``zero_hpz_partition_size``; 0 and 1 mean off. A subgroup that
        contradicts an explicit ``mesh.zshard``, does not divide the
        process world or does not fit the mesh raises
        ``DeepSpeedConfigError``: falling back to full-world collectives
        would silently drop the secondary partition.
        ``mics_hierarchical_params_gather`` is accepted and inert, as in
        JAX (the gather's schedule is the backend's choice)."""
        zcfg = self.config.zero_optimization
        subgroup = zcfg.mics_shard_size or (
            zcfg.zero_hpz_partition_size
            if zcfg.zero_hpz_partition_size > 1 else 0)
        if not subgroup:
            return
        key = ("mics_shard_size" if zcfg.mics_shard_size
               else "zero_hpz_partition_size")
        if self.config.mesh.zshard not in (1, subgroup):
            raise DeepSpeedConfigError(
                f"zero_optimization.{key}={subgroup} conflicts with "
                f"mesh.zshard={self.config.mesh.zshard} — the subgroup IS "
                "the 'zshard' axis; set one of them, or make them agree")
        n_dev = _process_world()
        if n_dev % subgroup != 0:
            raise DeepSpeedConfigError(
                f"zero_optimization.{key}={subgroup} must divide the "
                f"device world ({n_dev} devices) — a non-dividing hpZ "
                "subgroup cannot form replica groups, and falling back "
                "to exact full-world collectives would silently drop "
                "the secondary partition")
        self.config.mesh.zshard = subgroup
        try:
            self.config.mesh.to_mesh_config().resolve(n_dev)
        except ValueError as e:
            raise DeepSpeedConfigError(
                f"zero_optimization.{key}={subgroup} does not fit the "
                f"mesh: {e}") from None

    def _resolve_compressed_modes(self, zcfg) -> None:
        """Whether the step uses the ZeRO++ int8 wire (JAX
        ``_resolve_compressed_modes``, engine.py:503, with its log lines
        and warnings): qwZ / qgZ need stage >= 1 and a data-parallel width
        > 1; LoCo needs an active qgZ. Every accepted but inapplicable flag
        warns."""
        shape = self.mesh_manager.shape
        eligible = (self.dp_world_size > 1 and shape.get("seq", 1) == 1
                    and shape.get("pipe", 1) == 1)
        quant_w = bool(zcfg.zero_quantized_weights
                       or zcfg.zero_quantized_nontrainable_weights)
        quant_g = bool(zcfg.zero_quantized_gradients)
        self._compressed: Optional[Dict[str, bool]] = None
        if quant_w or quant_g:
            if self.zero_stage < 1:
                logger.warning(
                    "zero_quantized_weights/gradients require ZeRO stage >= 1 "
                    f"(got stage {self.zero_stage}) — exact collectives used")
            elif not eligible:
                logger.warning(
                    "zero_quantized_weights/gradients need data-parallel width "
                    "> 1 and seq=pipe=1 in the mesh — exact collectives "
                    f"used (mesh={dict(shape)})")
            else:
                self._compressed = {"quant_weights": quant_w,
                                    "quant_grads": quant_g}
                logger.info(f"ZeRO++ compressed collectives active: "
                            f"qwZ={quant_w} qgZ={quant_g} over axes "
                            "('data', 'zshard')")
        if zcfg.loco_error_feedback:
            if self._compressed is not None \
                    and self._compressed["quant_grads"]:
                self._compressed["loco"] = True
                logger.info("LoCo error feedback active for the qgZ reduce "
                            "(reference coalesced_collectives.py:81)")
            else:
                logger.warning(
                    "loco_error_feedback requires an ACTIVE "
                    "zero_quantized_gradients path — ignored")

    def _wire_format(self) -> str:
        """``exact`` / ``qz`` / ``qz+loco`` (JAX's values; its ``onebit``
        comes with the 1-bit optimizers, a later slice)."""
        if self._compressed:
            return "qz+loco" if self._compressed.get("loco") else "qz"
        return "exact"

    # ------------------------------------------------------------------ #
    # the overlap scheduler's plan (JAX engine.py:704-868)
    # ------------------------------------------------------------------ #
    def _setup_overlap_scheduler(self) -> None:
        """JAX's ``_setup_overlap_scheduler``: with ``overlap_comm`` at
        stage >= 1 and a rebuildable multi-layer model, the layer chunks
        from ``stage3_prefetch_bucket_size`` (stage 3) or
        ``allgather_bucket_size`` (stages 1-2) over the ``blocks``
        elements a layer. JAX also marks mid-backward sync points at stage
        >= 2 (``chunk_bounds`` then holds even one chunk). The port gathers
        (qwZ, ZeRO-3) and reduces (ZeRO-3; the exact stage 1-2 wire, with
        the other leaves in ``reduce_bucket_size`` buckets) by these
        chunks. ``step_overlap`` (``overlap_step`` with the scheduler on
        and more than one process, JAX :749-757) runs the update in
        ``update_bucket_size`` buckets, each bucket's exact publish issued
        as its update is done; ``param_buffer`` reads as JAX resolves it
        (the port's compute copy is the publish's buffer). Reads
        ``self._slots``."""
        zcfg = self.config.zero_optimization
        self._overlap = OverlapConfig.from_zero_config(zcfg, self.zero_stage)
        ub = zcfg.update_bucket_size
        self._step_overlap = (bool(zcfg.overlap_step)
                              and self._overlap.enabled
                              and comm.get_world_size() > 1)
        self._param_buffer = (self._step_overlap
                              and self.mesh_manager.shape.get("pipe", 1) == 1
                              and not self._offload_param
                              and not self._host_step)
        self._overlap_plan: Dict[str, Any] = {
            "enabled": self._overlap.enabled, "scan_chunks": 1,
            "chunk_bounds": [], "grad_sync_points": False,
            "step_overlap": self._step_overlap,
            "param_buffer": self._param_buffer,
            "update_bucket_elems": (self._overlap.reduce_bucket_elems
                                    if ub == "auto" else int(ub)),
            "wire_format": self._wire_format()}
        if not self._overlap.enabled:
            return
        spec_cfg = getattr(self.model_spec, "config", None)
        n_layers = getattr(spec_cfg, "num_layers", 0) or 0
        if (self.model_spec.builder is None or spec_cfg is None
                or not hasattr(spec_cfg, "scan_chunks") or n_layers <= 1
                or self.mesh_manager.shape.get("pipe", 1) > 1):
            return
        per_layer = max(sum(leaf_count(self._full_shapes[s.path])
                            for s in self._slots
                            if s.path[0] == _STACKED) // n_layers, 1)
        chunk_elems = (self._overlap.prefetch_bucket_elems
                       if self.zero_stage >= 3
                       else self._overlap.allgather_bucket_elems)
        bounds = chunk_layers(n_layers, per_layer, chunk_elems)
        sync = self.zero_stage >= 2
        if len(bounds) > 1 or sync:
            self._overlap_plan.update(scan_chunks=max(len(bounds), 1),
                                      chunk_bounds=bounds,
                                      grad_sync_points=sync)

    def overlap_plan(self) -> Dict[str, Any]:
        """The resolved plan: chunk bounds, bucket sizes (JAX's
        ``overlap_plan``, engine.py:860)."""
        plan = dict(self._overlap_plan)
        plan.update(reduce_bucket_elems=self._overlap.reduce_bucket_elems,
                    allgather_bucket_elems=self._overlap.allgather_bucket_elems,
                    prefetch_bucket_elems=self._overlap.prefetch_bucket_elems)
        return plan

    # ------------------------------------------------------------------ #
    # state: flat buffers and the views into them
    # ------------------------------------------------------------------ #
    def _accum_dtype(self) -> torch.dtype:
        """GAS accumulator dtype: fp32, or ``data_types.grad_accum_dtype``
        (with the reference's bf16/fp16/fp32 spellings)."""
        name = self.config.data_types.grad_accum_dtype
        return getattr(torch, _DTYPE_ALIAS.get(name, name)) if name \
            else torch.float32

    def _init_tree(self, seed: int) -> Dict[str, Any]:
        """The model's initial fp32 tree from ``seed``; lays out the slots
        of the flat buffers and resolves the overlap plan."""
        gen = torch.Generator(self.device).manual_seed(seed)
        tree = self.model_spec.init_fn(gen, self.device)
        self._full_shapes = {path: tuple(t.shape)
                             for path, t in _flatten(tree)}
        tree = self._local_tree(tree)
        self._slots: List[_Slot] = []
        off = 0
        for path, t in _flatten(tree):
            self._slots.append(_Slot(path, tuple(t.shape), off))
            off += -(-t.numel() // _ALIGN) * _ALIGN
        self._numel = off
        self._setup_overlap_scheduler()
        return tree

    def _local_tree(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """The part of the model's tree this process holds (all of it)."""
        return tree

    def local_leaf(self, path: Tuple[str, ...],
                   full: torch.Tensor) -> torch.Tensor:
        """The part of a whole leaf this process holds (all of it)."""
        return full

    def _init_state(self, seed: int) -> None:
        if self._host_runner is not None:
            return self._init_host_state(seed)
        tree = self._init_tree(seed)
        off = self._numel
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

    def _init_host_state(self, seed: int) -> None:
        """``host_step``: the tree is drawn on the card (the same draws as
        without offload), copied leaf by leaf into the fp32 master in host
        memory and freed before the card's buffers are allocated; the
        moments are made on the host too. The card keeps the compute copy,
        the micro-batch gradient and the accumulator."""
        tree = self._init_tree(seed)
        n, dev = self._numel, self.device
        self.flat_master = torch.zeros(n, dtype=torch.float32)
        with torch.no_grad():
            for slot, (_, t) in zip(self._slots, _flatten(tree)):
                self._view(self.flat_master, slot).copy_(t)
                _set_path(tree, slot.path, None)
                del t
        del tree
        self.state = {"step": 0, "master": self._views(self.flat_master),
                      "opt": self.optimizer.init(self.flat_master)}
        self.flat_compute = torch.zeros(n, dtype=self.compute_dtype,
                                        device=dev)
        self.flat_grad = torch.zeros(n, dtype=self.compute_dtype, device=dev)
        self.flat_grad_acc = torch.zeros(n, dtype=self._accum_dtype(),
                                         device=dev)
        self._host_runner.allocate(n)
        self._params = self._leaves()
        self._compute_params()

    def _zenflow_segments(self) -> List[Segment]:
        """ZenFlow's leaves in the flat master (the pads left out)."""
        return [Segment(slot.offset, slot.numel) for slot in self._slots]

    # ------------------------------------------------------------------ #
    # the offload tiers (JAX engine.py:1655-1720, :2555-2610)
    # ------------------------------------------------------------------ #
    def _master_views(self):
        return self._views(self.flat_master)

    def _set_master(self, flat) -> None:
        """Point the master (and its tree of views) at ``flat``: a tensor,
        or a :class:`Swapped` placeholder while it lives in a file."""
        self.flat_master = flat
        self.state["master"] = flat if isinstance(flat, Swapped) \
            else self._master_views()

    def _host_buffer(self, key: str, like) -> torch.Tensor:
        """The host tier's buffer for ``key``, shaped as ``like`` (a tensor
        or :class:`Swapped`): page-locked in place for the card at its
        first use (:class:`PinnedHost`) and reused by every later swap."""
        buf = self._host_bufs.get(key)
        if buf is None:
            n = int(np.prod(like.shape))
            buf = self._host_bufs[key] = PinnedHost(n, like.dtype,
                                                    self.device)
        return buf.tensor.view(like.shape)

    def _host_copy(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` copied into its host buffer, ordered on the current
        stream (after every copy out of that buffer queued before)."""
        host = self._host_buffer(key, t)
        host.copy_(t, non_blocking=True)
        return host

    def _device_copy(self, t: torch.Tensor) -> torch.Tensor:
        dev = torch.empty(t.shape, dtype=t.dtype, device=self.device)
        dev.copy_(t, non_blocking=True)
        return dev

    def _opt_swap(self, direction: str) -> None:
        """The optimizer state between its host tier ('out': pinned host
        memory) and the card ('in')."""
        if (direction == "out") == self._opt_on_host:
            return
        opt = self.state["opt"]
        for k, v in list(opt.items()):
            if isinstance(v, torch.Tensor):
                opt[k] = (self._host_copy(f"opt/{k}", v)
                          if direction == "out" else self._device_copy(v))
        self._opt_on_host = direction == "out"

    def _park_master(self) -> None:
        """The master to its pinned-host tier (``offload_param``)."""
        if not self._master_parked:
            self._set_master(self._host_copy("master", self.flat_master))
            self._master_parked = True

    def _unpark_master(self) -> None:
        if self._master_parked:
            self._set_master(self._device_copy(self.flat_master))
            self._master_parked = False

    def _materialize_master(self) -> None:
        """The master as a tensor on the card, from whichever tier holds
        it (paths that read it directly: ``load_master``, checks); under
        ``host_step`` it stays on the host, the update in flight done."""
        if not hasattr(self, "_master_parked"):     # still initialising
            return
        self._finish_publish()
        if self._host_runner is not None:
            self._host_runner.wait()
            return
        if self._param_swapper is not None:
            self._param_swapper.swap_in_params()
        self._unpark_master()

    def _finish_publish(self) -> None:
        """The data-parallel engines land their publish here."""

    def _nvme_swapper(self) -> OptimizerSwapper:
        if self._opt_swapper is None:
            self._opt_swapper = OptimizerSwapper(self)
            logger.info("NVMe optimizer offload active: "
                        f"{self._opt_swapper.swapper.swap_dir}")
        return self._opt_swapper

    def _param_nvme_swapper(self) -> ParamSwapper:
        if self._param_swapper is None:
            self._param_swapper = ParamSwapper(self)
            logger.info("NVMe parameter offload active: "
                        f"{self._param_swapper.swapper.swap_dir}")
        return self._param_swapper

    def offload_states(self, include: Optional[List[str]] = None,
                       device: str = "cpu") -> None:
        """Move state tiers to pinned host memory on demand (JAX
        ``offload_states``): ``include`` ⊆ {'optim_states', 'hp_params'},
        None = both."""
        if device != "cpu":
            raise ValueError("offload_states supports device='cpu' (host "
                             "memory); use OptimizerSwapper for the NVMe tier")
        include = include or ["optim_states", "hp_params"]
        if "optim_states" in include:
            self._opt_swap("out")
        if "hp_params" in include:
            self._park_master()

    def reload_states(self) -> None:
        self._opt_swap("in")
        self._unpark_master()

    def _tiers_before_step(self) -> None:
        """The master on the card for the step (its tiers otherwise); in
        the streaming mode in its pinned host buffer, back from its file
        under nvme and parked again after a direct use brought it to the
        card (JAX's ``_ensure_master_tier_for_step``)."""
        for k in self.stream_counts:
            self.stream_counts[k] = 0
        if self._offload_param_nvme and self._param_swapper is not None:
            self._param_swapper.swap_in_params()
        if self._param_stream:
            self._park_master()
        else:
            self._unpark_master()

    def _tiered_update(self, grad_scale: float) -> Dict[str, Any]:
        """``_apply_update`` with the optimizer state brought to the card
        just before it and sent back to its tier after, then the master
        to its tier."""
        if self._offload_nvme:
            self._nvme_swapper().swap_in_optimizer()
        self._opt_swap("in")
        metrics = self._apply_update(self.flat_grad_acc, grad_scale)
        if self._offload_opt:
            self._opt_swap("out")
        if self._offload_nvme:
            self._nvme_swapper().swap_out_optimizer()
        if self._offload_param:
            self._park_master()
        if self._offload_param_nvme:
            self._param_nvme_swapper().swap_out_params()
        return metrics

    def close(self) -> None:
        """Stop the host-step worker and unlock the host tiers' buffers
        (idempotent)."""
        if self._host_runner is not None:
            self._host_runner.close()
        for sw in (self._opt_swapper, self._param_swapper):
            if sw is not None:
                sw.swapper.close()
        for buf in self._host_bufs.values():
            buf.release()
        self._host_bufs = {}

    def _view(self, flat: torch.Tensor, slot: _Slot) -> torch.Tensor:
        return flat[slot.offset:slot.offset + slot.numel].view(slot.shape)

    def _load_master_leaf(self, slot: _Slot, full: torch.Tensor) -> None:
        """Set one leaf of the master from its full fp32 value."""
        self._materialize_master()
        self._view(self.flat_master, slot).copy_(full)

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
        """``_compute_params``: the compute copy of the master (streamed
        from the host chunk by chunk when the master lives there)."""
        if self._streaming():
            self._stream_pass()
            return
        with torch.no_grad():
            self.flat_compute.copy_(self.flat_master)

    # ------------------------------------------------------------------ #
    # in-step offload_param streaming (JAX engine.py:278-287, :1786-1797)
    # ------------------------------------------------------------------ #
    def _streaming(self) -> bool:
        return self._param_stream and getattr(self, "_master_parked", False)

    def _layer_bounds(self) -> List[Tuple[int, int]]:
        """The plan's layer chunks, else the chunks it would have at
        ``stage3_prefetch_bucket_size`` (none for a spec without layers)."""
        cfg = getattr(self.model_spec, "config", None)
        if self._overlap_plan["chunk_bounds"]:
            return self._overlap_plan["chunk_bounds"]
        if not isinstance(cfg, T.TransformerConfig):
            return []
        per_layer = max(sum(leaf_count(self._full_shapes[s.path])
                            for s in self._slots
                            if s.path[0] == _STACKED) // cfg.num_layers, 1)
        return chunk_layers(cfg.num_layers, per_layer,
                            self._overlap.prefetch_bucket_elems)

    def _stream_ranges(self) -> List[Tuple[int, int]]:
        """The streamed chunks of the local master: as many contiguous
        ranges as the plan has gather groups (the head group and each
        layer chunk), near-equal, 64-element aligned. (A layer chunk's
        elements are strided in the sharded layout, so the chunks are cut
        by size, not by layer.)"""
        if self._stream_plan is None:
            n = self.flat_master.numel()
            units = 1 + len(self._layer_bounds())
            step = -(-(-(-n // units)) // _ALIGN) * _ALIGN
            self._stream_plan = [(lo, min(n, lo + step))
                                 for lo in range(0, n, max(step, _ALIGN))]
        return self._stream_plan

    def _derived(self) -> Optional[torch.Tensor]:
        """The buffer the compute copy derives from the master into (None:
        the forward reads the master itself)."""
        return self.flat_compute

    def _stream_pass(self, g: Optional[torch.Tensor] = None,
                     lr: Optional[float] = None,
                     out: Optional[torch.Tensor] = None) -> None:
        """One pass over the master in pinned host memory, chunk by chunk:
        each chunk copied host→device on a side stream into one of two
        staging buffers of the largest chunk, the next chunk's copy in
        flight while this one is used; with ``g``, the fused Adam update
        of the chunk (``out``: its bf16 copy) and the chunk copied back
        device→host; the derived compute buffer written from it (unless
        ``out`` holds it). The master is never whole on the card."""
        host, dev = self.flat_master, self.device
        ranges = self._stream_ranges()
        if not self._stream_bufs:
            size = max(hi - lo for lo, hi in ranges)
            self._stream_bufs = [torch.empty(size, dtype=torch.float32,
                                             device=dev) for _ in range(2)]
        bufs, counts = self._stream_bufs, self.stream_counts
        derived = self._derived() if out is None or g is None else None
        cuda = dev.type == "cuda"
        if g is not None:
            opt = self.state["opt"]
            hyper = self.optimizer.begin_step(opt, lr)
        if cuda:
            cur = torch.cuda.current_stream(dev)
            if self._stream_side is None:
                self._stream_side = torch.cuda.Stream(dev)
            side = self._stream_side
            side.wait_stream(cur)
            loaded, freed = {}, [None, None]

        def fetch(k):
            lo, hi = ranges[k]
            buf = bufs[k % 2][:hi - lo]
            if cuda:
                with torch.cuda.stream(side):
                    if freed[k % 2] is not None:
                        side.wait_event(freed[k % 2])
                    buf.copy_(host[lo:hi], non_blocking=True)
                    loaded[k] = side.record_event()
            else:
                buf.copy_(host[lo:hi])
            counts["update_h2d" if g is not None else "derive_h2d"] += 1

        with torch.no_grad(), telemetry.span("offload_param_stream"):
            fetch(0)
            for k, (lo, hi) in enumerate(ranges):
                if k + 1 < len(ranges):
                    fetch(k + 1)
                buf = bufs[k % 2][:hi - lo]
                if cuda:
                    cur.wait_event(loaded.pop(k))
                if g is not None:
                    self.optimizer.apply(
                        buf, g[lo:hi], opt["exp_avg"][lo:hi],
                        opt["exp_avg_sq"][lo:hi], hyper,
                        None if out is None else out[lo:hi])
                if derived is not None:
                    derived[lo:hi].copy_(buf)
                if g is not None:
                    host[lo:hi].copy_(buf, non_blocking=True)
                    counts["update_d2h"] += 1
                if cuda:
                    freed[k % 2] = cur.record_event()
        if g is not None:
            self.optimizer.end_step(opt)

    def _update_master(self, g: torch.Tensor, lr: float,
                       out: Optional[torch.Tensor]) -> bool:
        """The optimizer step on the master: streamed from the host tier,
        or one call. True when the derived compute buffer is written
        too."""
        if self._streaming():
            self._stream_pass(g, lr, out)
            return True
        self.optimizer.update(g, self.state["opt"], self.flat_master, lr=lr,
                              out=out)
        return False

    def _bucketed_update(self, g, lr, out, publish) -> None:
        """The update bucket by bucket (JAX's ``fenced_update_chain``):
        ``publish(bucket)`` after each bucket's update."""
        opt = self.state["opt"]
        hyper = self.optimizer.begin_step(opt, lr)
        for bucket in self._update_buckets():
            for lo, hi in bucket.ranges:
                self.optimizer.apply(
                    self.flat_master[lo:hi], g[lo:hi], opt["exp_avg"][lo:hi],
                    opt["exp_avg_sq"][lo:hi], hyper,
                    None if out is None else out[lo:hi])
            publish(bucket)
        self.optimizer.end_step(opt)

    def _update_buckets(self) -> List["_Bucket"]:
        raise NotImplementedError       # the data-parallel engines

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
        norm = _resolved(self._last_metrics.get("grad_norm"))
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
            derived = self._update_master(g, lr, out)
            if out is None and not derived:
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
        if self._host_runner is not None:
            # SuperOffload / ZenFlow host-executed update (host_step.py)
            mean_loss, metrics = self._host_runner.train_step(stacked, gas)
            metrics["loss"] = mean_loss
            self.global_steps += 1
            self.micro_steps += gas
            self._after_step(metrics)
            return mean_loss
        self._tiers_before_step()
        batch = self._to_device(stacked)
        scale = self._scaler_state.scale if self.fp16_enabled else None
        self.flat_grad_acc.zero_()
        mean_loss = self.accumulate_microbatches(
            lambda mb: self._loss_and_grads(mb, scale), self.flat_grad_acc,
            self.flat_grad, batch, gas)
        grad_scale = float(gas) * (scale if scale is not None else 1.0)
        metrics = self._tiered_update(grad_scale)
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
            host = {k: float(_resolved(v)) for k, v in metrics.items()}
            drops = getattr(self, "_moe_drop_max", None)
            if drops is not None and float(drops) > 0:
                logger.warning(
                    f"MoE expert-parallel dispatch dropped {float(drops):.2%}"
                    " of token-choices (EP buffer overflow — router skew); "
                    "dropped choices fall through to the residual. Consider "
                    "a larger capacity headroom or rebalancing (aux loss "
                    "weight).")
                self._moe_drop_max = torch.zeros_like(drops)
            logger.info(
                f"step={self.global_steps} loss={host['loss']:.4f} "
                f"lr={host['lr']:.3e} grad_norm={host['grad_norm']:.3f}"
                + (f" loss_scale={host['loss_scale']:.0f}"
                   if self.fp16_enabled else ""))


def _piece_view(flat: torch.Tensor, piece) -> torch.Tensor:
    """A gather piece's place in a full flat buffer (leaf layout)."""
    slot = piece.shard.slot
    full = flat[slot.offset:slot.offset + slot.numel].view(slot.shape)
    return full if piece.layers is None \
        else full[piece.layers[0]:piece.layers[1]]


def _land_publish(group, flat_compute: torch.Tensor, world: int,
                  outs: List[torch.Tensor]) -> None:
    """A bucket's publish has landed: its gathered rows into the compute
    copy (holds no engine: a dropped engine's publish lands the same)."""
    with torch.no_grad():
        S3.unpack(group, outs[0], world,
                  lambda p: _piece_view(flat_compute, p))


def _resolved(value):
    """A metric's value; the host step's grad norm is a future."""
    return value.result() if hasattr(value, "result") else value


@dataclasses.dataclass
class _Bucket:
    """One update bucket (``update_bucket_size``, JAX's plan): its leaves'
    contiguous ranges of the local buffers (pads included) and the
    publish group of its sharded leaves."""
    ranges: List[Tuple[int, int]]
    shards: List[Any]
    group: Any


@dataclasses.dataclass
class _Unit:
    """One reduce of the exact wire a step: a layer chunk or a bucket of
    the other leaves; ``pending`` counts the leaves whose gradient has not
    landed in the last micro-batch's backward."""
    group: Any
    kind: str                       # "chunk" or "bucket"
    n_leaves: int
    row_off: int = 0                # its rows' place in the packed buffer
    pending: int = 0
    issued: bool = False
    expert: bool = False            # expert leaves: no replica hop


@dataclasses.dataclass
class _Shard:
    """Where one leaf lives in a rank's local buffers. A leaf sharded on
    ``dim`` keeps its ``moveaxis(leaf, dim, 0)`` rows: row r of
    ``[world, n_loc]`` is rank r's shard, at ``offset`` of the sharded
    region, padded to a multiple of the quantization block. A replicated
    leaf (``dim`` None) lies whole at ``offset`` of the replicated
    region."""
    slot: _Slot
    dim: Optional[int]
    n_loc: int
    offset: int

    def moved(self, world: int) -> Tuple[int, ...]:
        """[world, shape[dim] / world, other dims...]: the moved layout."""
        shape = self.slot.shape
        return (world, shape[self.dim] // world) + tuple(
            s for i, s in enumerate(shape) if i != self.dim)


class DataParallelEngine(DeepSpeedTPUEngine):
    """Data-parallel training over the default process group: ZeRO stages
    0-2 with the exact wire or the ZeRO++ int8 wire.

    Follows the JAX engine at ``data`` = world (engine.py:131-152, :242,
    ``_build_train_step_bucketed_wire`` :2144-2309). Each rank:

    * takes its contiguous rows of every global micro-batch (JAX's batch
      spec shards dim 1 of the stacked micro-batches), so every rank's data
      iterator yields the same global batches as JAX's;
    * holds the full compute copy and the per-micro-batch gradient (compute
      dtype) for its forward and backward, as the JAX wire step does, and
      its shard of the fp32 master, of the Adam moments and of the gradient
      accumulator in one local flat buffer each: the sharded leaves' rows
      in the moved layout (``parallel/partitioning.py`` picks JAX's dim;
      stage 0 shards nothing), then the replicated leaves whole. Fused Adam
      is one launch over the local buffer and writes the bf16 compute
      shard;
    * exact wire: the gradient summed over gas in fp32 rows (the moved
      layout), unit by unit, and each unit reduced once a step on the
      engine's ``CommQueue``: reduce-scatter at stage 2, all-reduce
      keeping the rank's row at stages 0-1; the mean shards into the fp32
      accumulator. ``overlap_comm`` on (stages 1-2): a unit a layer chunk
      and a unit a ``reduce_bucket_size`` bucket of the other leaves, each
      issued as soon as the last micro-batch's backward has completed it
      (the leaves' post-accumulate hooks); off: one unit after the
      backward. (JAX constrains each micro-batch's gradient: the same
      sums, in another order, for gas times the traffic.)
    * ZeRO++ wire (qgZ, with LoCo's per-rank fp32 residual when armed,
      reset after an fp16 overflow): per micro-batch, packs the gradient
      into one [world, Σ n_pad] fp32 buffer and reduces it through
      ``parallel/compressed._q_reduce_scatter`` — one quantize launch, one
      ``all_to_all`` each for q and the scales, one dequant-reduce launch
      (÷ world fused) — then rounds the mean shard to the compute dtype
      (JAX's ``astype(g.dtype)``) and adds it to the fp32 accumulator;
      replicated leaves take an exact fp32 all-reduce mean;
    * publishes the compute copy once per step (and at start): qwZ through
      ``_q_allgather`` on the master shards, else an exact all-gather of
      the compute-dtype shards; under ``overlap_step`` on the exact wire
      each update bucket's all-gather goes out on the queue when its update
      is done (at most two in flight; the rest lands before the next
      forward, or before any collective outside the queue);
    * global grad norm = sqrt of the all-reduced sum of the shards'
      squares, plus the replicated leaves' once; clip and the fp16
      overflow skip on it; the loss is the mean over ranks;
    * the loss each rank differentiates: on the exact wire, with a
      ``loss_mask``, its masked mean weighted so that the ranks' mean is
      the global masked token mean (``_token_weights``); on the int8 wire
      its own masked mean, as JAX's int8 steps take the ranks' mean.

    JAX's straight-through ``_build_train_step_qz`` gives the same values
    up to reassociation, so one formulation serves both. With the overlap
    scheduler's plan holding more than one layer chunk, the qwZ publish
    quantizes each chunk's pieces on their own (the head group first), as
    JAX's ``chunked_gather_tree_fn`` does; otherwise leaf by leaf.

    hpZ / MiCS (a ``zshard`` axis of Z ranks, ``data`` of D): the shards,
    the packed gradient rows ``[Z, n_sh]`` and the publish live on the
    ``zshard`` group (``shard_world`` Z, ``shard_rank`` the rank's
    coordinate there), replicated across ``data``. The gradient takes two
    hops: the reduce-scatter (stage 1: all-reduce) over ``zshard`` sums,
    then the rank's shard is summed over ``data`` (int8 under qgZ, exact on
    the exact wire and under LoCo), then ÷ the whole world, JAX's order.
    The batch rows, the loss mean and the replicated leaves' mean stay
    over the whole world; the global norm sums the shards' squares over
    ``zshard`` only (each shard is held D times).

    Expert parallelism (an ``expert`` axis of X ranks, JAX's
    ``EXPERT_GRAD_REDUCE_AXES`` / ``DENSE_GRAD_REDUCE_AXES``): the leaves
    with an ``expert`` logical axis hold this rank's E/X experts (its
    ``expert`` coordinate's), a third class beside the ZeRO-sharded and the
    replicated leaves. ZeRO shards over ``(data, zshard)`` only (JAX's
    ``ZERO_SHARD_AXES``): that group is the shard group, the ``expert``
    group the dense leaves' replica hop, as ``data`` is hpZ's. A dense
    gradient is reduced over the whole world (the shard group, then the
    ``expert`` hop; replicated dense leaves over the world), an expert
    leaf's over the shard group only, each then ÷ the whole world: every
    rank's loss is its own rows' mean, and the all-to-all's backward has
    brought every rank's contribution to the expert's owner. The local
    buffers hold the dense leaves first, then the expert leaves, in both
    regions; the norm sums each expert shard once (over the world, or over
    ``expert`` for a replicated one). The hooked units split into dense and
    expert units. The MoE layers report the buffers' dropped choices
    (``moe/layer.set_drop_monitor``), warned of at the print steps."""

    def __init__(self, model: ModelSpec, config: Any,
                 optimizer: Optional[TPUOptimizer] = None,
                 lr_scheduler: Optional[LRSchedule] = None,
                 seed: Optional[int] = None, device=None):
        self.rank = comm.get_rank()
        self.world = comm.get_world_size()
        super().__init__(model, config, optimizer=optimizer,
                         lr_scheduler=lr_scheduler, seed=seed,
                         device=rank_device(device))

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #
    def _shard_topology(self) -> None:
        """Where the ZeRO shards live: the ``zshard`` group under hpZ (its
        ``data`` group for the replica hop), else the whole world."""
        mm = self.mesh_manager
        self.hpz = mm.axis_size(mesh_mod.ZSHARD_AXIS) > 1
        self.ep = mm.ep_world_size
        # each expert leaf's expert dim (its logical axis "expert")
        self._expert_dims: Dict[Tuple[str, ...], int] = {}
        if self.ep > 1 and self.model_spec.axes_fn is not None:
            for path, axes in _flatten(self.model_spec.axes_fn()):
                if "expert" in axes:
                    self._expert_dims[path] = axes.index("expert")
        self._moe_drop_max = None
        if self.ep > 1:
            from deepspeed_tpu_torch.moe.layer import set_drop_monitor

            axes = mesh_mod.EXPERT_GRAD_REDUCE_AXES
            self.shard_world = mm.axes_size(axes)
            self.shard_rank = mm.group_ranks(axes).index(self.rank)
            self.shard_group = mm.group(axes)
            self.replica_world = self.ep
            self.replica_group = mm.group((mesh_mod.EXPERT_AXIS,))
            self._moe_drop_max = torch.zeros((), device=self.device)
            # a weak reference: the module's monitor must not keep a
            # dropped engine alive
            engine = weakref.ref(self)

            def sink(frac):
                e = engine()
                if e is not None:
                    e._record_moe_drops(frac)

            set_drop_monitor(sink)
        elif self.hpz:
            self.shard_world = mm.axis_size(mesh_mod.ZSHARD_AXIS)
            self.shard_rank = mm.coords[mesh_mod.ZSHARD_AXIS]
            self.shard_group = mm.group((mesh_mod.ZSHARD_AXIS,))
            self.replica_world = mm.axis_size(mesh_mod.DATA_AXIS)
            self.replica_group = mm.group((mesh_mod.DATA_AXIS,))
        else:
            self.shard_world, self.shard_rank = self.world, self.rank
            self.shard_group = self.replica_group = None
            self.replica_world = 1
        self._grad_hooks = self._issuing = False
        self._units: List[_Unit] = []
        self._queue: Optional[comm.CommQueue] = None
        self._reduces: List[Tuple[Any, _Unit]] = []
        #: this step's exact-wire reduces (chunk / bucket units; late:
        #: issued after the backward, not by its leaves' hooks) and bucket
        #: publishes
        self.reduce_counts = {"chunk": 0, "bucket": 0, "late": 0,
                              "publish": 0}

    def _record_moe_drops(self, frac: torch.Tensor) -> None:
        """The drop monitor's sink: the worst dropped-choice fraction since
        the last print step, kept on the device (no host read)."""
        self._moe_drop_max = torch.maximum(self._moe_drop_max,
                                           frac.detach().float())

    def _local_tree(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """Each expert leaf cut to this rank's E/X experts."""
        for path, t in list(_flatten(tree)):
            if path in self._expert_dims:
                _set_path(tree, path, self.local_leaf(path, t))
        return tree

    def local_leaf(self, path: Tuple[str, ...],
                   full: torch.Tensor) -> torch.Tensor:
        """This rank's experts of a whole expert leaf (other leaves whole;
        a leaf already cut is returned as it is)."""
        dim = self._expert_dims.get(path)
        if dim is None or full.shape[dim] != self._full_shapes[path][dim]:
            return full
        E = full.shape[dim]
        if E % self.ep:
            raise ValueError(f"n_experts={E} not divisible by expert mesh "
                             f"axis {self.ep}")
        E_l = E // self.ep
        c = self.mesh_manager.coords[mesh_mod.EXPERT_AXIS]
        return full.narrow(dim, c * E_l, E_l).contiguous()

    def _init_state(self, seed: int) -> None:
        if self.zero_stage >= 3:
            raise ValueError("ZeRO stage 3 between processes: build the "
                             "engine with deepspeed_tpu_torch.initialize "
                             "(Zero3Engine)")
        self._shard_topology()
        tree = self._init_tree(seed)
        dev, cdt = self.device, self.compute_dtype
        self.flat_compute = torch.zeros(self._numel, dtype=cdt, device=dev)
        self.flat_grad = torch.zeros(self._numel, dtype=cdt, device=dev)
        self._init_shards(tree)
        del tree
        # qwZ publishes by the plan's layer chunks when it has more than
        # one (JAX's chunked_gather_tree_fn), else leaf by leaf
        bounds = self._overlap_plan["chunk_bounds"]
        self._publish_groups = S3.gather_groups(
            self._shards, bounds if self._quant_weights() and len(bounds) > 1
            else [])
        # the exact wire reduces once a step, unit by unit: under
        # overlap_comm at stages 1-2 each layer chunk and each
        # reduce_bucket_size bucket of the other leaves, issued as the last
        # micro-batch's backward completes it (JAX's make_grad_sync and
        # _constrain_grads_bucketed), else one unit after the backward
        self._grad_hooks = (self._overlap.enabled and not self._quant_grads()
                            and 1 <= self.zero_stage <= 2)
        self._params = self._leaves()
        n_cols = self._n_sh
        if not self._quant_grads():
            self._units = self._reduce_units()
            n_cols = max(n_cols, sum(u.group.n_row for u in self._units))
        # [Z, n_sh] fp32: the int8 wire's packed gradient, the qwZ
        # publish's dequantized rows; on the exact wire each unit's
        # [Z, n_row] rows, one after another, summed over the micro-batches
        self._packed = torch.zeros(self.shard_world, n_cols,
                                   dtype=torch.float32, device=dev)
        self._compute_params()
        logger.info(
            f"rank {self.rank}/{self.world}: wire={self._wire_format()} "
            f"shards over {self.shard_world} ranks, "
            f"sharded={self._n_sh} replicated={self._n_rep} elements per "
            "rank")

    def _init_shards(self, tree: Dict[str, Any]) -> None:
        """A rank's local buffers, JAX's ZeRO dim for each leaf
        (``zero_layout``): the fp32 master (from ``tree``), the gradient
        accumulator, the compute-dtype shard Adam writes (bf16), the
        replicated leaves' gradient, LoCo's residual when armed, and the
        optimizer state."""
        W, dev, cdt = self.shard_world, self.device, self.compute_dtype
        self._shards, sh_off, rep_off = zero_layout(
            self.model_spec, self._slots, W, self.zero_stage,
            self.mesh_manager.shape, expert_paths=set(self._expert_dims))
        self._n_sh, self._n_rep = sh_off, rep_off
        # the expert leaves lie after the dense ones in each region
        ex = [sh for sh in self._shards if sh.slot.path in self._expert_dims]
        self._n_sh_dense = min([sh.offset for sh in ex if sh.dim is not None]
                               + [sh_off])
        self._n_rep_dense = min([sh.offset for sh in ex if sh.dim is None]
                                + [rep_off])
        n_local = sh_off + rep_off
        self.flat_master = torch.zeros(n_local, dtype=torch.float32,
                                       device=dev)
        self.flat_grad_acc = torch.zeros(n_local, dtype=self._accum_dtype(),
                                         device=dev)
        self._shard_compute = (torch.zeros(n_local, dtype=cdt, device=dev)
                               if cdt == torch.bfloat16 else None)
        self._rep_buf = torch.zeros(rep_off, dtype=torch.float32, device=dev)
        self.loco_err = (torch.zeros(W, sh_off, dtype=torch.float32,
                                     device=dev)
                         if self._wire_format() == "qz+loco" else None)
        for sh, (_, t) in zip(self._shards, _flatten(tree)):
            self._load_master_leaf(sh.slot, t)
        self.state: Dict[str, Any] = {
            "step": 0, "master": self._master_tree(),
            "opt": self.optimizer.init(self.flat_master)}

    def _local(self, flat: torch.Tensor, sh: _Shard) -> torch.Tensor:
        """The rank's part of leaf ``sh`` in a local buffer: its shard in
        the moved layout, or the whole replicated leaf."""
        if sh.dim is None:
            start = self._n_sh + sh.offset
            return flat[start:start + sh.n_loc].view(sh.slot.shape)
        return flat[sh.offset:sh.offset + sh.n_loc].view(
            sh.moved(self.shard_world)[1:])

    def _master_tree(self) -> Dict[str, Any]:
        tree: Dict[str, Any] = {}
        for sh in self._shards:
            _set_path(tree, sh.slot.path, self._local(self.flat_master, sh))
        return tree

    def _master_views(self):
        return self._master_tree()

    # ------------------------------------------------------------------ #
    # the overlap scheduler's step phase: chunk / bucket reduces on the
    # exact stage 1-2 wire, update buckets and their publish
    # ------------------------------------------------------------------ #
    def _comm_queue(self) -> comm.CommQueue:
        if self._queue is None:
            self._queue = comm.CommQueue()
        return self._queue

    def _reduce_units(self) -> List[_Unit]:
        """Hooked (``overlap_comm`` at stages 1-2): one unit a layer chunk
        of the plan (its ``blocks`` leaves), then the other leaves in
        ``reduce_bucket_size`` buckets planned over their sizes in reversed
        flatten order (JAX engine.py:1754-1776), each leaf tensor of the
        forward's tree hooked to its unit. Else one unit of every leaf."""
        bounds = [tuple(b) for b in self._overlap_plan["chunk_bounds"]]
        chunked = S3.chunked_shards(self._shards) if bounds else []
        units = [_Unit(S3.make_group([(sh, b) for sh in chunked], b),
                       "chunk", 0) for b in bounds]
        head = [sh for sh in self._shards
                if not any(sh is c for c in chunked)]
        buckets = (plan_buckets([leaf_count(sh.slot.shape) for sh in head],
                                self._overlap.reduce_bucket_elems)
                   if self._grad_hooks else [range(len(head))])
        for idxs in buckets:
            units.append(_Unit(S3.make_group(
                [(head[i], None) for i in sorted(idxs)]), "bucket", 0))
        if self._expert_dims:
            # an expert unit reduces over the shard group only
            split = []
            for u in units:
                for expert in (False, True):
                    items = [(p.shard, p.layers) for p in u.group.pieces
                             if (p.path in self._expert_dims) == expert]
                    if items:
                        split.append(_Unit(S3.make_group(
                            items, u.group.layers), u.kind, 0,
                            expert=expert))
            units = split
        off = 0
        for u in units:
            u.row_off, off = off, off + self.shard_world * u.group.n_row
        if not self._grad_hooks:
            return units
        unit_of: Dict[Tuple[Tuple[str, ...], Optional[int]], _Unit] = {}
        for u in units:
            for p in u.group.pieces:
                if p.layers is None:
                    unit_of[(p.path, None)] = u
                else:
                    for layer in range(*p.layers):
                        unit_of[(p.path, layer)] = u

        # a weak reference: the leaves' hooks must not keep a dropped
        # engine's buffers alive until the next collection
        engine = weakref.ref(self)

        def hook_all(tree, path, layer):
            for k, v in tree.items():
                if isinstance(v, dict):
                    hook_all(v, path + (k,), layer)
                    continue
                full = path + (k,)
                u = unit_of.get((full, layer)) or unit_of[(full, None)]
                u.n_leaves += 1
                v.register_post_accumulate_grad_hook(
                    lambda _t, u=u: engine()._grad_landed(u))

        hook_all({k: v for k, v in self._params.items() if k != _STACKED},
                 (), None)
        for layer, lp in enumerate(self._params.get(_STACKED, [])):
            hook_all(lp, (_STACKED,), layer)
        return units

    def _grad_landed(self, unit: _Unit) -> None:
        """A leaf's gradient is complete for the last micro-batch's
        backward: its unit's reduce goes out when it was the unit's last
        (earlier micro-batches are summed locally after their backward)."""
        if not self._issuing:
            return
        if unit.issued:
            raise RuntimeError("a leaf's gradient landed twice in one "
                               "backward after its reduce was issued")
        unit.pending -= 1
        if unit.pending == 0:
            self._issue_reduce(unit)

    def _pack_unit(self, unit: _Unit) -> torch.Tensor:
        """Add the micro-batch's gradient of the unit's leaves into its
        fp32 rows (the wire's layout; zeroed at the step's start) and its
        replicated leaves into the step's replicated buffer → the rows."""
        g, W = unit.group, self.shard_world
        with torch.no_grad(), telemetry.span("zero_pack"):
            rows = self._packed.view(-1)[unit.row_off:unit.row_off
                                         + W * g.n_row].view(W, g.n_row)
            for p in g.pieces:
                full = self._view(self.flat_grad, p.shard.slot)
                if p.layers is not None:
                    full = full[p.layers[0]:p.layers[1]]
                if not p.n:
                    self._rep_buf[p.shard.offset:p.shard.offset
                                  + p.shard.n_loc].view(
                        p.shard.slot.shape).add_(full)
                    continue
                moved = p.moved(W)
                rows[:, p.offset:p.offset + p.n].view(moved).add_(
                    torch.movedim(full, p.shard.dim, 0).reshape(moved))
        return rows

    def _issue_reduce(self, unit: _Unit) -> None:
        """Pack the last micro-batch's gradient of the unit and submit the
        reduce of its step sum (fp32 on the wire): reduce-scatter at stage
        2, all-reduce keeping this rank's row at stages 0-1, each over
        ``zshard`` then ``data`` under hpZ. A unit of replicated leaves
        only has no rows to reduce (their mean is taken once a step)."""
        g = unit.group
        unit.issued = True
        rows = self._pack_unit(unit)
        self.reduce_counts[unit.kind] += 1
        if not g.n_row:
            return
        with torch.no_grad(), telemetry.span("zero_reduce_issue"):
            mine = torch.empty(g.n_row, dtype=torch.float32,
                               device=self.device)
            hop = self.hpz or (self.ep > 1 and not unit.expert)
            if self.zero_stage >= 2:
                op = comm.reduce_scatter_op(self.shard_group,
                                            self.replica_group,
                                            replicas=hop)
            else:
                op = comm.all_reduce_row_op(self.shard_rank,
                                            self.shard_group,
                                            self.replica_group,
                                            replicas=hop)
            handle = self._comm_queue().submit(
                op, [mine], [rows], slot=f"r{len(self._reduces) % 2}",
                group=self.shard_group)
        self._reduces.append((handle, unit))
        while len(self._reduces) > 2:       # bound what is in flight
            self._land_reduce(*self._reduces.pop(0))

    def _land_reduce(self, handle, unit: _Unit) -> None:
        """A unit's reduce has landed: its sum ÷ the whole world added into
        the accumulator."""
        with telemetry.span("zero_reduce_wait"):
            mine, = handle.wait()
        with torch.no_grad():
            mine.div_(torch.tensor(float(self.world), device=self.device))
            for p in unit.group.pieces:
                if not p.n:
                    continue
                acc = self._local(self.flat_grad_acc, p.shard)
                if p.layers is not None:
                    acc = acc[:, p.layers[0]:p.layers[1]]
                acc.add_(mine[p.offset:p.offset + p.n].view(acc.shape))

    def _update_buckets(self) -> List[_Bucket]:
        """JAX's update buckets (``_fence_update_buckets``): the leaves in
        ``update_bucket_size`` buckets by their full sizes in reversed
        flatten order; each bucket's ranges of the local buffers cover its
        leaves and their pads (so the buckets cover every element), in
        buffer order, adjacent leaves merged."""
        if getattr(self, "_buckets", None) is None:
            out = []
            for idxs in plan_buckets(
                    [leaf_count(sh.slot.shape) for sh in self._shards],
                    self._overlap_plan["update_bucket_elems"]):
                shards = [self._shards[i] for i in sorted(idxs)]
                spans = []
                for sh in shards:
                    if sh.dim is None:
                        lo = self._n_sh + sh.offset
                        spans.append((lo, lo + -(-sh.n_loc // _ALIGN)
                                      * _ALIGN))
                    else:
                        spans.append((sh.offset, sh.offset + -(
                            -sh.n_loc // QK.DEFAULT_BLOCK) * QK.DEFAULT_BLOCK))
                ranges: List[Tuple[int, int]] = []
                for lo, hi in sorted(spans):
                    if ranges and ranges[-1][1] == lo:
                        ranges[-1] = (ranges[-1][0], hi)
                    else:
                        ranges.append((lo, hi))
                out.append(_Bucket(ranges, shards, S3.make_group(
                    [(sh, None) for sh in shards if sh.dim is not None])))
            self._buckets = out
        return self._buckets

    def _publish_bucket(self, bucket: _Bucket) -> None:
        """The exact publish of one updated bucket: the all-gather of its
        compute-dtype shards submitted on the queue and left in flight
        (``comm.leave_in_flight``: at most two, the rest landed before the
        next forward or before any collective outside the queue); its
        replicated leaves cast in place."""
        src = self._shard_compute if self._shard_compute is not None \
            else self.flat_master
        with torch.no_grad(), telemetry.span("zero_publish"):
            for sh in bucket.shards:
                if sh.dim is None:
                    self._view(self.flat_compute, sh.slot).copy_(
                        self._local(src, sh))
            if bucket.group.n_row:
                send = S3.pack(bucket.group, self, src, self.compute_dtype)
                rows = torch.empty(self.shard_world, bucket.group.n_row,
                                   dtype=send.dtype, device=self.device)
                handle = self._comm_queue().submit(
                    comm.all_gather_op(self.shard_group), [rows], [send],
                    slot=f"p{self.reduce_counts['publish'] % 2}",
                    group=self.shard_group)
                self.reduce_counts["publish"] += 1
                comm.leave_in_flight(handle, functools.partial(
                    _land_publish, bucket.group, self.flat_compute,
                    self.shard_world))

    def _finish_publish(self) -> None:
        """Land every publish in flight (before the forward that reads the
        compute copy)."""
        comm.settle()

    def _zenflow_segments(self) -> List[Segment]:
        """ZenFlow's leaves in the local buffer: a sharded leaf's rows
        gather the whole leaf's |g| over the shard group for its
        threshold."""
        def gather(a: torch.Tensor) -> torch.Tensor:
            rows = torch.empty(self.shard_world * a.numel(), dtype=a.dtype,
                               device=a.device)
            comm.all_gather_into_tensor(rows, a.contiguous(),
                                        group=self.shard_group)
            return rows

        return [Segment(sh.offset, sh.n_loc, gather) if sh.dim is not None
                else Segment(self._n_sh + sh.offset, sh.n_loc)
                for sh in self._shards]

    def _load_master_leaf(self, slot: _Slot, full: torch.Tensor) -> None:
        self._materialize_master()
        sh = next(s for s in self._shards if s.slot is slot)
        full = full.to(device=self.device, dtype=torch.float32)
        if sh.dim is not None:
            full = torch.movedim(full, sh.dim, 0).reshape(
                sh.moved(self.shard_world))[self.shard_rank]
        self._local(self.flat_master, sh).copy_(full)

    def _rows(self, packed: torch.Tensor, sh: _Shard) -> torch.Tensor:
        """Leaf ``sh``'s [Z, shape[dim]/Z, ...] rows in a packed [Z, n_sh]
        buffer (Z the shard world)."""
        return packed[:, sh.offset:sh.offset + sh.n_loc].view(
            sh.moved(self.shard_world))

    def _moved(self, flat: torch.Tensor, sh: _Shard) -> torch.Tensor:
        """Leaf ``sh`` of a full flat buffer as a [Z, shape[dim]/Z, ...]
        view of ``moveaxis(leaf, dim, 0)``."""
        return torch.movedim(self._view(flat, sh.slot), sh.dim, 0).view(
            sh.moved(self.shard_world))

    def _quant_weights(self) -> bool:
        return bool(self._compressed and self._compressed["quant_weights"])

    def _compute_params(self, shard_written: bool = False) -> None:
        """Publish the compute copy from the master shards, group by group
        (``_publish_groups``): qwZ (int8 all-gather of the fp32 master,
        dequantized into ``_packed``) or the exact all-gather of the
        compute-dtype shards; replicated leaves are cast in place.
        ``shard_written``: Adam has just written the bf16 compute
        shard. Under hpZ the gathers run on the ``zshard`` group only."""
        cdt, W = self.compute_dtype, self.shard_world
        quant = self._quant_weights()
        with torch.no_grad(), telemetry.span("zero_publish"):
            if self._shard_compute is None:
                src = self.flat_master.to(cdt)
            else:
                src = self._shard_compute
                if not shard_written:
                    src.copy_(self.flat_master)
            for grp in self._publish_groups if self._n_sh else ():
                out = self._packed.view(-1)[:W * grp.n_row].view(
                    W, grp.n_row) if quant else None
                rows = S3.gather_group(grp, self, self.flat_master if quant
                                       else src, quant, out=out)
                S3.unpack(grp, rows, W,
                          lambda p: _piece_view(self.flat_compute, p))
                if quant and not grp.identity:
                    # the qgZ send quantizes _packed's pads: keep them 0
                    self._packed.zero_()
            for sh in self._shards:
                if sh.dim is None:
                    self._view(self.flat_compute, sh.slot).copy_(
                        self._local(src, sh))

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #
    def _local_rows(self, stacked):
        """This rank's contiguous rows of every stacked global micro-batch
        [gas, micro × world, ...]."""
        if isinstance(stacked, dict):
            return {k: self._local_rows(v) for k, v in stacked.items()}
        n = stacked.shape[1] // self.world
        return stacked[:, self.rank * n:(self.rank + 1) * n]

    def _pack(self) -> None:
        """The micro-batch gradient (compute dtype, full) copied into the
        packed fp32 rows ``[Z, n_sh]`` and the replicated buffer (the int8
        wire's send)."""
        with torch.no_grad(), telemetry.span("zero_pack"):
            for sh in self._shards:
                g = self._view(self.flat_grad, sh.slot)
                if sh.dim is None:
                    dst = self._rep_buf[sh.offset:sh.offset + sh.n_loc] \
                        .view(sh.slot.shape)
                else:
                    dst, g = self._rows(self._packed, sh), self._moved(
                        self.flat_grad, sh)
                dst.copy_(g)

    def _replicated_mean(self) -> torch.Tensor:
        """The replicated leaves' gradient mean: dense leaves summed over
        the world, expert leaves over the shard group, ÷ the world."""
        nd = self._n_rep_dense
        comm.all_reduce(self._rep_buf[:nd])
        if nd < self._n_rep:
            comm.all_reduce(self._rep_buf[nd:], group=self.shard_group)
        return self._rep_buf / torch.tensor(float(self.world),
                                            device=self.device)

    def _replica_mean(self, mine: torch.Tensor, quant: bool) -> torch.Tensor:
        """hpZ's second hop: the rank's summed shard over ``data`` (int8
        or exact), then ÷ the whole world (JAX's order)."""
        mine = C.replica_sum(mine, self.replica_group, self.replica_world,
                             quant)
        return mine / torch.tensor(float(self.world), device=self.device)

    def _reduce_micro_int8(self) -> None:
        """qgZ (and LoCo) for one micro-batch's gradient; the mean shard,
        rounded to the compute dtype, is added to the accumulator. Under
        hpZ the first hop sums over ``zshard`` and the replica hop (int8;
        exact under LoCo) sums over ``data`` before the mean."""
        self._pack()
        acc, cdt = self.flat_grad_acc, self.compute_dtype
        Z, grp, mean = self.shard_world, self.shard_group, not self.hpz
        with torch.no_grad():
            if self.loco_err is not None:
                self._packed.add_(self.loco_err)
                mine, _ = C._q_reduce_scatter(
                    self._packed, grp, Z, return_sent=True, mean=mean,
                    sent_out=self.loco_err)
                torch.sub(self._packed, self.loco_err, out=self.loco_err)
            else:
                mine = C._q_reduce_scatter(self._packed, grp, Z, mean=mean)
            if self.hpz:
                mine = self._replica_mean(mine, self.loco_err is None)
            acc[:self._n_sh].add_(mine.to(cdt))
            if self._n_rep:
                acc[self._n_sh:].add_(self._replicated_mean().to(cdt))

    def _token_weights(self, stacked, batch) -> Optional[torch.Tensor]:
        """Exact wire, batches with a ``loss_mask``: each micro-batch's
        loss weight max(n_rank, 1) · W / max(n_global, 1), with n the valid
        tokens (``loss_mask[:, 1:]`` summed, as ``causal_lm_loss`` counts
        them). The mean over ranks of the weighted masked means is then the
        global masked token mean, which JAX's exact step (one GSPMD step
        over the data-sharded micro-batch) takes. Every rank holds the
        global batch, so n_global needs no collective. None without a
        ``loss_mask``: every rank counts the same."""
        if not isinstance(stacked, dict) or stacked.get("loss_mask") is None:
            return None

        def counts(mask):
            return mask[:, :, 1:].float().sum(dim=(1, 2)).clamp(min=1.0)

        n_global = counts(torch.as_tensor(stacked["loss_mask"]))
        return (counts(batch["loss_mask"]) * float(self.world)
                / n_global.to(self.device))

    def _quant_grads(self) -> bool:
        return bool(self._compressed and self._compressed["quant_grads"])

    def _moe_axes(self):
        """The int8 wire's step is JAX's manual ``shard_map`` over ``data``
        and ``zshard``: the MoE layers' gate and aux loss are each rank's
        own there (on the exact wire, GSPMD's global ones)."""
        if self._compressed is None:
            return contextlib.nullcontext()
        return mesh_mod.manual_axes((mesh_mod.DATA_AXIS,
                                     mesh_mod.ZSHARD_AXIS))

    @contextlib.contextmanager
    def _step_buffers(self):
        """The buffers a step's gradient wire needs beyond the persistent
        ones (ZeRO-2 keeps them all)."""
        yield

    def _reduce_micro(self, last: bool) -> None:
        """After a micro-batch's backward: qgZ reduces it. The exact wire
        adds it into its units' fp32 rows; after the last one it issues
        the units no hook issued (every unit when unhooked, or a leaf
        without a gradient) and lands every reduce."""
        if self._quant_grads():
            self._reduce_micro_int8()
            return
        if not last:
            for u in self._units:
                self._pack_unit(u)
            return
        self._issuing = False
        for u in self._units:
            if not u.issued:
                self.reduce_counts["late"] += 1
                self._issue_reduce(u)
        while self._reduces:
            self._land_reduce(*self._reduces.pop(0))
        self._comm_queue().drain()

    def _reduce_step(self) -> None:
        if not self._quant_grads() and self._n_rep:
            with torch.no_grad():
                self.flat_grad_acc[self._n_sh:].copy_(self._replicated_mean())

    def _begin_micro(self, last: bool) -> None:
        """Before a micro-batch's backward: the leaves' hooks issue their
        units' reduces in the last one only."""
        self._issuing = self._grad_hooks and last
        for u in self._units:
            u.pending, u.issued = u.n_leaves, False

    def _dispatch_train_step(self, stacked, gas: int) -> torch.Tensor:
        self._finish_publish()
        for k in self.reduce_counts:
            self.reduce_counts[k] = 0
        self._tiers_before_step()
        batch = self._to_device(self._local_rows(stacked))
        scale = self._scaler_state.scale if self.fp16_enabled else None
        self.flat_grad_acc.zero_()
        quant_grads = self._quant_grads()
        # the int8 wire keeps the mean of the ranks' means, as JAX's pmean
        weights = None if quant_grads else self._token_weights(stacked, batch)
        if not quant_grads:
            if self._packed is not None and self._units:
                self._packed.zero_()
            self._rep_buf.zero_()
        losses = []
        with self._step_buffers():
            for i in range(gas):
                mb = ({k: v[i] for k, v in batch.items()}
                      if isinstance(batch, dict) else batch[i])
                self._begin_micro(i == gas - 1)
                with self._moe_axes():
                    if weights is None:
                        losses.append(self._loss_and_grads(mb, scale))
                    else:
                        w = weights[i]
                        loss = self._loss_and_grads(
                            mb, w if scale is None else w * scale)
                        losses.append(loss * w)
                self._reduce_micro(i == gas - 1)
            self._reduce_step()
        mean_loss = losses[0] if gas == 1 else torch.stack(losses).mean()
        mean_loss = comm.all_reduce(mean_loss.float().reshape(1),
                                    comm.ReduceOp.AVG)[0]
        grad_scale = float(gas) * (scale if scale is not None else 1.0)
        metrics = self._tiered_update(grad_scale)
        if self.loco_err is not None and metrics["overflow"]:
            self.loco_err.zero_()
        metrics["loss"] = mean_loss
        self.global_steps += 1
        self.micro_steps += gas
        self._after_step(metrics)
        return mean_loss

    def _apply_update(self, grads: torch.Tensor, grad_scale: float
                      ) -> Dict[str, Any]:
        scale_t = torch.full((), grad_scale, dtype=torch.float32,
                             device=self.device)
        g = grads.div_(scale_t) if grads.dtype == torch.float32 \
            else grads.float() / scale_t
        lr = self._lr_at(self.state["step"])
        # each shard is held once a zshard group (hpZ: D times in the
        # world); an expert shard once in the world, a replicated expert
        # leaf once an expert group
        n_sh = self._n_sh
        if self.ep > 1:
            nsd, nrd = self._n_sh_dense, self._n_rep_dense
            sq = torch.stack([g[:nsd].square().sum(),
                              g[nsd:n_sh].square().sum(),
                              g[n_sh + nrd:].square().sum(),
                              g[n_sh:n_sh + nrd].square().sum()])
            comm.all_reduce(sq[:2], group=self.shard_group)
            comm.all_reduce(sq[1:3], group=self.replica_group)
        else:
            sq = torch.stack([g[:n_sh].square().sum(),
                              g[n_sh:].square().sum()])
            comm.all_reduce(sq[:1], group=self.shard_group)
        norm = torch.sqrt(sq.sum())
        if self.config.gradient_clipping > 0:
            clip_by_global_norm([g], self.config.gradient_clipping, norm)
        overflow = False
        if self.fp16_enabled:
            overflow = not bool(torch.isfinite(norm))   # host read
        if not overflow:
            if (self._step_overlap and self.zero_stage < 3
                    and not self._quant_weights()
                    and isinstance(self.optimizer, FusedAdam)):
                # each bucket's publish goes out as its update is done
                self._bucketed_update(g, lr, self._shard_compute,
                                      publish=self._publish_bucket)
            else:
                self._update_master(g, lr, self._shard_compute)
                self._compute_params(shard_written=True)
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

    def close(self) -> None:
        """Land the publish in flight and stop the queue's thread."""
        self._finish_publish()
        if self._queue is not None:
            self._queue.close()
        super().close()

    # ------------------------------------------------------------------ #
    # full views, for checks (collective: every rank calls them)
    # ------------------------------------------------------------------ #
    def full_master(self) -> Dict[str, Any]:
        """The whole fp32 master as a tree of CPU tensors (JAX's keys and
        shapes)."""
        self._materialize_master()
        return self.full_tree(self.flat_master)

    def full_tree(self, flat: torch.Tensor, device="cpu") -> Dict[str, Any]:
        """A local buffer (the master's layout: the shards, then the
        replicated leaves) as the tree of whole fp32 leaves on ``device``,
        gathered from the shards of the rank's ``zshard`` group (the whole
        world without hpZ)."""
        self._finish_publish()
        rows = torch.empty(self.shard_world, self._n_sh, dtype=torch.float32,
                           device=self.device)
        comm.all_gather_into_tensor(rows, flat[:self._n_sh].float(),
                                    group=self.shard_group)
        tree: Dict[str, Any] = {}
        for sh in self._shards:
            if sh.dim is None:
                full = self._local(flat, sh).float()
            else:
                full = torch.movedim(self._rows(rows, sh).reshape(
                    (-1,) + sh.moved(self.shard_world)[2:]), 0, sh.dim)
            dim = self._expert_dims.get(sh.slot.path)
            if dim is not None:
                full = comm.all_gather(full.contiguous(),
                                       group=self.replica_group,
                                       gather_axis=dim)
            _set_path(tree, sh.slot.path,
                      full.detach().to(device, copy=True))
        return tree

    def full_loco_err(self) -> Dict[str, Any]:
        """Every rank's LoCo residual as JAX's ``state["loco_err"]``: per
        leaf [world, *shape] (row r = rank r's residual, the moved layout's
        elements in the leaf's shape — [Z, shape[dim]/Z, ...] under hpZ;
        zeros for replicated leaves)."""
        rows = torch.empty((self.world,) + tuple(self.loco_err.shape),
                           dtype=torch.float32, device=self.device)
        comm.all_gather_into_tensor(rows, self.loco_err)
        tree: Dict[str, Any] = {}
        for sh in self._shards:
            shape = (self.world,) + sh.slot.shape
            if sh.dim is None:
                err = torch.zeros(shape)
            else:
                err = rows[:, :, sh.offset:sh.offset + sh.n_loc].reshape(
                    shape).cpu().clone()
            _set_path(tree, sh.slot.path, err)
        return tree


class Zero3Engine(DataParallelEngine):
    """ZeRO stage 3 over the default process group: the compute
    parameters sharded too, gathered per use by layer chunks
    (``parallel/stage3.py``), with the exact wire or the ZeRO++ int8 wire.

    JAX at ``data`` = world (``param_spec`` at stage 3, GSPMD's per-use
    gathers; ``chunked_gather_tree_fn`` on the int8 wire). Each rank holds
    only shards between steps: the fp32 master, the Adam moments, the
    gradient accumulator, the compute-dtype shard (bf16: the one Adam
    writes; fp16: cast after the update; fp32: the master itself), the
    replicated leaves' buffer and, with LoCo, its residual. No full compute
    copy, no full gradient and no packed [world, n_sh] buffer persists;
    the layout (each leaf's ZeRO dim) is ZeRO-2's.

    The forward and the backward's recompute gather the head group and
    each layer chunk of the plan when they use it (the next chunk in
    flight under ``overlap_comm``); the chunks are
    ``overlap_plan()["chunk_bounds"]``, else ``stage3_prefetch_bucket_size``'s
    chunks without prefetch when ``overlap_comm`` is off — whole leaves
    on the qwZ wire then, as JAX's straight-through step quantizes them.
    Exact wire: each chunk's gradient is reduce-scattered when its
    backward is done and its mean shard added to the accumulator. qgZ /
    LoCo: as ZeRO-2 per micro-batch, on a full gradient held for the step
    only (JAX's wire step holds the same transient). The update is ZeRO-2's
    over the shards (by ``update_bucket_size`` buckets under
    ``overlap_step``); nothing is published after it: the next forward
    gathers what it uses. (JAX's ``overlap_step`` double buffer holds the
    values such a gather gives — ``compressed.publish_gather_tree_fn`` — so
    gathering per use computes the same step.) A spec whose loss does not
    take the parameter hook (anything but ``causal_lm_spec``'s) is handed
    its whole tree, gathered as one group each forward, its gradient
    reduced when the backward is done. With ``offload_param`` streaming,
    the fp32 exact wire gathers each group from the master in pinned host
    memory."""

    def _init_state(self, seed: int) -> None:
        # causal_lm_spec's layer loop takes the parameter hook; any other
        # spec is handed the whole tree, gathered as one group
        self._hooked = isinstance(getattr(self.model_spec, "config", None),
                                  T.TransformerConfig)
        self._shard_topology()
        tree = self._init_tree(seed)
        self._init_shards(tree)
        del tree
        cdt = self.compute_dtype
        self._shard_cast = (torch.zeros_like(self.flat_master, dtype=cdt)
                            if cdt == torch.float16 else None)
        # the int8 gradient wire's step-long buffers (``_step_buffers``)
        self.flat_compute = self.flat_grad = self._packed = None
        self._zero3 = S3.Stage3Params(
            self, self._stage3_bounds(), prefetch=self._overlap.enabled,
            recompute=self._hooked and self.model_spec.config.remat in (
                "full", "save_nothing"))
        self._params = self._zero3
        self._compute_params()
        logger.info(
            f"rank {self.rank}/{self.world}: ZeRO-3 wire="
            f"{self._wire_format()} groups={len(self._zero3.groups)} "
            f"shards over {self.shard_world} ranks "
            f"sharded={self._n_sh} replicated={self._n_rep} elements per "
            "rank")

    def _stage3_bounds(self):
        """The plan's chunks; with ``overlap_comm`` off, the chunks the
        plan would have (no prefetch) — none on the qwZ wire, whose
        straight-through JAX step quantizes whole leaves."""
        if self._overlap.enabled:
            return self._overlap_plan["chunk_bounds"]
        if self._quant_weights():
            return []
        return self._layer_bounds()

    def _gather_source(self) -> torch.Tensor:
        """The compute-dtype local shard the exact wire gathers."""
        for t in (self._shard_compute, self._shard_cast):
            if t is not None:
                return t
        return self.flat_master

    def _rep_view(self, sh: _Shard) -> torch.Tensor:
        """A replicated leaf in the replicated-gradient buffer."""
        return self._rep_buf[sh.offset:sh.offset + sh.n_loc].view(
            sh.slot.shape)

    def _derived(self) -> Optional[torch.Tensor]:
        for t in (self._shard_compute, self._shard_cast):
            if t is not None:
                return t
        return None

    def _compute_params(self, shard_written: bool = False) -> None:
        """Refresh the compute-dtype shard from the master (bf16 unless
        Adam has just written it; streamed from the host tier, where the
        streamed update has written it); nothing is gathered here."""
        if self._streaming():
            if not shard_written:
                self._stream_pass()
            return
        with torch.no_grad():
            if self._shard_compute is not None and not shard_written:
                self._shard_compute.copy_(self.flat_master)
            if self._shard_cast is not None:
                self._shard_cast.copy_(self.flat_master)

    @contextlib.contextmanager
    def _step_buffers(self):
        """qgZ / LoCo: the full gradient (compute dtype) and the packed
        [Z, n_sh] fp32 rows, for one step."""
        if not self._quant_grads():
            yield
            return
        self.flat_grad = torch.zeros(self._numel, dtype=self.compute_dtype,
                                     device=self.device)
        self._packed = torch.zeros(self.shard_world, self._n_sh,
                                   dtype=torch.float32, device=self.device)
        try:
            yield
        finally:
            self.flat_grad = self._packed = None

    def _loss_and_grads(self, mb, scale: Optional[float]) -> torch.Tensor:
        if self.flat_grad is not None:
            self.flat_grad.zero_()
        z = self._zero3
        z.begin_forward()
        loss = self.model_spec.loss_fn(z if self._hooked else z.tree(), mb)
        z.begin_backward()
        (loss * scale if scale is not None else loss).backward()
        z.finish_micro()
        return loss.detach()

    def _reduce_micro(self, last: bool) -> None:
        """qgZ / LoCo once per micro-batch; the exact wire has reduced in
        the backward."""
        if self._quant_grads():
            self._reduce_micro_int8()

    def _reduce_step(self) -> None:
        if not self._quant_grads() and self._n_rep:
            with torch.no_grad():
                self.flat_grad_acc[self._n_sh:].copy_(self._replicated_mean())

    def _dispatch_train_step(self, stacked, gas: int) -> torch.Tensor:
        for k in self._zero3.counts:
            self._zero3.counts[k] = 0
        return super()._dispatch_train_step(stacked, gas)

    def close(self) -> None:
        """Stop the coordinator's communication thread."""
        self._zero3.close()
        super().close()


def zero_layout(model: ModelSpec, slots: List[_Slot], world: int,
                zero_stage: int, sizes: Dict[str, int], expert_paths=()
                ) -> Tuple[List[_Shard], int, int]:
    """Each leaf's place in a rank's local buffers → (shards, sharded
    elements, replicated elements), ``world`` the ranks a shard is split
    over (the ``zshard`` axis under hpZ, ``(data, zshard)`` under an expert
    axis). The sharded dim is JAX's
    (``parallel/partitioning.ShardingPolicy.state_spec`` from the model's
    logical axes); a spec without ``axes_fn`` replicates every leaf. The
    leaves of ``expert_paths`` come after the others in each region."""
    specs: Dict[Tuple[str, ...], Any] = {slot.path: () for slot in slots}
    if model.axes_fn is not None:
        shapes: Dict[str, Any] = {}
        for slot in slots:
            _set_path(shapes, slot.path, slot.shape)
        tree = ShardingPolicy(sizes, zero_stage).state_spec(model.axes_fn(),
                                                            shapes)
        specs = dict(_flatten(tree))
    placed: Dict[Tuple[str, ...], _Shard] = {}
    sh_off = rep_off = 0
    for expert in (False, True):
        for slot in slots:
            if (slot.path in expert_paths) != expert:
                continue
            dim = C.sharded_dim(specs[slot.path], (mesh_mod.DATA_AXIS,
                                                   mesh_mod.ZSHARD_AXIS))
            if dim is None:
                placed[slot.path] = _Shard(slot, None, slot.numel, rep_off)
                rep_off += -(-slot.numel // _ALIGN) * _ALIGN
            else:
                n_loc = slot.numel // world
                placed[slot.path] = _Shard(slot, dim, n_loc, sh_off)
                sh_off += -(-n_loc // QK.DEFAULT_BLOCK) * QK.DEFAULT_BLOCK
    return [placed[slot.path] for slot in slots], sh_off, rep_off


def rank_device(device=None) -> torch.device:
    """A rank's device: the caller's, else ``cuda:{LOCAL_RANK}`` when that
    card exists; raises otherwise (never a silent ``cuda:0``)."""
    if device is not None:
        return resolve_device(device)
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        raise RuntimeError("a data-parallel rank needs its device: pass "
                           "device=, or set LOCAL_RANK")
    return resolve_device(f"cuda:{int(local)}")
