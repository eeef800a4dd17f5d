"""JSON config → typed config tree: the subset the training engine reads.

Ports ``deepspeed_tpu/runtime/config.py``: ``DeepSpeedTPUConfig`` (:1188)
with the batch triple and ``resolve_batch_size``, ``gradient_clipping``,
``steps_per_print``, ``prescale_gradients``, ``seed``, and the sections
``fp16``, ``bf16``, ``optimizer``, ``scheduler``, ``zero_optimization``,
``data_types``, ``activation_checkpointing``, ``mesh``,
``sequence_parallel`` (:1078), ``tensor_parallel`` (:1071, inert as in
JAX: the ``mesh`` section's ``tensor`` axis sets the width) and
``pipeline`` (:1090, parsed and read by nothing, as in JAX: the ``mesh``
section's ``pipe`` axis sets the stages and ``causal_lm_spec``'s
``pipeline_micro_batches`` the micro-batches) — copied field for field
with the same defaults and the same validation, so the same JSON gives the
same values and a wrong one raises the same ``DeepSpeedConfigError``. The
mesh resolves over the processes of the default process group
(``comm/mesh.initialize_mesh``).

The sections ``checkpoint`` and ``fault_tolerance`` (JAX :904-975) and the
legacy top-level ``checkpoint_writer`` are read as JAX reads them, with the
environment defaults ``DSTPU_RESUME_DIR`` and ``DSTPU_AUTO_RESUME``;
``fault_tolerance.on_stall`` other than ``"log"`` raises
``NotImplementedError`` (it needs the stall watchdog and tracing). The JAX
package's other sections (telemetry, serving, ...) are not read by this
slice. :func:`load_config` accepts one only while it
is inert — absent, empty or ``{"enabled": false}`` — and raises
``NotImplementedError`` naming the later slice otherwise; nothing is
silently ignored. Keys
neither package knows warn and are ignored, as in JAX; the reference's
CUDA-only sections are accepted and ignored, as in JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.runtime.config_utils import (
    DeepSpeedConfigError,
    config_from_dict,
    later_slice,
    logger,
)


@dataclasses.dataclass
class FP16Config:
    """Reference ``runtime/fp16`` config section."""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 = dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0.0


@dataclasses.dataclass
class BF16Config:
    enabled: bool = False
    # bf16 grad accumulation dtype (reference bf16 section + data_types)
    immediate_grad_update: bool = True
    # False drops the fp32 master copy (the JAX package pairs it with a
    # stochastic-rounding optimizer, adafactor; a later slice here)
    fp32_master: bool = True


@dataclasses.dataclass
class OptimizerConfig:
    type: str = "adam"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class OffloadConfig:
    """Reference ``runtime/zero/offload_config.py`` analog."""
    device: str = "none"  # none | cpu (host memory) | nvme
    nvme_path: Optional[str] = None
    pin_memory: bool = True
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    ratio: float = 1.0
    # SuperOffload-class host execution (reference superoffload_stage3.py):
    # run the optimizer update ON the host CPU backend with fp32 master +
    # moments resident in host RAM; device keeps 16-bit params only.
    host_step: bool = False
    # ZenFlow overlap semantics for host_step: defer applying the host
    # update by one step so it fully overlaps device compute. None = unset:
    # zenflow.overlap_step decides when zenflow is enabled, else off. An
    # explicit False always wins (no silent staleness).
    overlap_step: Optional[bool] = None


@dataclasses.dataclass
class ZenFlowSectionConfig:
    """``zero_optimization.zenflow`` (``deepspeed_tpu/runtime/zenflow.py``;
    run by ``runtime/zenflow.py``). ``select_strategy`` is accepted and
    inert, as in JAX (importance is |g|)."""
    enabled: bool = False
    topk_ratio: float = 0.01
    update_interval: int = 4
    full_warm_up_rounds: int = 0
    select_strategy: str = "auto"
    overlap_step: bool = True


@dataclasses.dataclass
class ZeroConfig:
    """``zero_optimization`` (``deepspeed_tpu/runtime/config.py:89``), every
    key and its validation, JAX's defaults. The engines run stages 0-3,
    with the exact wire or the ZeRO++ int8 wire (qgZ / qwZ / LoCo) between
    processes, hpZ / MiCS subgroups, the offload tiers, ZenFlow and
    SuperOffload (``runtime/engine.py`` ``_resolve_offload``); one process
    partitions nothing. ``pin_memory``, ``buffer_count``, ``buffer_size``
    and ``ratio`` of the offload sections are accepted and inert. ``overlap_comm`` with
    ``allgather_bucket_size`` (stages 1-2) or ``stage3_prefetch_bucket_size``
    (stage 3) sets the overlap plan's layer chunks (``parallel/overlap.py``):
    qwZ's quantization blocks and ZeRO-3's gathers, the next chunk's gather
    in flight. ``stage3_max_live_parameters``,
    ``stage3_max_reuse_distance`` and ``stage3_param_persistence_threshold``
    are accepted and inert, as in JAX (its ``analysis/rules/
    config_keys.py:73-75``); so are ``reduce_bucket_size``,
    ``overlap_step`` and ``update_bucket_size``, which order JAX's fenced
    sends and its double-buffered publish, neither of which the port
    keeps."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: bool = True
    # step-phase overlap (2004.13336): bucketed weight update under the
    # fence chain + deferred param publish double-buffered into the next
    # forward. Gated by overlap_comm like the rest of the scheduler.
    overlap_step: bool = True
    # "auto" = follow reduce_bucket_size (update buckets chain onto the
    # grad-sync buckets one-for-one); element counts otherwise
    update_bucket_size: Any = "auto"
    offload_optimizer: OffloadConfig = dataclasses.field(default_factory=OffloadConfig)
    offload_param: OffloadConfig = dataclasses.field(default_factory=OffloadConfig)
    sub_group_size: int = 1_000_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_prefetch_bucket_size: int = 50_000_000
    stage3_param_persistence_threshold: int = 100_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    # ZeRO++ knobs (hpZ / qwZ / qgZ — reference zero/config.py:309-330)
    zero_hpz_partition_size: int = 1
    # MiCS replica-group sharding (reference zero/mics.py:63 MiCS_Init): shard
    # ZeRO state within groups of this size, replicate across groups. Resolved
    # onto the JAX package's 'zshard' mesh axis; zero_hpz_partition_size
    # behaves the same way (a later slice here).
    mics_shard_size: int = 0
    mics_hierarchical_params_gather: bool = False
    # ZenFlow importance-split updates (reference runtime/zenflow/)
    zenflow: ZenFlowSectionConfig = dataclasses.field(
        default_factory=ZenFlowSectionConfig)
    # SuperOffload alias (reference superoffload/superoffload_stage3.py):
    # equivalent to offload_optimizer={"device": "cpu", "host_step": true,
    # "overlap_step": true}
    super_offload: bool = False
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_quantized_nontrainable_weights: bool = False
    # LoCo error feedback for the quantized gradient reduce (reference
    # runtime/comm/coalesced_collectives.py:81 all_to_all_loco_quant_reduce):
    # per-rank residual re-enters the next round's send. Requires
    # zero_quantized_gradients; costs one full-gradient-sized fp32 buffer
    # per rank.
    loco_error_feedback: bool = False
    round_robin_gradients: bool = False
    ignore_unused_parameters: bool = True

    def validate(self) -> None:
        if self.stage not in (0, 1, 2, 3):
            raise DeepSpeedConfigError(f"zero_optimization.stage must be 0-3, got {self.stage}")
        for key in ("reduce_bucket_size", "allgather_bucket_size",
                    "stage3_prefetch_bucket_size"):
            val = getattr(self, key)
            # reference-ecosystem spellings normalize: JSON scientific
            # notation (5e8 -> float) coerces to int, HF-integration
            # "auto" falls back to the schema default
            if val == "auto":
                val = dataclasses.fields(type(self))
                val = next(f.default for f in val if f.name == key)
                setattr(self, key, val)
            elif isinstance(val, float) and not isinstance(val, bool) \
                    and float(val).is_integer():
                val = int(val)
                setattr(self, key, val)
            if not isinstance(val, int) or isinstance(val, bool) or val <= 0:
                # consumed by the overlap scheduler (parallel/overlap.py):
                # a zero/negative bucket would plan nothing silently
                raise DeepSpeedConfigError(
                    f"zero_optimization.{key} must be a positive int "
                    f"(elements), got {val!r}")
        # update_bucket_size follows the same normalization contract but
        # keeps "auto" as its resolved spelling: auto = follow
        # reduce_bucket_size (the engine resolves it, which knows the
        # final reduce bucket after ITS coercion)
        ub = self.update_bucket_size
        if ub != "auto":
            if isinstance(ub, float) and not isinstance(ub, bool) \
                    and float(ub).is_integer():
                ub = int(ub)
                self.update_bucket_size = ub
            if not isinstance(ub, int) or isinstance(ub, bool) or ub <= 0:
                raise DeepSpeedConfigError(
                    "zero_optimization.update_bucket_size must be a "
                    f"positive int (elements) or \"auto\", got {ub!r}")
        if not isinstance(self.overlap_step, bool):
            raise DeepSpeedConfigError(
                "zero_optimization.overlap_step must be a bool, got "
                f"{self.overlap_step!r}")
        # the subgroup keys follow the same normalization contract but
        # both have an OFF spelling the reference schema allows (hpZ:
        # ge=0 — 0 and 1 both mean no secondary partition; MiCS: 0) —
        # non-negative, never positive-only. Anything else raises loudly:
        # a malformed subgroup silently degrading to exact full-world
        # collectives is the config-no-op class of bug. The mesh-
        # dependent half (must divide and fit the device world) lives in
        # the engine, which knows the world.
        for key in ("zero_hpz_partition_size", "mics_shard_size"):
            val = getattr(self, key)
            if val == "auto":
                val = dataclasses.fields(type(self))
                val = next(f.default for f in val if f.name == key)
                setattr(self, key, val)
            elif isinstance(val, float) and not isinstance(val, bool) \
                    and float(val).is_integer():
                val = int(val)
                setattr(self, key, val)
            if not isinstance(val, int) or isinstance(val, bool) or val < 0:
                raise DeepSpeedConfigError(
                    f"zero_optimization.{key} must be a non-negative int "
                    f"(ranks; 0 = off), got {val!r}")


@dataclasses.dataclass
class ActivationCheckpointingConfig:
    """Reference ``runtime/activation_checkpointing`` config: ``policy``
    selects the remat policy of the layer loop (``torch.utils.checkpoint``
    per layer for ``full``)."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    # named remat policy of the layer loop (none | full in this slice)
    policy: str = "none"  # none | full | dots_saveable | save_nothing | offload_dots


@dataclasses.dataclass
class DataTypesConfig:
    grad_accum_dtype: Optional[str] = None


@dataclasses.dataclass
class MeshSectionConfig:
    """Named mesh axis sizes (``deepspeed_tpu/runtime/config.py:1057``);
    -1 absorbs the remaining processes."""
    pipe: int = 1
    data: int = -1
    zshard: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def to_mesh_config(self):
        from deepspeed_tpu_torch.comm.mesh import MeshConfig

        return MeshConfig(pipe=self.pipe, data=self.data, zshard=self.zshard,
                          expert=self.expert, seq=self.seq, tensor=self.tensor)


@dataclasses.dataclass
class CheckpointSectionConfig:
    """Durable-checkpoint knobs (``checkpoint/fault_tolerance.py``; JAX
    ``config.py:904``). Every save commits atomically: tmp-dir write →
    fsync → ``COMMITTED`` manifest (per-file size + CRC32 + step) → rename
    → ``latest``. ``writer`` supersedes the legacy top-level
    ``checkpoint_writer`` when set (the port writes JAX's per-leaf
    ``fast`` layout for either value). ``keep_n`` prunes all but the
    newest N committed tags after each commit (0 = keep everything).
    ``verify_checksums=False`` skips the CRC pass on load and walk-back.
    Transient I/O errors retry ``save_retries`` times with exponential
    backoff (``retry_backoff_s`` doubling) + uniform jitter
    (``retry_jitter_s``)."""
    writer: Optional[str] = None   # orbax | fast (None → checkpoint_writer)
    keep_n: int = 0
    verify_checksums: bool = True
    fsync: bool = True
    save_retries: int = 3
    retry_backoff_s: float = 0.2
    retry_jitter_s: float = 0.2

    def validate(self) -> None:
        if self.writer not in (None, "orbax", "fast"):
            raise DeepSpeedConfigError(
                f"checkpoint.writer must be orbax|fast, got {self.writer!r}"
                " (a typo would silently fall back to the orbax path)")


@dataclasses.dataclass
class FaultToleranceConfig:
    """Preemption-safe training (JAX ``config.py:931``; the engine's
    preemption handler and ``maybe_auto_resume``). ``resume_dir`` is the
    checkpoint root of ``auto_resume`` and of emergency saves (env
    ``DSTPU_RESUME_DIR`` supplies a default). ``auto_resume=True`` makes
    ``initialize`` restore the newest committed checkpoint there before
    returning; a missing or empty dir is a cold start (env
    ``DSTPU_AUTO_RESUME=1`` enables it too). ``graceful_preemption``
    installs a SIGTERM handler that drains an in-flight async save,
    writes an emergency checkpoint and exits 0; it arms only when
    ``resume_dir`` or ``auto_resume`` is set. ``on_stall`` beyond
    ``"log"`` escalates the stall watchdog, which comes with tracing in a
    later slice."""
    # tri-state: the env default cannot override an explicit false
    auto_resume: Optional[bool] = None
    resume_dir: Optional[str] = None
    graceful_preemption: bool = True
    emergency_tag_prefix: str = "emergency"
    on_stall: str = "log"   # log | dump_trace | checkpoint

    def validate(self) -> None:
        if self.on_stall not in ("log", "dump_trace", "checkpoint"):
            raise DeepSpeedConfigError(
                f"fault_tolerance.on_stall must be log|dump_trace|"
                f"checkpoint, got {self.on_stall!r}")
        if self.on_stall != "log":
            raise later_slice(
                f"fault_tolerance.on_stall={self.on_stall!r} (the stall "
                "watchdog and tracing, queue A.5)")


@dataclasses.dataclass
class SequenceParallelConfig:
    """AutoSP (JAX ``runtime/config.py:1078-1088``): with ``auto`` the
    engine runs the planning pass (``sequence/auto_sp.py``) over the model
    spec at initialize, choosing Ulysses or the K/V ring on the mesh's
    ``seq`` axis; ``size``, where set, must match that axis."""
    auto: bool = False
    size: int = 0


@dataclasses.dataclass
class PipelineSectionConfig:
    """The reference's ``pipeline`` section (JAX ``runtime/config.py:
    1090-1093``), parsed and read by nothing, as in JAX."""
    stages: int = 1
    micro_batches: Optional[int] = None
    activation_checkpoint_interval: int = 0


@dataclasses.dataclass
class TensorParallelConfig:
    """AutoTP's knobs (JAX ``runtime/config.py:1071-1074``), read and
    inert as in JAX: the ``tensor`` mesh axis sets the width."""
    autotp_size: int = 1
    tp_grain_size: int = 1


# CUDA-only reference sections accepted and ignored (as in JAX)
_IGNORED_SECTIONS = (
    "amp", "aio", "hybrid_engine", "compression_training",
    "sparse_attention", "zero_allow_untested_optimizer", "communication_data_type",
)

# sections of the JAX config that this slice does not read
_UNREAD_SECTIONS = (
    "comms_logger", "telemetry", "serving", "fleet", "tenancy", "slo",
    "hlolint", "memlint", "autotuning", "elasticity", "flops_profiler",
    "tensorboard", "csv_monitor", "wandb", "comet", "guardian", "data_efficiency", "curriculum_learning",
    "progressive_layer_drop",
)
# top-level scalars of the JAX config that this slice does not read, with
# their JAX defaults
_UNREAD_KEYS = {
    "wall_clock_breakdown": False, "memory_breakdown": False,
    "gradient_predivide_factor": 1.0, "dump_state": False,
    "zero_force_ds_cpu_optimizer": False, "checkpoint_tag_validation": "Warn",
}


def _inert(value: Any) -> bool:
    if value is None or value == {}:
        return True
    if not isinstance(value, dict):
        return False
    return value.get("enabled") is False


@dataclasses.dataclass
class DeepSpeedTPUConfig:
    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    prescale_gradients: bool = False
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = dataclasses.field(default_factory=FP16Config)
    bf16: BF16Config = dataclasses.field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = dataclasses.field(default_factory=ZeroConfig)
    activation_checkpointing: ActivationCheckpointingConfig = dataclasses.field(
        default_factory=ActivationCheckpointingConfig)
    data_types: DataTypesConfig = dataclasses.field(default_factory=DataTypesConfig)
    mesh: MeshSectionConfig = dataclasses.field(default_factory=MeshSectionConfig)
    sequence_parallel: SequenceParallelConfig = dataclasses.field(
        default_factory=SequenceParallelConfig)
    tensor_parallel: TensorParallelConfig = dataclasses.field(
        default_factory=TensorParallelConfig)
    pipeline: PipelineSectionConfig = dataclasses.field(
        default_factory=PipelineSectionConfig)
    seed: int = 1234
    checkpoint_writer: str = "orbax"  # orbax | fast (checkpoint_engine.py)
    checkpoint: CheckpointSectionConfig = dataclasses.field(
        default_factory=CheckpointSectionConfig)
    fault_tolerance: FaultToleranceConfig = dataclasses.field(
        default_factory=FaultToleranceConfig)

    # resolved fields (filled by resolve_batch_size)
    _dp_world_size: int = 1

    @property
    def zero_enabled(self) -> bool:
        return self.zero_optimization.stage > 0

    @property
    def effective_checkpoint_writer(self) -> str:
        """``checkpoint.writer`` when set, else the legacy top-level
        ``checkpoint_writer`` (both spellings stay valid)."""
        return self.checkpoint.writer or self.checkpoint_writer

    @property
    def precision_dtype(self) -> str:
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        if self.fp16.enabled:
            return "float16"
        if self.bf16.enabled:
            return "bfloat16"
        return "float32"

    def resolve_batch_size(self, dp_world_size: int) -> None:
        """Batch-size triad resolution: train = micro × GAS × dp (reference
        ``runtime/config.py`` ``_batch_assertion``)."""
        self._dp_world_size = dp_world_size
        tb, mb, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp_world_size:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} != micro {mb} × gas {gas} × dp {dp_world_size}")
        elif tb is not None and mb is not None:
            if tb % (mb * dp_world_size) != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} not divisible by micro {mb} × dp {dp_world_size}")
            self.gradient_accumulation_steps = tb // (mb * dp_world_size)
        elif tb is not None and gas is not None:
            if tb % (gas * dp_world_size) != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} not divisible by gas {gas} × dp {dp_world_size}")
            self.train_micro_batch_size_per_gpu = tb // (gas * dp_world_size)
        elif tb is not None:
            self.gradient_accumulation_steps = 1
            if tb % dp_world_size != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size {tb} not divisible by dp {dp_world_size}")
            self.train_micro_batch_size_per_gpu = tb // dp_world_size
        elif mb is not None:
            self.gradient_accumulation_steps = gas or 1
            self.train_batch_size = mb * self.gradient_accumulation_steps * dp_world_size
        else:
            raise DeepSpeedConfigError(
                "config must set train_batch_size or train_micro_batch_size_per_gpu")


def load_config(config) -> DeepSpeedTPUConfig:
    """Accepts a dict, a JSON file path, or an existing config object."""
    if isinstance(config, DeepSpeedTPUConfig):
        return config
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise DeepSpeedConfigError(f"config must be dict or path, got {type(config)}")
    config = dict(config)
    for section in _IGNORED_SECTIONS:
        if section in config:
            logger.warning(f"config section {section!r} is not applicable on "
                           "this backend — ignored")
            config.pop(section)
    for section in _UNREAD_SECTIONS:
        value = config.pop(section, None)
        if not _inert(value):
            raise later_slice(f"config section {section!r}")
    for key, default in _UNREAD_KEYS.items():
        if key in config and config.pop(key) != default:
            raise later_slice(f"config key {key!r} (non-default)")
    cfg = config_from_dict(DeepSpeedTPUConfig, config)
    # the launcher's environment defaults; explicit JSON settings win
    env_dir = os.environ.get("DSTPU_RESUME_DIR")
    if env_dir and cfg.fault_tolerance.resume_dir is None:
        cfg.fault_tolerance.resume_dir = env_dir
    if cfg.fault_tolerance.auto_resume is None and \
            os.environ.get("DSTPU_AUTO_RESUME", "").lower() in \
            ("1", "true", "yes"):
        cfg.fault_tolerance.auto_resume = True
    return cfg
