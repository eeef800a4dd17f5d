"""PyTorch/CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package beside this one is the reference: every module here mirrors
a module path there (``deepspeed_tpu_torch/inference/fastgen.py`` is the
counterpart of ``deepspeed_tpu/inference/fastgen.py``) and keeps its tensor
layouts at the public functions, so the parity tests feed both the same
numpy inputs. This package imports ``torch`` and never ``jax`` or anything
of ``deepspeed_tpu``.

Ported so far:

* serving — FastGen continuous batching over the paged KV pool
  (``inference/fastgen.py``, ``models/paged.py``) with paged attention in
  CUDA C++ (``ops/csrc/paged_attention.cu``) and RMSNorm/LayerNorm in
  Triton (``ops/norms.py``);
* training — :func:`initialize` → ``engine.train_batch``
  (``runtime/engine.py``) over ``causal_lm_spec`` models, with flash
  attention forward / dq / dkv (``ops/csrc/flash_attention.cu``) and fused
  Adam (``ops/csrc/fused_adam.cu``) in CUDA C++; the MoE FFN's grouped GEMM,
  block-sparse attention and the Evoformer forward;
* data-parallel training over ``torch.distributed`` —
  :func:`init_distributed`, then :func:`initialize` builds a
  ``DataParallelEngine``: ZeRO stages 0-2 with the exact wire or the ZeRO++
  int8 wire (qgZ, qwZ, LoCo: ``parallel/compressed.py``) through the int8
  quantize and dequant-reduce kernels (``ops/csrc/quantization.cu``); at
  stage 3 a ``Zero3Engine``, whose parameters are gathered per use by the
  overlap plan's layer chunks with the next chunk's gather in flight
  (``parallel/stage3.py``, ``parallel/overlap.py``);
* offload — the optimizer state in pinned host memory or NVMe files
  between steps, the ZeRO-3 master's host and NVMe tiers
  (``runtime/swap_tensor.py`` over ``ops/aio.py``), ZenFlow's
  importance-split update (``runtime/zenflow.py``) and SuperOffload's
  host-executed step with its overlap schedule (``runtime/host_step.py``);
* checkpoints — ``engine.save_checkpoint`` / ``load_checkpoint`` in the JAX
  package's per-leaf layout on every engine and tier, universal
  checkpoints, preemption saves and auto-resume (``checkpoint/``).

Entry points run on the GPU unless the caller asks for the CPU
(``device="cpu"``); with no CUDA device and no explicit device they raise.
"""
from typing import Any, Optional, Tuple

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.comm import init_distributed
from deepspeed_tpu_torch.models.api import ModelSpec, causal_lm_spec
from deepspeed_tpu_torch.runtime.config import DeepSpeedTPUConfig, load_config
from deepspeed_tpu_torch.runtime.engine import (
    DataParallelEngine,
    DeepSpeedTPUEngine,
    Zero3Engine,
)

__all__ = ["DataParallelEngine", "DeepSpeedTPUConfig", "DeepSpeedTPUEngine",
           "ModelSpec", "Zero3Engine", "causal_lm_spec", "init_distributed", "initialize",
           "load_config", "resolve_device"]


def initialize(args: Any = None, model: Optional[ModelSpec] = None,
               optimizer: Any = None, model_parameters: Any = None,
               training_data: Any = None, lr_scheduler: Any = None,
               config: Any = None, config_params: Any = None,
               device=None, **unused: Any
               ) -> Tuple[DeepSpeedTPUEngine, Any, Any, Any]:
    """The JAX ``deepspeed_tpu.initialize`` (reference ``deepspeed.
    initialize``): returns ``(engine, optimizer, None, lr_scheduler)``.
    ``device`` as in :func:`resolve_device` (``None`` = the first GPU; the
    tests pass ``"cpu"``). With the default process group up and more than
    one process (:func:`init_distributed`) it builds a
    :class:`DataParallelEngine` (:class:`Zero3Engine` at ZeRO stage 3),
    whose ``device`` is the caller's, else
    ``cuda:{LOCAL_RANK}``. The data loader, and the reference's distributed
    arguments, come in a later slice: a ``training_data`` or a non-None
    distributed argument raises."""
    from deepspeed_tpu_torch.runtime.config_utils import later_slice

    config = config if config is not None else config_params
    if config is None and args is not None \
            and hasattr(args, "deepspeed_config"):
        config = args.deepspeed_config
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize requires a "
                         "ModelSpec via `model=`")
    if training_data is not None:
        raise later_slice("initialize(training_data=...) (the data loader)")
    given = sorted(k for k, v in unused.items() if v is not None)
    if given:
        raise later_slice(f"initialize arguments {given}")
    cls = DeepSpeedTPUEngine
    if comm.get_world_size() > 1:
        stage = load_config(config).zero_optimization.stage
        cls = Zero3Engine if stage >= 3 else DataParallelEngine
    engine = cls(model=model, config=config, optimizer=optimizer,
                 lr_scheduler=lr_scheduler, device=device)
    # fault tolerance (JAX __init__.py:73-79): arm the graceful-preemption
    # SIGTERM handler and restore the newest committed checkpoint before
    # handing the engine back
    ft = engine.config.fault_tolerance
    if ft.graceful_preemption and (ft.resume_dir or ft.auto_resume):
        engine.enable_preemption_handler()
    if ft.auto_resume:
        engine.maybe_auto_resume()
    return engine, engine.optimizer, None, engine.lr_scheduler
