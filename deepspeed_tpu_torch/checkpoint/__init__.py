"""Checkpoint subsystem of the port: tagged-dir save/load in JAX's
per-leaf layout, the writers, universal checkpoints, and the
fault-tolerance layer (atomic commits, integrity manifests, walk-back
recovery — ``checkpoint/fault_tolerance.py``). Counterpart of
``deepspeed_tpu/checkpoint/``; its exports are JAX's."""
from deepspeed_tpu_torch.checkpoint.fault_tolerance import (  # noqa: F401
    COMMIT_MARKER,
    CheckpointCorruptError,
    committed_tags,
    find_restore_tag,
    gc_tags,
    verify_tag,
)
