"""Sequence / context parallelism over the ``seq`` mesh axis.

Ports ``deepspeed_tpu/sequence/`` with its exports:

* :func:`ulysses_attention` / :func:`ulysses_attention_shard_map` — the
  all-to-all head-scatter attention (Ulysses);
* :func:`ring_attention` — the K/V ring;
* :func:`chunked_attention` — FPDT-style query chunking (and
  :func:`~deepspeed_tpu_torch.sequence.tiled.fpdt_attention`, K/V in
  pinned host memory);
* :func:`sequence_tiled_compute` / :func:`tiled_lm_loss` — ALST tiling.
"""
from deepspeed_tpu_torch.sequence.ring import ring_attention
from deepspeed_tpu_torch.sequence.tiled import (
    chunked_attention,
    sequence_tiled_compute,
    tiled_lm_loss,
)
from deepspeed_tpu_torch.sequence.ulysses import (
    ulysses_attention,
    ulysses_attention_shard_map,
)

__all__ = [
    "ring_attention",
    "chunked_attention",
    "sequence_tiled_compute",
    "tiled_lm_loss",
    "ulysses_attention",
    "ulysses_attention_shard_map",
]
