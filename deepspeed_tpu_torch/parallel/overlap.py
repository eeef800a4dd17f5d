"""The overlap scheduler's plan: gradient buckets and layer chunks.

Ports the pure, mesh-free half of ``deepspeed_tpu/parallel/overlap.py``:
:data:`MAX_LAYER_CHUNKS` (:60), :class:`OverlapConfig` (:63),
:func:`plan_buckets` (:97), :func:`chunk_layers` (:135),
:func:`even_chunk_bounds` (:159) and :func:`leaf_count` (:326). They are
plain functions over shapes and element counts (the bucket keys count
ELEMENTS, the reference's unit), copied so that the port plans exactly
what the JAX engine plans.

The engines read the plan (``runtime/engine.py``
``_setup_overlap_scheduler``): the layer chunks are the granularity at
which the qwZ publish quantizes (stages 1-2), at which ZeRO-3 gathers the
parameters and reduces their gradients (``parallel/stage3.py``), and at
which the exact stage 1-2 wire reduces during the backward;
:func:`plan_buckets` cuts the other leaves into ``reduce_bucket_size``
buckets and the update into ``update_bucket_size`` buckets
(``DataParallelEngine._reduce_units`` / ``_update_buckets``). The
program-structuring transforms of the JAX module (``fenced_bucket_apply``,
``make_grad_sync``, ``fenced_update_chain``) are the order in which the
port issues each unit's collectives itself, from one queue
(``comm/comm.CommQueue``): a chunk's reduce when the leaves' gradient
hooks say the last micro-batch's backward is done with it (the earlier
micro-batches are summed locally, so the traffic is once a step), an
update bucket's publish when its update is done.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

#: cap on layer chunks, as in JAX: past 8 the overlap windows add nothing
MAX_LAYER_CHUNKS = 8


@dataclasses.dataclass(frozen=True)
class OverlapConfig:
    """Resolved overlap-scheduler knobs of one engine: ``enabled`` is
    ``overlap_comm`` at ZeRO stage >= 1; the bucket sizes count elements."""

    enabled: bool
    reduce_bucket_elems: int
    allgather_bucket_elems: int
    prefetch_bucket_elems: int
    zero_stage: int

    @classmethod
    def from_zero_config(cls, zcfg, zero_stage: int) -> "OverlapConfig":
        return cls(
            enabled=bool(zcfg.overlap_comm) and zero_stage >= 1,
            reduce_bucket_elems=int(zcfg.reduce_bucket_size),
            allgather_bucket_elems=int(zcfg.allgather_bucket_size),
            prefetch_bucket_elems=int(zcfg.stage3_prefetch_bucket_size),
            zero_stage=zero_stage)


def plan_buckets(sizes: Sequence[int], bucket_size: int,
                 order: Optional[Sequence[int]] = None) -> List[List[int]]:
    """Partition leaf indices into size-bounded buckets, greedily in
    ``order`` (default: reversed index order, the backward's completion
    order). A bucket closes when the next leaf would pass ``bucket_size``;
    a leaf larger than the bound gets a bucket of its own, never split."""
    if bucket_size <= 0:
        raise ValueError(f"bucket_size must be positive, got {bucket_size}")
    idxs = list(order) if order is not None else list(
        reversed(range(len(sizes))))
    if sorted(idxs) != list(range(len(sizes))):
        raise ValueError("order must be a permutation of range(len(sizes))")
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_total = 0
    for i in idxs:
        size = int(sizes[i])
        if cur and cur_total + size > bucket_size:
            buckets.append(cur)
            cur, cur_total = [], 0
        cur.append(i)
        cur_total += size
    if cur:
        buckets.append(cur)
    return buckets


def chunk_layers(num_layers: int, per_layer_size: int, chunk_size: int,
                 max_chunks: int = MAX_LAYER_CHUNKS
                 ) -> List[Tuple[int, int]]:
    """Contiguous ``(start, stop)`` layer chunks whose stacked parameters
    stay within ``chunk_size`` elements (at least one layer a chunk, at
    most ``max_chunks`` chunks), split near-evenly."""
    if num_layers <= 0:
        return []
    if per_layer_size <= 0 or chunk_size <= 0:
        return [(0, num_layers)]
    per_chunk = max(1, chunk_size // per_layer_size)
    n_chunks = min((num_layers + per_chunk - 1) // per_chunk,
                   max(1, max_chunks), num_layers)
    return even_chunk_bounds(num_layers, n_chunks)


def even_chunk_bounds(num_items: int, n_chunks: int) -> List[Tuple[int, int]]:
    """``num_items`` split into ``n_chunks`` contiguous near-equal chunks,
    the remainder spread one item at a time from the front."""
    if num_items <= 0:
        return []
    n_chunks = max(1, min(int(n_chunks), num_items))
    base, rem = divmod(num_items, n_chunks)
    bounds: List[Tuple[int, int]] = []
    start = 0
    for c in range(n_chunks):
        stop = start + base + (1 if c < rem else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


def leaf_count(shape: Sequence[int]) -> int:
    """Elements of one leaf (a scalar counts 1): the bucket keys' unit."""
    n = 1
    for d in shape:
        n *= int(d)
    return n
