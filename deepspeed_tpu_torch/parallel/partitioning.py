"""ZeRO layout: which dim of each parameter is sharded over ``data``.

Ports the ZeRO half of ``deepspeed_tpu/parallel/partitioning.py``:
``logical_to_spec`` (:65), ``_add_zero_axis`` (:75-90) and
``ShardingPolicy`` ``zero_spec`` / ``param_spec`` / ``state_spec`` /
``grad_spec`` / ``leaf_grad_spec`` (:119-156). A spec is a tuple with one entry per dim — ``None``, an axis
name or a tuple of names — as ``PartitionSpec`` holds them; the mesh is its
axis sizes (``comm/mesh.MeshManager.shape``).

Under an ``expert`` axis a leaf's ``expert`` dim is sharded over it (the
rule ``"expert"``), so ZeRO never picks it, and ZeRO shards over ``(data,
zshard)`` only; the batch shards over ``(data, zshard, expert)`` (JAX's
``batch_spec``): rank r, in that axis order, takes the r-th rows of each
global micro-batch (``runtime/engine.DataParallelEngine._local_rows``).

The ZeRO dim of a leaf is the largest dim that the tensor-parallel rules
leave free and that the ZeRO world divides, ties going to the later dim
(``max((shape[d], d))``), or none (the leaf is replicated). The TP rules
name the 'tensor' axis even at tensor = 1, so the vocab / mlp / heads dims
are never free. The port's shards and quantization blocks must be JAX's, or
qgZ and qwZ quantize different blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.comm.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    PIPE_AXIS,
    TENSOR_AXIS,
    ZSHARD_AXIS,
)

Spec = Tuple[Any, ...]

DEFAULT_TP_RULES: Dict[str, Any] = {
    "vocab": TENSOR_AXIS,
    "mlp": TENSOR_AXIS,
    "heads": TENSOR_AXIS,
    "kv_heads": TENSOR_AXIS,
    "expert": EXPERT_AXIS,
    "embed": None,
    "layers": None,
    "norm": None,
    "seq": None,
}

ZERO_SHARD_AXES: Tuple[str, ...] = (DATA_AXIS, ZSHARD_AXIS)


def logical_to_spec(logical_axes: Tuple[Optional[str], ...],
                    rules: Dict[str, Any]) -> Spec:
    return tuple(None if name is None else rules.get(name)
                 for name in logical_axes)


def _add_zero_axis(spec: Spec, shape: Tuple[int, ...],
                   sizes: Dict[str, int], zero_axes: Tuple[str, ...]) -> Spec:
    """Shard the largest free, divisible dim over the ZeRO axes."""
    zero_size = int(np.prod([sizes.get(a, 1) for a in zero_axes]))
    if zero_size <= 1:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    candidates = [
        (shape[d], d) for d in range(len(shape))
        if parts[d] is None and shape[d] % zero_size == 0
        and shape[d] >= zero_size]
    if not candidates:
        return tuple(parts)
    _, dim = max(candidates)
    parts[dim] = zero_axes if len(zero_axes) > 1 else zero_axes[0]
    return tuple(parts)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _map(fn, axes_tree, shape_tree):
    """``fn(axes, shape)`` over the leaves of a logical-axes tree and the
    matching tree of shapes (tuples of ints, or tensors)."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, tuple(getattr(shape_tree, "shape", shape_tree)))
    return {k: _map(fn, axes_tree[k], shape_tree[k]) for k in axes_tree}


@dataclasses.dataclass
class ShardingPolicy:
    """The resolved ZeRO policy of one engine: ``sizes`` are the mesh's
    axis sizes."""

    sizes: Dict[str, int]
    zero_stage: int
    tp_rules: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_TP_RULES))
    zero_axes: Tuple[str, ...] = ZERO_SHARD_AXES

    def __post_init__(self):
        if self.sizes.get(PIPE_AXIS, 1) > 1:
            self.tp_rules = dict(self.tp_rules, layers=PIPE_AXIS)
        if self.sizes.get(ZSHARD_AXIS, 1) > 1:
            self.zero_axes = (ZSHARD_AXIS,)

    def tp_spec(self, axes_tree, shape_tree) -> Any:
        return _map(lambda axes, _: logical_to_spec(axes, self.tp_rules),
                    axes_tree, shape_tree)

    def zero_spec(self, axes_tree, shape_tree) -> Any:
        """TP + ZeRO-sharded specs (master parameters, optimizer state)."""
        return _map(lambda axes, shape: _add_zero_axis(
            logical_to_spec(axes, self.tp_rules), shape, self.sizes,
            self.zero_axes), axes_tree, shape_tree)

    def param_spec(self, axes_tree, shape_tree) -> Any:
        """The compute parameters' specs: ZeRO-sharded at stage 3 (each
        gathered per use), TP-only below."""
        if self.zero_stage >= 3:
            return self.zero_spec(axes_tree, shape_tree)
        return self.tp_spec(axes_tree, shape_tree)

    def state_spec(self, axes_tree, shape_tree) -> Any:
        if self.zero_stage >= 1:
            return self.zero_spec(axes_tree, shape_tree)
        return self.tp_spec(axes_tree, shape_tree)

    def grad_spec(self, axes_tree, shape_tree) -> Any:
        if self.zero_stage >= 2:
            return self.zero_spec(axes_tree, shape_tree)
        return self.tp_spec(axes_tree, shape_tree)

    def leaf_grad_spec(self, logical_axes: Tuple[Optional[str], ...],
                       shape: Tuple[int, ...]) -> Spec:
        """The gradient spec of ONE leaf of ``shape`` (a layer chunk's
        slice, whose leading dim differs from the stacked leaf's)."""
        spec = logical_to_spec(logical_axes, self.tp_rules)
        if self.zero_stage >= 2:
            spec = _add_zero_axis(spec, tuple(shape), self.sizes,
                                  self.zero_axes)
        return spec
