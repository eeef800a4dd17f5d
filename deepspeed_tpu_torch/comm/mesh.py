"""Parallel topology over the processes of the default process group.

Ports ``deepspeed_tpu/comm/mesh.py``: the axis names (:24-45),
``MeshConfig`` with ``resolve`` (:47-74), ``MeshManager`` (:77-118) and
``initialize_mesh`` / ``get_mesh_manager`` / ``reset_mesh`` (:124-202). On a
TPU the mesh's "devices" are chips; here they are the processes of the
default ``torch.distributed`` process group (one process without one), each
driving its own device.

This slice runs the ``data`` axis only: ``data = -1`` absorbs the world
size, as JAX's absorbs the device count; a shape that does not fit the
world raises JAX's ``ValueError``; any other axis above 1 raises
``NotImplementedError`` (a later slice).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

from deepspeed_tpu_torch.runtime.config_utils import later_slice, logger

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
ZSHARD_AXIS = "zshard"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"
DEFAULT_AXIS_ORDER: Tuple[str, ...] = (PIPE_AXIS, DATA_AXIS, ZSHARD_AXIS,
                                       EXPERT_AXIS, SEQ_AXIS, TENSOR_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    pipe: int = 1
    data: int = -1  # -1 = absorb all remaining processes
    zshard: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {PIPE_AXIS: self.pipe, DATA_AXIS: self.data,
                 ZSHARD_AXIS: self.zshard, EXPERT_AXIS: self.expert,
                 SEQ_AXIS: self.seq, TENSOR_AXIS: self.tensor}
        fill_axes = [a for a, s in sizes.items() if s == -1]
        fixed = int(np.prod([s for s in sizes.values() if s != -1]))
        if n_devices % fixed != 0:
            raise ValueError(
                f"mesh shape {sizes} does not divide device count {n_devices}")
        remaining = n_devices // fixed
        if not fill_axes:
            if fixed != n_devices:
                raise ValueError(
                    f"mesh shape {sizes} (={fixed}) != device count {n_devices}")
        elif len(fill_axes) == 1:
            sizes[fill_axes[0]] = remaining
        else:
            raise ValueError("at most one mesh axis may be -1")
        return sizes


class MeshManager:
    """The resolved axis sizes of the process world, and the queries the
    JAX ``MeshManager`` answers."""

    def __init__(self, sizes: Dict[str, int]):
        self.shape = dict(sizes)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def world_size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def dp_world_size(self) -> int:
        return int(np.prod([self.axis_size(a) for a in
                            (DATA_AXIS, ZSHARD_AXIS, EXPERT_AXIS, SEQ_AXIS)]))

    @property
    def tp_world_size(self) -> int:
        return self.axis_size(TENSOR_AXIS)

    @property
    def pp_world_size(self) -> int:
        return self.axis_size(PIPE_AXIS)

    @property
    def ep_world_size(self) -> int:
        return self.axis_size(EXPERT_AXIS)

    @property
    def sp_world_size(self) -> int:
        return self.axis_size(SEQ_AXIS)

    def axis_names(self) -> Tuple[str, ...]:
        return DEFAULT_AXIS_ORDER

    def __repr__(self) -> str:
        return f"MeshManager(shape={self.shape})"


_GLOBAL_MESH: Optional[MeshManager] = None


def process_world_size() -> int:
    """Processes of the default process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def initialize_mesh(mesh_config: Optional[MeshConfig] = None) -> MeshManager:
    """Resolve ``mesh_config`` over the process world and install it."""
    global _GLOBAL_MESH
    mesh_config = mesh_config or MeshConfig()
    asked = dataclasses.asdict(mesh_config)
    wider = sorted(a for a, s in asked.items() if a != DATA_AXIS and s > 1)
    if not wider:
        sizes = mesh_config.resolve(process_world_size())
        wider = sorted(a for a, s in sizes.items()
                       if a != DATA_AXIS and s > 1)
    if wider:
        raise later_slice(f"mesh axes {wider} above 1 (this slice runs the "
                          "'data' axis)")
    _GLOBAL_MESH = MeshManager(sizes)
    logger.info(f"initialized process mesh: {_GLOBAL_MESH}")
    return _GLOBAL_MESH


def get_mesh_manager() -> MeshManager:
    if _GLOBAL_MESH is None:
        initialize_mesh()
    return _GLOBAL_MESH


def mesh_is_initialized() -> bool:
    return _GLOBAL_MESH is not None


def reset_mesh() -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = None
