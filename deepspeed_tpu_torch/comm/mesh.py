"""Parallel topology over the processes of the default process group.

Ports ``deepspeed_tpu/comm/mesh.py``: the axis names (:24-45),
``MeshConfig`` with ``resolve`` (:47-74), ``MeshManager`` (:77-118) and
``initialize_mesh`` / ``get_mesh_manager`` / ``reset_mesh`` (:124-202). On a
TPU the mesh's "devices" are chips; here they are the processes of the
default ``torch.distributed`` process group (one process without one), each
driving its own device.

The ``data`` and ``zshard`` axes run (``data = -1`` absorbs the world
size, as JAX's absorbs the device count; a shape that does not fit the
world raises JAX's ``ValueError``); any other axis above 1 raises
``NotImplementedError`` (a later slice). Ranks take JAX's device order:
``DEFAULT_AXIS_ORDER`` with ``zshard`` inside ``data``, so rank r sits at
``data = r // zshard``, ``zshard = r % zshard``. With ``zshard`` above 1
(hpZ / MiCS) the manager holds this rank's process group of each axis:
the ``zshard`` group (ranks ``d·Z … d·Z + Z − 1``, where ZeRO state is
sharded) and the ``data`` group (ranks ``z, z + Z, …``, the replicas),
each built by ``torch.distributed.new_group`` on every rank in the same
order, as gloo requires.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

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
    """The resolved axis sizes of the process world, the queries the JAX
    ``MeshManager`` answers, this rank's coordinate on each axis and its
    process group over a set of axes (:meth:`group`)."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0,
                 groups: Optional[Dict[Tuple[int, ...], Any]] = None):
        self.shape = dict(sizes)
        self._groups = dict(groups or {})
        self.coords: Dict[str, int] = {}
        rest = rank
        for axis in reversed(DEFAULT_AXIS_ORDER):
            size = self.axis_size(axis)
            self.coords[axis] = rest % size
            rest //= size

    def group_ranks(self, axes: Sequence[str]) -> Tuple[int, ...]:
        """The ranks that share this rank's coordinates off ``axes``, in
        rank order: its subgroup over ``axes``."""
        ranks = [0]
        for axis in DEFAULT_AXIS_ORDER:
            size = self.axis_size(axis)
            picks = range(size) if axis in axes else [self.coords[axis]]
            ranks = [r * size + c for r in ranks for c in picks]
        return tuple(sorted(ranks))

    def group(self, axes: Sequence[str]):
        """This rank's process group over ``axes``: None when it holds
        every process (the default group), else the group built for it
        (``zshard``, or ``data``, at ``zshard`` above 1)."""
        ranks = self.group_ranks(axes)
        if len(ranks) == self.world_size:
            return None
        if ranks not in self._groups:
            raise ValueError(f"no process group over axes {tuple(axes)} "
                             f"(ranks {ranks}) in {self}")
        return self._groups[ranks]

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


_RUNS = (DATA_AXIS, ZSHARD_AXIS)      # the axes this port runs
# the axis groups built so far, by their ranks: dist.new_group is collective,
# so every rank builds the same groups in the same order, once each
_AXIS_GROUPS: Dict[Tuple[int, ...], Any] = {}
_AXIS_OF: Dict[Tuple[int, ...], str] = {}


def _axis_groups(sizes: Dict[str, int]) -> Dict[Tuple[int, ...], Any]:
    """Every process group of the ``zshard`` axis, then of the ``data``
    axis, built on this rank (each rank takes part in building all of
    them); only at ``zshard`` above 1."""
    if sizes[ZSHARD_AXIS] <= 1:
        return {}
    Z, D = sizes[ZSHARD_AXIS], sizes[DATA_AXIS]
    want = [(ZSHARD_AXIS, tuple(d * Z + z for z in range(Z)))
            for d in range(D)]
    want += [(DATA_AXIS, tuple(d * Z + z for d in range(D)))
             for z in range(Z)]
    for axis, ranks in want:
        if ranks not in _AXIS_GROUPS:
            _AXIS_GROUPS[ranks] = dist.new_group(list(ranks))
            _AXIS_OF[ranks] = axis
    return {r: _AXIS_GROUPS[r] for _, r in want}


def group_label(group) -> str:
    """``world`` for the default group (None), else the axis an axis group
    runs over (``zshard`` / ``data``); ``other`` for a group of neither."""
    if group is None:
        return "world"
    for ranks, g in _AXIS_GROUPS.items():
        if g is group:
            return _AXIS_OF[ranks]
    return "other"


def initialize_mesh(mesh_config: Optional[MeshConfig] = None) -> MeshManager:
    """Resolve ``mesh_config`` over the process world and install it."""
    global _GLOBAL_MESH
    mesh_config = mesh_config or MeshConfig()
    asked = dataclasses.asdict(mesh_config)
    wider = sorted(a for a, s in asked.items() if a not in _RUNS and s > 1)
    if not wider:
        sizes = mesh_config.resolve(process_world_size())
        wider = sorted(a for a, s in sizes.items()
                       if a not in _RUNS and s > 1)
    if wider:
        raise later_slice(f"mesh axes {wider} above 1 (this slice runs the "
                          "'data' and 'zshard' axes)")
    rank = dist.get_rank() if process_world_size() > 1 else 0
    _GLOBAL_MESH = MeshManager(sizes, rank, _axis_groups(sizes))
    logger.info(f"initialized process mesh: {_GLOBAL_MESH}")
    return _GLOBAL_MESH


def get_mesh_manager() -> MeshManager:
    if _GLOBAL_MESH is None:
        initialize_mesh()
    return _GLOBAL_MESH


def mesh_is_initialized() -> bool:
    return _GLOBAL_MESH is not None


def reset_mesh() -> None:
    """Forget the mesh and its axis groups (the process group is gone)."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = None
    _AXIS_GROUPS.clear()
    _AXIS_OF.clear()
