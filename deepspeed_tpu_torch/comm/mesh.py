"""Parallel topology over the processes of the default process group.

Ports ``deepspeed_tpu/comm/mesh.py``: the axis names (:24-45),
``MeshConfig`` with ``resolve`` (:47-74), ``MeshManager`` (:77-118) and
``initialize_mesh`` / ``get_mesh_manager`` / ``reset_mesh`` (:124-202). On a
TPU the mesh's "devices" are chips; here they are the processes of the
default ``torch.distributed`` process group (one process without one), each
driving its own device.

Every axis runs (``data = -1`` absorbs the world size, as JAX's absorbs
the device count; a shape that does not fit the world raises JAX's
``ValueError``). Ranks take JAX's device order: ``DEFAULT_AXIS_ORDER``
with ``tensor`` inside ``seq`` inside ``expert`` inside ``zshard`` inside
``data`` inside ``pipe``, so rank r sits at ``tensor = r % T``, ``seq =
(r // T) % Q``, ``expert = (r // (T·Q)) % X`` and so on outwards, ``pipe
= r // (world / P)`` outermost. The manager holds this rank's process group over a
set of axes (:meth:`MeshManager.group`), each built by
``torch.distributed.new_group`` on every rank in the same order, as gloo
requires: under hpZ / MiCS (``zshard`` above 1) the ``zshard`` group (where
ZeRO state is sharded) and the ``data`` group (its replicas); under an
``expert`` axis the ``expert`` group and, without hpZ, the ``(data,
zshard)`` group (the replicas of an expert shard, JAX's
``EXPERT_GRAD_REDUCE_AXES``, where ZeRO shards), with it the ``(data,
expert)`` group (the dense leaves' replica hop, JAX's ZeRO axes being
``zshard`` alone then); under a ``seq`` axis the ``(data, zshard)`` shard
group and the ``seq`` group, the dense leaves' replica hop (JAX's
``DENSE_GRAD_REDUCE_AXES`` less its ZeRO axes: seq ranks hold the same
parameters and ZeRO shards), and beside other axes the hops over
``(expert, seq)``, ``(data, seq)`` or ``(data, expert, seq)``: the dense
leaves' over ``DENSE_GRAD_REDUCE_AXES``, the expert leaves' over
``EXPERT_GRAD_REDUCE_AXES``, each less the shard axes. A group that spans
every process is the default group (None).

The MoE layer's collectives (the expert all-to-alls, the global aux loss's
mean, the dense gate's counts) run in the forward and backward on the
calling thread, while the engine's ``CommQueue`` worker may be running the
hooked gradient reduces on the engine's groups. gloo matches collectives by
issue order within a group, so the MoE layer has groups of its own
(:meth:`MeshManager.moe_group`), built with ``new_group`` even where they
span every process: the two threads never share a group. Its token group
(label ``batch``) is over the batch axes, and ``seq`` under a ``seq`` axis
(JAX's ``mean_axes``); its sum of the experts' ``mlp`` slices over
``tensor`` runs on the Megatron collectives' ``tensor`` group, on the same
calling thread. So do the
sequence-parallel attentions (Ulysses' all-to-alls, the ring's permutes):
:meth:`MeshManager.seq_group`, labelled ``seq``, and the Megatron
collectives of a ``tensor`` axis (the model's all-reduces and the serving
logits' gather, on the calling thread or autograd's):
:meth:`MeshManager.tensor`, labelled ``tensor``. The ``tensor`` axis is in
neither the batch axes nor the gradient-reduce axes, as in JAX: its ranks
share their rows and each holds its own slice of a tensor-parallel leaf,
so under it the shard group ``(data, zshard)`` is built even where it
holds one rank.

The ``pipe`` axis (P stages, ``parallel/pipeline.py``): a rank holds its
stage's layers, and its stage hops run on the pipeline's own group
(:meth:`MeshManager.pipe`, label ``pipe``): an activation to stage s + 1,
a cotangent to stage s − 1 (``comm.pipe_exchange``). ``pipe`` is in
neither the batch axes nor the gradient-reduce axes, as in JAX: the
stages of a data rank share its rows, so under it the shard group
``(data, zshard)`` is built even where it holds one rank. Every group
but the ``pipe`` group holds one stage's ranks (a group over axes keeps
this rank's coordinate on every other axis, ``pipe`` among them): the
shard group and hpZ's replica hops, the ``expert`` and ``seq`` groups, the
MoE layer's and the attentions' own, so two stages never meet on a group
(gloo matches collectives by issue order, and the stages run different
ticks).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from deepspeed_tpu_torch.runtime.config_utils import logger

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
ZSHARD_AXIS = "zshard"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"
DEFAULT_AXIS_ORDER: Tuple[str, ...] = (PIPE_AXIS, DATA_AXIS, ZSHARD_AXIS,
                                       EXPERT_AXIS, SEQ_AXIS, TENSOR_AXIS)
# dense gradients reduce over every axis that replicates dense parameters;
# expert parameters are sharded over 'expert', their gradients reduce over
# the axes that replicate them
DENSE_GRAD_REDUCE_AXES: Tuple[str, ...] = (DATA_AXIS, ZSHARD_AXIS,
                                           EXPERT_AXIS, SEQ_AXIS)
EXPERT_GRAD_REDUCE_AXES: Tuple[str, ...] = (DATA_AXIS, ZSHARD_AXIS, SEQ_AXIS)
# the axes that shard the token stream's batch (JAX ``batch_spec``)
BATCH_AXES: Tuple[str, ...] = (DATA_AXIS, ZSHARD_AXIS, EXPERT_AXIS)


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
                 groups: Optional[Dict[Tuple[int, ...], Any]] = None,
                 moe_groups: Optional[Dict[Tuple[int, ...], Any]] = None):
        self.shape = dict(sizes)
        self.rank = rank
        self._groups = dict(groups or {})
        self._moe_groups = dict(moe_groups or {})
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
        (``zshard`` and ``data`` under hpZ; ``expert`` and ``(data,
        zshard)`` under an expert axis, ``(data, expert)`` under both)."""
        ranks = self.group_ranks(axes)
        if len(ranks) == self.world_size:
            return None
        if ranks not in self._groups:
            raise ValueError(f"no process group over axes {tuple(axes)} "
                             f"(ranks {ranks}) in {self}")
        return self._groups[ranks]

    def moe_group(self, axes: Sequence[str], label: str):
        """The MoE layer's own process group over ``axes``: ``label``
        "batch" (the batch axes: the aux loss, the dense gate, the drop
        count) or "expert" (the all-to-alls), a group of its own even
        where it spans every process; None for this rank alone."""
        ranks = self.group_ranks(axes)
        if len(ranks) == 1:
            return None
        key = (label, ranks)
        if key not in self._moe_groups:
            raise ValueError(f"no MoE process group over axes {tuple(axes)} "
                             f"(ranks {ranks}) in {self}")
        return self._moe_groups[key]

    def axes_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.axis_size(a) for a in axes]))

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def world_size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def seq_group(self):
        """The sequence-parallel attentions' own process group over
        ``seq`` (label ``seq``), None for this rank alone."""
        return self.moe_group((SEQ_AXIS,), "seq")

    @property
    def dp_world_size(self) -> int:
        return int(np.prod([self.axis_size(a) for a in
                            (DATA_AXIS, ZSHARD_AXIS, EXPERT_AXIS, SEQ_AXIS)]))

    @property
    def batch_world_size(self) -> int:
        """Replicas of the model over the batch rows, ``data × zshard ×
        expert`` (JAX's engine's dp width): the ``seq`` ranks of a row
        share it, each holding its own positions."""
        return self.axes_size(BATCH_AXES)

    @property
    def batch_rank(self) -> int:
        """This rank's index over the batch axes: the rows it takes."""
        return self.group_ranks(BATCH_AXES).index(self.rank)

    @property
    def tp_world_size(self) -> int:
        return self.axis_size(TENSOR_AXIS)

    @property
    def tp_rank(self) -> int:
        """This rank's coordinate on the ``tensor`` axis."""
        return self.coords[TENSOR_AXIS]

    def tensor(self) -> Optional["TensorGroup"]:
        """This rank's place on the ``tensor`` axis for the Megatron
        collectives (their own group, label ``tensor``); None at tensor
        = 1."""
        if self.tp_world_size <= 1:
            return None
        return TensorGroup(self.moe_group((TENSOR_AXIS,), "tensor"),
                           self.tp_world_size, self.tp_rank)

    @property
    def pp_world_size(self) -> int:
        return self.axis_size(PIPE_AXIS)

    @property
    def stage(self) -> int:
        """This rank's pipeline stage: its coordinate on ``pipe``."""
        return self.coords[PIPE_AXIS]

    def pipe(self) -> Optional["PipeGroup"]:
        """This rank's place on the ``pipe`` axis for the stage hops and
        the pipeline's sums (their own group, label ``pipe``); None at
        pipe = 1."""
        if self.pp_world_size <= 1:
            return None
        return PipeGroup(self.moe_group((PIPE_AXIS,), "pipe"),
                         self.pp_world_size, self.stage,
                         self.group_ranks((PIPE_AXIS,)))

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


@dataclasses.dataclass(frozen=True)
class TensorGroup:
    """A rank's place on the ``tensor`` axis: the process group of the
    Megatron collectives, the axis size and the rank's coordinate (the
    slice of every tensor-parallel leaf it holds)."""
    group: Any
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class PipeGroup:
    """A rank's place on the ``pipe`` axis: the process group of the stage
    hops, the number of stages, the rank's stage and the global rank of
    every stage (its neighbours' among them)."""
    group: Any
    size: int
    stage: int
    ranks: Tuple[int, ...]


_GLOBAL_MESH: Optional[MeshManager] = None


def process_world_size() -> int:
    """Processes of the default process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


# the process groups built so far, by (kind, label, ranks): dist.new_group
# is collective, so every rank builds the same groups in the same order,
# once each; kind "axis" the engine's, "moe" the MoE layer's (whose batch
# and expert groups stay apart even over the same ranks)
_GROUPS: Dict[Tuple[str, str, Tuple[int, ...]], Any] = {}
_LABELS: List[Tuple[Any, str]] = []       # (group, its axes' label)


def _all_groups(sizes: Dict[str, int], axes: Sequence[str]
                ) -> List[Tuple[int, ...]]:
    """Every group over ``axes`` (the ranks sharing all other coordinates),
    in the order of their lowest rank."""
    world = int(np.prod(list(sizes.values())))
    out: List[Tuple[int, ...]] = []
    for r in range(world):
        ranks = MeshManager(sizes, r).group_ranks(axes)
        if ranks not in out:
            out.append(ranks)
    return out


def _build(kind: str, sizes: Dict[str, int], axes: Sequence[str],
           label: str, spanning: bool) -> Dict[Tuple[int, ...], Any]:
    """The groups of ``kind`` over ``axes`` (``spanning``: even one that
    holds every process; never a group of one rank for "moe")."""
    world = int(np.prod(list(sizes.values())))
    out = {}
    for ranks in _all_groups(sizes, axes):
        if (len(ranks) == world and not spanning) or (
                kind == "moe" and len(ranks) == 1):
            continue
        key = (kind, label, ranks)
        if key not in _GROUPS:
            _GROUPS[key] = dist.new_group(list(ranks))
            _LABELS.append((_GROUPS[key], label))
        out[(label, ranks) if kind == "moe" else ranks] = _GROUPS[key]
    return out


def _axis_groups(sizes: Dict[str, int]
                 ) -> Tuple[Dict[Tuple[int, ...], Any],
                            Dict[Tuple[int, ...], Any]]:
    """The engine's and the MoE layer's process groups of a mesh, built on
    this rank (each rank takes part in building all of them, in this
    order): under hpZ the ``zshard`` then the ``data`` groups; under an
    expert axis the ``expert`` groups, then the ``(data, zshard)`` groups
    (the shard group) without hpZ, or the ``(data, expert)`` groups (the
    dense leaves' replica hop, where ``data`` is above 1) with it; for the
    MoE layer, at more than one process, the batch group, and under an
    expert axis the ``expert`` groups and, where ``data`` × ``zshard`` is
    above 1, the batch group over ``expert`` (the int8 wire's manual step
    leaves only that batch axis to the layer). Under a ``seq`` axis: the
    ``(data, zshard)`` groups (the shard group) where ``data`` × ``zshard``
    is above 1 and short of the world, the ``seq`` groups (the dense
    replica hop, label ``seq_hop``), then the attentions' own ``seq``
    groups, and the replica hops of more than one axis beside ``seq``
    (labelled by their axes, ``expert_seq``, ``data_seq``,
    ``data_expert_seq``), and for the MoE layer the token group over the
    batch axes and ``seq``. Under a ``pipe`` axis: the ``(data, zshard)``
    groups even of one rank (the shard group, and the dense reduce group,
    which ``expert`` = ``seq`` = 1 make the same ranks), and the pipeline's own
    ``pipe`` groups; where an ``expert`` or ``seq`` axis makes the stage's
dense reduce group over ``DENSE_GRAD_REDUCE_AXES`` other ranks than those
groups, that group too (label ``dense``)."""
    world = int(np.prod(list(sizes.values())))
    groups: Dict[Tuple[int, ...], Any] = {}
    moe: Dict[Tuple[int, ...], Any] = {}
    if world <= 1:
        return groups, moe
    D, Z, X = sizes[DATA_AXIS], sizes[ZSHARD_AXIS], sizes[EXPERT_AXIS]
    Q, T, P = sizes[SEQ_AXIS], sizes[TENSOR_AXIS], sizes[PIPE_AXIS]
    if Z > 1:
        groups.update(_build("axis", sizes, (ZSHARD_AXIS,), "zshard", False))
        groups.update(_build("axis", sizes, (DATA_AXIS,), "data", False))
    if X > 1:
        groups.update(_build("axis", sizes, (EXPERT_AXIS,), "expert", False))
        if Z == 1:
            groups.update(_build("axis", sizes, (DATA_AXIS, ZSHARD_AXIS),
                                 "data", False))
        elif D > 1:
            groups.update(_build("axis", sizes, (DATA_AXIS, EXPERT_AXIS),
                                 "data_expert", False))
    if Q > 1:
        groups.update(_build("axis", sizes, (DATA_AXIS, ZSHARD_AXIS),
                             "data", False))
        groups.update(_build("axis", sizes, (SEQ_AXIS,), "seq_hop", False))
        # the replica hops beside seq: the dense leaves' over the batch
        # and seq axes off the shard axes, the expert leaves' over
        # EXPERT_GRAD_REDUCE_AXES off them (labels: the axes joined)
        shard = (ZSHARD_AXIS,) if Z > 1 else (DATA_AXIS, ZSHARD_AXIS)
        for reduce_axes in (DENSE_GRAD_REDUCE_AXES, EXPERT_GRAD_REDUCE_AXES):
            hop = tuple(a for a in reduce_axes
                        if a not in shard and sizes[a] > 1)
            if len(hop) > 1 and any(r not in groups for r in _all_groups(
                    sizes, hop)):
                groups.update(_build("axis", sizes, hop, "_".join(hop),
                                     False))
    if T > 1 or P > 1:
        groups.update(_build("axis", sizes, (DATA_AXIS, ZSHARD_AXIS),
                             "data", False))
    if P > 1 and any(r not in groups for r in _all_groups(
            sizes, DENSE_GRAD_REDUCE_AXES)):
        # a stage's dense reduce group where no group above holds its
        # ranks (an expert or seq axis beside data)
        groups.update(_build("axis", sizes, DENSE_GRAD_REDUCE_AXES, "dense",
                             False))
    moe.update(_build("moe", sizes, BATCH_AXES, "batch", True))
    if Q > 1:
        # the MoE layer's token group under seq: the batch axes and seq
        # (JAX's ``mean_axes``)
        moe.update(_build("moe", sizes, BATCH_AXES + (SEQ_AXIS,), "batch",
                          True))
        moe.update(_build("moe", sizes, (SEQ_AXIS,), "seq", True))
    if T > 1:
        moe.update(_build("moe", sizes, (TENSOR_AXIS,), "tensor", True))
    if P > 1:
        moe.update(_build("moe", sizes, (PIPE_AXIS,), "pipe", True))
    if X > 1:
        moe.update(_build("moe", sizes, (EXPERT_AXIS,), "expert", True))
        if D * Z > 1:
            # the batch axes left inside the int8 wire's manual step
            moe.update(_build("moe", sizes, (EXPERT_AXIS,), "batch", True))
    return groups, moe


def group_label(group) -> str:
    """``world`` for the default group (None), else the axes a group runs
    over (``zshard``, ``data``, ``expert``, ``data_expert``, ``seq_hop``
    for the engine's dense hop over ``seq``; ``batch`` for the MoE
    layer's group over the batch axes, ``seq`` for the attentions',
    ``tensor`` for the Megatron collectives', ``pipe`` for the stage hops
    and the pipeline's sums); ``other`` for a group of none."""
    if group is None:
        return "world"
    for g, label in _LABELS:
        if g is group:
            return label
    return "other"


_MANUAL: List[Tuple[str, ...]] = []


@contextlib.contextmanager
def manual_axes(axes: Sequence[str]):
    """Marks ``axes`` as already per rank while the block runs: the
    collective layers (the MoE layer) then treat the tokens and their
    statistics as local on those axes, as a layer traced inside JAX's
    manual ``shard_map`` does (the ZeRO++ int8 wire's step is manual over
    ``data`` and ``zshard``)."""
    _MANUAL.append(tuple(axes))
    try:
        yield
    finally:
        _MANUAL.pop()


def current_manual_axes() -> Tuple[str, ...]:
    return tuple(a for axes in _MANUAL for a in axes)


def initialize_mesh(mesh_config: Optional[MeshConfig] = None) -> MeshManager:
    """Resolve ``mesh_config`` over the process world and install it."""
    global _GLOBAL_MESH
    mesh_config = mesh_config or MeshConfig()
    sizes = mesh_config.resolve(process_world_size())
    rank = dist.get_rank() if process_world_size() > 1 else 0
    _GLOBAL_MESH = MeshManager(sizes, rank, *_axis_groups(sizes))
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
    _GROUPS.clear()
    _LABELS.clear()
