"""The ZeRO++ wire between processes: qwZ (int8 parameter all-gather), qgZ
(int8 gradient reduce-scatter) and LoCo (qgZ with error feedback).

Ports ``deepspeed_tpu/parallel/compressed.py`` at the ``data`` and
``zshard`` axes: ``sharded_dim`` (:404), ``_leaf_wire_plan`` (:264),
``_q_allgather`` (:67), ``_q_reduce_scatter`` (:84, with ``return_sent``),
``_q_allreduce`` (:114), ``q_reduce_leaf`` (:281), ``loco_reduce_leaf``
(:209) and ``reduce_tree_bucketed`` (:322) with ``bucket_elems=None``; and
the parameter side: ``leaf_gather_axes`` (:415), ``leaf_gather_fn``
(:426), ``gather_tree_fn`` (:447), ``publish_gather_tree_fn`` (:468),
``chunked_gather_tree_fn`` (:501) and ``gather_with_compressed_vjp``
(:124, a ``torch.autograd.Function``: the exact or int8 all-gather of a
local shard forward, the exact or qgZ reduce of the full gradient
backward). The JAX functions run inside a ``shard_map`` over the mesh;
these run in each process on its own tensors, and the process group of
the named axes (``comm/mesh.MeshManager.group``) carries the int8
blocks.

Per leaf, as in JAX: a leaf sharded on ``dim`` over its gather axes (the
``zshard`` subgroup under hpZ / MiCS, else every axis) sends the rows
``moveaxis(g, dim, 0).reshape(gworld, -1)`` — row r is subgroup rank r's
shard — each zero-padded to a multiple of ``block``, so no quantization
block straddles two leaves or two ranks; a replicated leaf (``dim`` None)
takes an exact fp32 all-reduce mean over every axis. The gradient reduce
takes two hops under hpZ: a reduce-scatter over the subgroup that sums,
then a sum over the replica axes (``data``) of the rank's reduced shard —
int8 on the qgZ wire (:func:`_q_allreduce`: quantize, all-gather q and
the scales, one dequant-reduce over the replicas), exact under LoCo, whose
residual compensates the first hop only — and then ÷ the whole world.
The engine packs every sharded leaf's padded rows into one [gworld, Σ
n_pad] buffer and reduces it once per micro-batch: the same blocks, one
quantize launch, one ``all_to_all`` each for q and the scales, one
dequant-reduce launch, and under hpZ the replica hop's quantize, two
gathers and dequant-reduce.

The per-leaf gathers take a local shard in the leaf's own layout (JAX's
``shard_map`` view: ``shape[dim] / gworld`` at the sharded dim) and
quantize ``moveaxis(shard, dim, 0)`` flattened and padded to ``block``,
as JAX does; they gather over the subgroup only. The engines move whole
groups of leaves in one collective instead (``parallel/stage3.py``):
each leaf's piece padded to ``block`` in one packed row, which quantizes
the same blocks.

The bucketed, fenced sends belong to a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm import mesh as mesh_mod
from deepspeed_tpu_torch.ops.quantization import (
    DEFAULT_BLOCK,
    dequant_reduce,
    dequantize_int8,
    pad_to_block,
    quantize_int8,
)
from deepspeed_tpu_torch.runtime.config_utils import later_slice

AxesT = Tuple[str, ...]


def sharded_dim(spec, manual_axes: AxesT) -> Optional[int]:
    """Index of the dim sharded over any of ``manual_axes`` (None if none)."""
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        if any(n in manual_axes for n in names):
            return i
    return None


def _axes_world(axes: AxesT, axis_sizes: Dict[str, int]) -> int:
    world = 1
    for a in axes:
        world *= axis_sizes.get(a, 1)
    return world


def _group(axes: AxesT):
    """This rank's process group over ``axes`` (None: every process)."""
    return mesh_mod.get_mesh_manager().group(axes)


def _leaf_wire_plan(spec, manual_axes: AxesT, axis_sizes: Dict[str, int]
                    ) -> Tuple[Optional[int], AxesT, int, AxesT]:
    """→ (sharded dim, gather / reduce subgroup axes, the subgroup's
    world, replica axes). hpZ: a leaf sharded over the ``zshard``
    subgroup reduces over it and then hops the ``data`` replicas."""
    dim = sharded_dim(spec, manual_axes)
    if dim is None:
        return None, manual_axes, 1, ()
    gaxes = leaf_gather_axes(spec, dim, manual_axes)
    replica_axes = tuple(a for a in manual_axes if a not in gaxes)
    return dim, gaxes, _axes_world(gaxes, axis_sizes), replica_axes


def _q_allgather(flat: torch.Tensor, group, world: int,
                 block: int = DEFAULT_BLOCK,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8-wire all-gather of this rank's flat vector [n] → fp32
    [world, n]: quantize, gather q and the scales, dequantize (into
    ``out``, fp32 [world, n], when given and n is a block multiple)."""
    with telemetry.span("qwz_publish"):
        n = flat.shape[0]
        fp, _ = pad_to_block(flat.float(), block)
        q, s = quantize_int8(fp, block)
        qg = torch.empty((world,) + tuple(q.shape), dtype=q.dtype,
                         device=q.device)
        sg = torch.empty((world,) + tuple(s.shape), dtype=s.dtype,
                         device=s.device)
        comm.all_gather_into_tensor(qg, q, group)
        comm.all_gather_into_tensor(sg, s, group)
        if out is not None and fp.shape[0] == n:
            return dequant_reduce(qg.view(1, -1), sg.view(1, -1), block,
                                  out=out.view(-1)).view(world, n)
        rows = dequantize_int8(qg.reshape(-1), sg.reshape(-1), block)
        return rows.view(world, -1)[:, :n]


def _q_reduce_scatter(rows: torch.Tensor, group, world: int,
                      block: int = DEFAULT_BLOCK, return_sent: bool = False,
                      mean: bool = False,
                      sent_out: Optional[torch.Tensor] = None):
    """int8-wire reduce-scatter: rows [world, n] (row r → rank r) → this
    rank's reduced row [n] (the sum; ÷ world when ``mean``, the same bits
    as dividing the sum afterwards). ``return_sent`` also returns the
    dequantized send rows [world, n] — what the wire carried, for LoCo —
    written into ``sent_out`` (fp32 [world, n]) when given."""
    n = rows.shape[1]
    rp = rows.float()
    if n % block:
        rp = torch.nn.functional.pad(rp, (0, (-n) % block))
    n_pad = rp.shape[1]
    with telemetry.span("qgz_quantize"):
        q, s = quantize_int8(rp.reshape(-1), block)
    sent = None
    if return_sent:
        with telemetry.span("qgz_sent"):
            if sent_out is not None and n == n_pad:
                sent = dequant_reduce(q.view(1, -1), s.view(1, -1), block,
                                      out=sent_out.view(-1)).view(world, n)
            else:
                sent = dequantize_int8(q, s, block).view(world, n_pad)[:, :n]
    with telemetry.span("qgz_all_to_all"):
        qr = comm.all_to_all_single(q.view(world, n_pad), group)
        sr = comm.all_to_all_single(s.view(world, n_pad // block), group)
    with telemetry.span("qgz_dequant_reduce"):
        mine = dequant_reduce(qr, sr, block, mean=mean)[:n]
    if return_sent:
        return mine, sent
    return mine


def _q_allreduce(flat: torch.Tensor, group, world: int,
                 block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """int8-wire all-reduce (the sum) of this rank's flat vector [n] over
    ``group`` (``world`` ranks): quantize, all-gather q and the scales, one
    dequant-reduce over the ``world`` rows. hpZ's replica hop: the replica
    axes the leaf is not sharded over still contribute gradients."""
    with telemetry.span("qgz_replica"):
        n = flat.shape[0]
        fp, _ = pad_to_block(flat.float(), block)
        q, s = quantize_int8(fp, block)
        qg = torch.empty((world,) + tuple(q.shape), dtype=q.dtype,
                         device=q.device)
        sg = torch.empty((world,) + tuple(s.shape), dtype=s.dtype,
                         device=s.device)
        comm.all_gather_into_tensor(qg, q, group)
        comm.all_gather_into_tensor(sg, s, group)
        return dequant_reduce(qg, sg, block)[:n]


def replica_sum(mine: torch.Tensor, group, world: int, quant: bool,
                block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """hpZ's second hop: this rank's reduced shard [n] (fp32) summed over
    the replicas — the int8 wire (:func:`_q_allreduce`) or an exact
    all-reduce (into ``mine``)."""
    if quant:
        return _q_allreduce(mine, group, world, block)
    return comm.all_reduce(mine, group=group)


def _unmove(mine: torch.Tensor, shape: Sequence[int], dim: int,
            world: int) -> torch.Tensor:
    """A reduced row [n_loc] in the moved layout → the leaf's shard."""
    m_shape = (shape[dim] // world,) + tuple(
        s for i, s in enumerate(shape) if i != dim)
    return torch.movedim(mine.reshape(m_shape), 0, dim)


def _replicated_mean(g: torch.Tensor, group, world: int) -> torch.Tensor:
    red = comm.all_reduce(g.float().clone(), group=group)
    return red / torch.tensor(float(world), device=g.device)


def q_reduce_leaf(g: torch.Tensor, spec, manual_axes: AxesT, world: int,
                  axis_sizes: Dict[str, int], block: int = DEFAULT_BLOCK,
                  quant_grads: bool = True) -> torch.Tensor:
    """One FULL gradient leaf → this rank's MEAN-reduced shard, in the
    leaf's layout and dtype: the int8 wire (``quant_grads``) or an exact
    fp32 reduce-scatter over the leaf's subgroup, then (hpZ) the matching
    replica hop, then ÷ ``world``; a replicated leaf's exact all-reduce
    mean."""
    dim, gaxes, gworld, replica = _leaf_wire_plan(spec, manual_axes,
                                                  axis_sizes)
    if dim is None:
        return _replicated_mean(g, _group(manual_axes), world).to(g.dtype)
    rows = torch.movedim(g, dim, 0).float().reshape(gworld, -1)
    mine = reduce_rows(rows, _group(gaxes), gworld, quant_grads, block)
    if replica:
        mine = replica_sum(mine, _group(replica), world // gworld,
                           quant_grads, block)
    mine = mine / torch.tensor(float(world), device=g.device)
    return _unmove(mine, g.shape, dim, gworld).to(g.dtype)


def loco_reduce_leaf(g: torch.Tensor, err: torch.Tensor, spec,
                     manual_axes: AxesT, world: int,
                     axis_sizes: Dict[str, int], block: int = DEFAULT_BLOCK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LoCo for one leaf: send q(g + e), keep e' = (g + e) − deq(q(g + e)).
    ``g`` this rank's FULL gradient, ``err`` its residual (g's shape, in
    the moved layout's element order, as JAX keeps it). Returns (this
    rank's MEAN-reduced shard, new error); a replicated leaf reduces
    exactly and carries zero error. Under hpZ the residual belongs to the
    subgroup hop; the replica hop is an exact all-reduce (one residual
    compensates one quantizer)."""
    dim, gaxes, gworld, replica = _leaf_wire_plan(spec, manual_axes,
                                                  axis_sizes)
    if dim is None:
        return (_replicated_mean(g, _group(manual_axes), world).to(g.dtype),
                torch.zeros_like(err))
    rows = torch.movedim(g, dim, 0).float().reshape(gworld, -1)
    comp = rows + err.float().reshape(rows.shape)
    mine, sent = _q_reduce_scatter(comp, _group(gaxes), gworld, block,
                                   return_sent=True)
    new_err = (comp - sent).reshape(err.shape).to(err.dtype)
    if replica:
        mine = replica_sum(mine, _group(replica), world // gworld, False)
    mine = mine / torch.tensor(float(world), device=g.device)
    return _unmove(mine, g.shape, dim, gworld).to(g.dtype), new_err


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _unflatten(items):
    out: Dict[str, Any] = {}
    for path, v in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def reduce_tree_bucketed(gfull_tree, spec_tree, manual_axes: AxesT,
                         world: int, axis_sizes: Dict[str, int],
                         bucket_elems: Optional[int] = None,
                         err_tree=None, block: int = DEFAULT_BLOCK,
                         quant_grads: bool = True):
    """Every leaf of the full-gradient tree through :func:`q_reduce_leaf`,
    or :func:`loco_reduce_leaf` when ``err_tree`` is given. Returns
    ``(shard_grads, new_err)`` (``new_err`` None without LoCo).
    ``bucket_elems`` (fenced, size-bounded buckets) is a later slice."""
    if bucket_elems:
        raise later_slice("bucketed wire sends (bucket_elems)")
    specs = dict(_flatten(spec_tree))
    errs = dict(_flatten(err_tree)) if err_tree is not None else None
    grads, new_errs = [], []
    for path, g in _flatten(gfull_tree):
        if errs is not None:
            gl, e = loco_reduce_leaf(g, errs[path], specs[path], manual_axes,
                                     world, axis_sizes, block)
            new_errs.append((path, e))
        else:
            gl = q_reduce_leaf(g, specs[path], manual_axes, world,
                               axis_sizes, block, quant_grads)
        grads.append((path, gl))
    return _unflatten(grads), (_unflatten(new_errs) if errs is not None
                               else None)


# --------------------------------------------------------------------------- #
# the parameter side: per-use gathers with the compressed VJP
# --------------------------------------------------------------------------- #

def gather_rows(flat: torch.Tensor, group, world: int, out_dtype,
                quant: bool, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Every rank's flat vector [n] → [world, n]: the int8 wire
    (:func:`_q_allgather`, fp32 rows) or an exact gather in ``out_dtype``."""
    if quant:
        return _q_allgather(flat, group, world, block)
    rows = torch.empty(world, flat.shape[0], dtype=out_dtype,
                       device=flat.device)
    comm.all_gather_into_tensor(rows, flat.to(out_dtype), group)
    return rows


def reduce_rows(rows: torch.Tensor, group, world: int, quant: bool,
                block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """fp32 rows [world, n] (row r → rank r) → this rank's summed row [n]:
    the qgZ wire or an exact reduce-scatter."""
    if quant:
        return _q_reduce_scatter(rows, group, world, block)
    mine = torch.empty(rows.shape[1], dtype=torch.float32, device=rows.device)
    comm.reduce_scatter_tensor(mine, rows.contiguous(), group=group)
    return mine


@dataclasses.dataclass(frozen=True)
class _LeafWire:
    """One leaf's gather and its gradient's reduce (JAX's closure over
    ``gather_with_compressed_vjp``'s arguments), with the process groups
    of its axes: ``group`` the gather subgroup's, ``mean_group`` every
    axis's (a replicated leaf's mean), ``replica_group`` the replica
    axes' (hpZ's second hop, when ``replicas``)."""
    dim: Optional[int]
    world: int                 # the mean's divisor: every reduce axis
    gather_world: int          # the ranks the shard is gathered over
    out_dtype: torch.dtype
    quant_weights: bool
    quant_grads: bool
    block: int
    group: Any
    mean_group: Any
    replicas: bool
    replica_group: Any

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if self.dim is None:
            return x.to(self.out_dtype)
        m = torch.movedim(x, self.dim, 0)
        rows = gather_rows(m.reshape(-1), self.group, self.gather_world,
                           self.out_dtype, self.quant_weights, self.block)
        full = rows.reshape((self.gather_world * m.shape[0],)
                            + tuple(m.shape[1:]))
        return torch.movedim(full, 0, self.dim).to(self.out_dtype)

    def reduce(self, g: torch.Tensor, local_shape, in_dtype) -> torch.Tensor:
        if self.dim is None:
            return _replicated_mean(g, self.mean_group,
                                    self.world).to(in_dtype)
        rows = torch.movedim(g, self.dim, 0).reshape(
            self.gather_world, -1).float()
        mine = reduce_rows(rows, self.group, self.gather_world,
                           self.quant_grads, self.block)
        if self.replicas:
            mine = replica_sum(mine, self.replica_group,
                               self.world // self.gather_world,
                               self.quant_grads, self.block)
        mine = mine / torch.tensor(float(self.world), device=g.device)
        return _unmove(mine, local_shape, self.dim, 1).to(in_dtype)


class _GatherWithCompressedVJP(torch.autograd.Function):
    """Forward: local shard → full parameter (out dtype). Backward: full
    gradient → this rank's shard of the MEAN-reduced gradient, in the
    shard's dtype. Saves no tensor, so the gathered parameter lives only as
    long as its users keep it."""

    @staticmethod
    def forward(ctx, x_local, wire: _LeafWire):
        ctx.wire = wire
        ctx.local_shape = tuple(x_local.shape)
        ctx.in_dtype = x_local.dtype
        with torch.no_grad():
            return wire.gather(x_local)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            return ctx.wire.reduce(g, ctx.local_shape, ctx.in_dtype), None


def gather_with_compressed_vjp(dim: Optional[int], axes: AxesT, world: int,
                               out_dtype, quant_weights: bool,
                               quant_grads: bool,
                               block: int = DEFAULT_BLOCK,
                               gather_axes: Optional[AxesT] = None,
                               gather_world: Optional[int] = None
                               ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The straight-through gather of one parameter leaf sharded on
    ``dim`` (None: replicated — a cast forward, an exact all-reduce mean
    over ``axes`` backward). Forward: the exact or int8
    (``quant_weights``) all-gather over ``gather_axes``; backward: the
    exact or qgZ (``quant_grads``) reduce-scatter over them, then, for
    the axes of ``axes`` outside ``gather_axes`` (hpZ's replicas), the
    matching all-reduce of the shard, divided by ``world`` (every axis of
    ``axes``)."""
    gather_axes = tuple(gather_axes) if gather_axes is not None else axes
    replica_axes = tuple(a for a in axes if a not in gather_axes)
    wire = _LeafWire(dim, world,
                     gather_world if gather_world is not None else world,
                     out_dtype, quant_weights, quant_grads, block,
                     _group(gather_axes), _group(axes), bool(replica_axes),
                     _group(replica_axes) if replica_axes else None)
    return lambda x: _GatherWithCompressedVJP.apply(x, wire)


def leaf_gather_axes(spec, dim: Optional[int], manual_axes: AxesT) -> AxesT:
    """The manual axes the leaf's ``dim`` is sharded over."""
    if dim is None:
        return manual_axes
    entry = spec[dim]
    names = entry if isinstance(entry, tuple) else (entry,)
    return tuple(a for a in manual_axes if a in names)


def leaf_gather_fn(spec, manual_axes: AxesT, world: int, out_dtype,
                   quant_weights: bool, quant_grads: bool,
                   block: int = DEFAULT_BLOCK,
                   axis_sizes: Optional[Dict[str, int]] = None):
    """The gather of one leaf of ``spec``: over the axes its dim is sharded
    on (``axis_sizes`` given: the ``zshard`` subgroup under hpZ), else
    over all ``manual_axes``."""
    dim = sharded_dim(spec, manual_axes)
    if axis_sizes is not None and dim is not None:
        gaxes = leaf_gather_axes(spec, dim, manual_axes)
        gworld = _axes_world(gaxes, axis_sizes)
    else:
        gaxes, gworld = manual_axes, world
    return gather_with_compressed_vjp(
        dim, manual_axes, world, out_dtype, quant_weights, quant_grads,
        block, gather_axes=gaxes, gather_world=gworld)


def _map_specs(fn, spec_tree):
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v) for k, v in spec_tree.items()}
    return fn(spec_tree)


def _apply(fns, tree):
    if isinstance(fns, dict):
        return {k: _apply(fns[k], tree[k]) for k in fns}
    return fns(tree)


def gather_tree_fn(spec_tree, manual_axes: AxesT, world: int, out_dtype,
                   quant_weights: bool, quant_grads: bool,
                   block: int = DEFAULT_BLOCK,
                   axis_sizes: Optional[Dict[str, int]] = None):
    """Local master shards (a tree) → full compute parameters, each leaf
    through :func:`leaf_gather_fn` (so with the compressed VJP)."""
    gathers = _map_specs(lambda spec: leaf_gather_fn(
        spec, manual_axes, world, out_dtype, quant_weights, quant_grads,
        block, axis_sizes), spec_tree)
    return lambda master_local: _apply(gathers, master_local)


def chunked_gather_tree_fn(spec_tree, manual_axes: AxesT, world: int,
                           out_dtype, quant_weights: bool,
                           chunk_bounds: Sequence[Tuple[int, int]],
                           block: int = DEFAULT_BLOCK,
                           axis_sizes: Optional[Dict[str, int]] = None,
                           blocks_key: str = "blocks"):
    """The gather over the layer-chunk plan: first a head group (every
    non-``blocks`` leaf, and a ``blocks`` leaf sharded ON the stacking dim
    0, whose slices would tear the shard layout) whole, then each chunk
    ``[start, stop)`` of every other ``blocks`` leaf, quantized on its own
    (``moveaxis(shard[start:stop], dim, 0)``). The chunks are concatenated
    back, so the result is :func:`gather_tree_fn`'s tree; with one chunk
    it IS that function. Built for gradients reduced outside the gather
    (``reduce_tree_bucketed``): its backward reduces exactly."""
    bounds = [tuple(b) for b in (chunk_bounds or [])]
    plain = gather_tree_fn(spec_tree, manual_axes, world, out_dtype,
                           quant_weights, False, block, axis_sizes)
    if len(bounds) <= 1 or not isinstance(spec_tree, dict) \
            or blocks_key not in spec_tree:
        return plain
    one = lambda spec: leaf_gather_fn(                     # noqa: E731
        spec, manual_axes, world, out_dtype, quant_weights, False, block,
        axis_sizes)
    head = {k: _map_specs(one, v) for k, v in spec_tree.items()
            if k != blocks_key}
    blk_specs = dict(_flatten(spec_tree[blocks_key]))

    def gather_tree(master_local):
        out = {k: _apply(head[k], master_local[k]) for k in head}
        vals = dict(_flatten(master_local[blocks_key]))
        whole = {p for p, spec in blk_specs.items()
                 if sharded_dim(spec, manual_axes) == 0}
        blk = {p: one(blk_specs[p])(vals[p]) for p in sorted(whole)}
        parts: Dict[Tuple[str, ...], list] = {p: [] for p in blk_specs
                                              if p not in whole}
        for start, stop in bounds:
            for p in sorted(parts):
                parts[p].append(one(blk_specs[p])(vals[p][start:stop]))
        blk.update({p: torch.cat(v, dim=0) for p, v in parts.items()})
        out[blocks_key] = _unflatten(sorted(blk.items()))
        return out

    return gather_tree


def publish_gather_tree_fn(spec_tree, manual_axes: AxesT, world: int,
                           out_dtype, quant_weights: bool,
                           chunk_bounds: Optional[Sequence[Tuple[int, int]]]
                           = None, block: int = DEFAULT_BLOCK,
                           axis_sizes: Optional[Dict[str, int]] = None):
    """The post-update publish of the compute parameters: the same gather
    the forward would run on the same master (chunked when the plan has
    more than one chunk), so its values are what an in-step gather gives.
    That is why ZeRO-3 keeps no published buffer: it gathers per use."""
    bounds = [tuple(b) for b in (chunk_bounds or [])]
    if len(bounds) > 1:
        inner = chunked_gather_tree_fn(spec_tree, manual_axes, world,
                                       out_dtype, quant_weights, bounds,
                                       block, axis_sizes)
    else:
        inner = gather_tree_fn(spec_tree, manual_axes, world, out_dtype,
                               quant_weights, False, block, axis_sizes)

    def publish(master_local):
        with telemetry.span("zero_publish"), torch.no_grad():
            return inner(master_local)

    return publish
