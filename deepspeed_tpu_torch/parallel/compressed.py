"""The ZeRO++ wire between processes: qwZ (int8 parameter all-gather), qgZ
(int8 gradient reduce-scatter) and LoCo (qgZ with error feedback).

Ports ``deepspeed_tpu/parallel/compressed.py`` at the ``data`` axis:
``sharded_dim`` (:404), ``_leaf_wire_plan`` (:264), ``_q_allgather`` (:67),
``_q_reduce_scatter`` (:84, with ``return_sent``), ``q_reduce_leaf``
(:281), ``loco_reduce_leaf`` (:209) and ``reduce_tree_bucketed`` (:322)
with ``bucket_elems=None``. The JAX functions run inside a ``shard_map``
over the mesh; these run in each process on its own tensors, and the
``group``'s collectives (``comm/comm.py``) carry the int8 blocks.

Per leaf, as in JAX: a leaf sharded on ``dim`` sends the rows
``moveaxis(g, dim, 0).reshape(world, -1)`` — row r is rank r's shard —
each zero-padded to a multiple of ``block``, so no quantization block
straddles two leaves or two ranks; a replicated leaf (``dim`` None) takes
an exact fp32 all-reduce mean. The engine packs every sharded leaf's
padded rows into one [world, Σ n_pad] buffer and calls
:func:`_q_reduce_scatter` on it once per micro-batch: the same blocks, one
quantize launch, one ``all_to_all`` each for q and the scales, one
dequant-reduce launch.

hpZ / MiCS (a ``zshard`` axis) and the bucketed, fenced sends belong to a
later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.mesh import ZSHARD_AXIS
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


def _leaf_wire_plan(spec, manual_axes: AxesT, axis_sizes: Dict[str, int]
                    ) -> Tuple[Optional[int], AxesT, int, AxesT]:
    """→ (sharded dim, reduce axes, their world, replica axes). At the
    ``data`` axis alone the reduce axes are all of ``manual_axes`` and there
    are no replica axes."""
    if axis_sizes.get(ZSHARD_AXIS, 1) > 1:
        raise later_slice("hpZ / MiCS subgroups (a 'zshard' axis)")
    dim = sharded_dim(spec, manual_axes)
    if dim is None:
        return None, manual_axes, 1, ()
    world = 1
    for a in manual_axes:
        world *= axis_sizes.get(a, 1)
    return dim, manual_axes, world, ()


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
                  quant_grads: bool = True, group=None) -> torch.Tensor:
    """One FULL gradient leaf → this rank's MEAN-reduced shard, in the
    leaf's layout and dtype: the int8 wire (``quant_grads``) or an exact
    fp32 reduce-scatter; a replicated leaf's exact all-reduce mean."""
    dim, _, gworld, _ = _leaf_wire_plan(spec, manual_axes, axis_sizes)
    if dim is None:
        return _replicated_mean(g, group, world).to(g.dtype)
    rows = torch.movedim(g, dim, 0).float().reshape(gworld, -1)
    if quant_grads:
        mine = _q_reduce_scatter(rows, group, gworld, block)
    else:
        mine = torch.empty(rows.shape[1], dtype=torch.float32,
                           device=g.device)
        comm.reduce_scatter_tensor(mine, rows.contiguous(), group=group)
    mine = mine / torch.tensor(float(world), device=g.device)
    return _unmove(mine, g.shape, dim, gworld).to(g.dtype)


def loco_reduce_leaf(g: torch.Tensor, err: torch.Tensor, spec,
                     manual_axes: AxesT, world: int,
                     axis_sizes: Dict[str, int], block: int = DEFAULT_BLOCK,
                     group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """LoCo for one leaf: send q(g + e), keep e' = (g + e) − deq(q(g + e)).
    ``g`` this rank's FULL gradient, ``err`` its residual (g's shape, in
    the moved layout's element order, as JAX keeps it). Returns (this
    rank's MEAN-reduced shard, new error); a replicated leaf reduces
    exactly and carries zero error."""
    dim, _, gworld, _ = _leaf_wire_plan(spec, manual_axes, axis_sizes)
    if dim is None:
        return (_replicated_mean(g, group, world).to(g.dtype),
                torch.zeros_like(err))
    rows = torch.movedim(g, dim, 0).float().reshape(gworld, -1)
    comp = rows + err.float().reshape(rows.shape)
    mine, sent = _q_reduce_scatter(comp, group, gworld, block,
                                   return_sent=True)
    new_err = (comp - sent).reshape(err.shape).to(err.dtype)
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
                         quant_grads: bool = True, group=None):
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
                                     world, axis_sizes, block, group)
            new_errs.append((path, e))
        else:
            gl = q_reduce_leaf(g, specs[path], manual_axes, world,
                               axis_sizes, block, quant_grads, group)
        grads.append((path, gl))
    return _unflatten(grads), (_unflatten(new_errs) if errs is not None
                               else None)
