"""ZeRO-3 over ``data`` (and hpZ's ``zshard``): parameters sharded,
gathered chunk by chunk.

Stands for, in JAX:

* ``ShardingPolicy.param_spec`` at stage 3 (``parallel/partitioning.py:127``)
  and GSPMD's per-use gathers: JAX's compute parameters carry the ZeRO spec,
  and XLA gathers each one where the forward, or the backward's
  rematerialised forward, uses it, and reduce-scatters its gradient;
* the overlap scheduler's layer chunks (``runtime/engine.py:777-800``,
  ``parallel/overlap.py:135 chunk_layers``): one gather a chunk, the next
  chunk's gather in flight while the current one computes;
* on the int8 wire, ``parallel/compressed.py:501 chunked_gather_tree_fn``:
  a head group, then every chunk, each leaf's piece quantized on its own.

:func:`gather_groups` cuts the leaves into those groups: the head group
(every leaf outside ``blocks``, and a ``blocks`` leaf sharded on its
stacking dim 0, gathered whole) and one group a chunk ``[start, stop)``
of the other ``blocks`` leaves. A group moves in ONE collective: each
sharded leaf's piece (``moveaxis(shard[start:stop], dim, 0)`` flattened,
which is the rank's moved-layout row ``[:, start:stop]``) padded to the
quantization block in one packed row, so the int8 wire quantizes the
blocks JAX quantizes per leaf. The stage-2 qwZ publish takes the same
groups (``runtime/engine.py`` ``DataParallelEngine._compute_params``).

:class:`Stage3Params` is the parameter coordinator, handed to the model as
its parameters (``models/transformer.ParamHook``). Per micro-batch:

* forward: the head group at the start; chunk c when its first layer
  runs, chunk c + 1's gather submitted then (``overlap_comm``); a chunk's
  parameters dropped after its last layer;
* backward (remat full): chunk c gathered again when its last layer's
  recompute starts (the last chunk's gather submitted as the forward
  ends), chunk c - 1's submitted then, dropped after its first layer's
  recompute; autograd frees them when that layer's backward is done;
* gradients: a chunk's gather is one ``torch.autograd.Function`` whose
  outputs are its layers' parameters; its backward runs once the chunk's
  backward is done. Exact wire: the chunk's gradient (compute dtype,
  fp32 on the wire) reduce-scattered through the queue, the mean shard
  added to the fp32 accumulator when it lands (the same sum as ZeRO-2's
  once-a-step reduce, in another order). qgZ / LoCo: the gradient is
  written into the engine's transient full gradient, which the engine
  reduces leaf by leaf once per micro-batch, as JAX's wire step does (a
  per-chunk qgZ would quantize other blocks). Replicated leaves add into
  the engine's replicated buffer, all-reduced once a step.

A spec whose loss does not take the hook (anything but
``causal_lm_spec``'s) gets its whole tree from :meth:`Stage3Params.tree`:
one group, gathered each forward (autograd keeps it for the backward),
its gradient reduced when the backward is done. Under the streaming
``offload_param`` tier the fp32 exact wire packs each group straight from
the master in pinned host memory (:func:`pack`: the group's host-to-device
copy).

Every collective goes through one ``comm.CommQueue``, in the same order on
every rank; the engine drains it before any collective of its own.
Nothing keeps a gathered chunk alive but its users: the gather Function
saves no tensor, and the coordinator's cache holds a chunk only between
its first and last layer of one pass. Without remat the forward's chunks
stay alive in autograd until the backward (correct, but no memory saved).

hpZ / MiCS: the shards live on the engine's ``zshard`` group (Z ranks),
so every gather runs there, with rows ``[Z, n_row]``, and never on the
``data`` group; the exact wire's per-chunk reduce takes both hops in one
queued op (the reduce-scatter over ``zshard``, then the all-reduce of the
rank's piece over ``data``), then ÷ the whole world.

Under an ``expert`` axis a group's expert pieces (this rank's E/X experts
of each expert leaf) come after its dense ones, from ``n_dense`` on: they
are gathered over the shard group with the dense ones, by the same
chunks, and a reduce's second hop runs in two parts (the dense part over
the engine's dense replica group, the expert part over its expert
leaves' replica group, ``engine.hops``). The int8 wire quantizes the
expert pieces in JAX's blocks (:class:`ExpertRows`).

Under a ``pipe`` axis (JAX gathers per use under GSPMD there, its
``can_chunk`` false) the groups are the stage's: the head group (the
extras: the embedding, the final norm, the head) and the chunks of the
stage's L/P layers, gathered over the shard group inside the stage. A
pipeline schedule uses the layers once a pass — 1F1B's no-grad forward,
each VJP's forward and its backward's recompute, GPipe's ticks — and marks
each pass (:meth:`Stage3Params.begin_forward` / ``begin_backward``): a
chunk is gathered when a pass first asks for one of its layers and dropped
after the pass has taken each of them once (no prefetch: a pass's order
of layers is the schedule's), and whatever a pass left (a recompute that
stopped early) goes at the next mark. Each chunk's gradient is reduced
when a pass's backward is done with it, ÷ ``grad_div`` (1F1B's M: its
VJPs are seeded per micro-batch). The head group is gathered once a
schedule; GPipe's autograd reduces its gradient (summed over ``pipe``
first) through the gather, 1F1B hands the schedule's sums to
:meth:`Stage3Params.reduce_head`.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models.transformer import ParamHook
from deepspeed_tpu_torch.ops.quant_kernels import DEFAULT_BLOCK
from deepspeed_tpu_torch.parallel import compressed as C

BLOCKS = "blocks"      # top-level key whose leaves stack the layers


def _pad(n: int) -> int:
    return -(-n // DEFAULT_BLOCK) * DEFAULT_BLOCK


@dataclasses.dataclass(frozen=True)
class Piece:
    """One leaf's part of a group: the layers ``[start, stop)`` of a
    ``blocks`` leaf, or the whole leaf (``layers`` None); ``n`` elements a
    rank sends at ``offset`` of the packed row (0: replicated, no wire)."""
    shard: Any                           # runtime.engine._Shard
    layers: Optional[Tuple[int, int]]
    offset: int
    n: int

    @property
    def path(self) -> Tuple[str, ...]:
        return self.shard.slot.path

    def shape(self) -> Tuple[int, ...]:
        """The piece's full value, in the leaf's own layout."""
        shape = self.shard.slot.shape
        if self.layers is None:
            return tuple(shape)
        return (self.layers[1] - self.layers[0],) + tuple(shape[1:])

    def moved(self, world: int) -> Tuple[int, ...]:
        """[world, shape[dim] / world, the other dims]."""
        shape, dim = self.shape(), self.shard.dim
        return (world, shape[dim] // world) + tuple(
            s for i, s in enumerate(shape) if i != dim)


@dataclasses.dataclass(frozen=True)
class Group:
    pieces: Tuple[Piece, ...]
    n_row: int                           # the packed row, block multiple
    layers: Optional[Tuple[int, int]]    # a chunk's layers; None: head
    identity: bool                       # the row IS the local shard
    n_dense: int                         # the dense pieces' part of the
    #                                      row (the expert pieces after)


def make_group(items, layers=None, expert=frozenset()) -> Group:
    """A group of ``(shard, layers or None)`` items, each piece padded to
    the quantization block in the packed row; the pieces of the leaves in
    ``expert`` (paths) after the others, from ``n_dense`` on."""
    items = sorted(items, key=lambda it: it[0].slot.path in expert)
    pieces, off, n_dense = [], 0, None
    for sh, lay in items:
        if n_dense is None and sh.slot.path in expert:
            n_dense = off
        if sh.dim is None:
            n = 0
        elif lay is None:
            n = sh.n_loc
        else:
            n = sh.n_loc // sh.slot.shape[0] * (lay[1] - lay[0])
        pieces.append(Piece(sh, lay, off, n))
        off += _pad(n)
    identity = layers is None and all(
        p.n == 0 or (p.layers is None and p.offset == p.shard.offset)
        for p in pieces)
    return Group(tuple(pieces), off, layers, identity,
                 off if n_dense is None else n_dense)


def chunked_shards(shards) -> List[Any]:
    """The leaves a layer chunk takes: the ``blocks`` leaves not sharded on
    their stacking dim 0 (the rest are the head group's)."""
    return [sh for sh in shards if sh.slot.path[0] == BLOCKS and sh.dim != 0]


def gather_groups(shards, chunk_bounds, expert=frozenset()) -> List[Group]:
    """No bounds: one group, every leaf whole (its packed row is the
    sharded region of the local buffer, whose expert leaves lie after the
    dense ones too). Bounds: the head group, then one group a chunk. Each
    group's expert pieces (``expert``: their paths) after its dense
    ones."""
    bounds = [tuple(b) for b in chunk_bounds]
    if not bounds:
        return [make_group([(sh, None) for sh in shards], expert=expert)]
    chunked = chunked_shards(shards)
    head = [(sh, None) for sh in shards
            if not any(sh is c for c in chunked)]
    return [make_group(head, expert=expert)] + [
        make_group([(sh, b) for sh in chunked], b, expert)
        for b in bounds]


class ExpertRows:
    """The int8 wire's blocks of a packed row's expert pieces under an
    ``expert`` axis of X ranks. JAX's int8 step is manual over ``data``
    and ``zshard`` only, so it quantizes an expert leaf's piece with every
    expert in it (``moveaxis(shard, dim, 0)`` of the leaf whose ``expert``
    dim is whole), in blocks that span experts held on other ranks. A
    rank holds its E/X experts: before quantizing, the expert pieces
    ``[n_dense, n_row)`` of a row (each padded to the block) are
    all-gathered over the expert group and laid out as JAX's (each piece
    with every expert, padded to the block: :meth:`to_global`); after
    the wire, this rank's experts are taken back (:meth:`to_local`). The
    dense pieces never leave the row.

    ``src[j]``: where global position j comes from in the gathered
    ``[X · n_local]`` (expert-coordinate major), ``X · n_local`` (a zero)
    for a pad; ``own[i]``: where local position i lies in the global
    part, ``n_global`` (a zero) for a pad."""

    def __init__(self, group: Group, expert_dims: Dict[Tuple[str, ...], int],
                 world: int, X: int, x: int, device):
        self.n_dense, self.X = group.n_dense, X
        self.n_local = group.n_row - group.n_dense
        #: each expert piece's (offset, length) in the global part
        self.spans: Dict[Tuple[str, ...], Tuple[int, int]] = {}
        src, own, g_off = [], [], 0
        for p in group.pieces:
            if not p.n or p.path not in expert_dims:
                continue
            lo = p.offset - group.n_dense
            local = p.moved(world)[1:]
            edim, dim = expert_dims[p.path], p.shard.dim
            ax = edim if edim < dim else edim - 1
            glob = list(local)
            glob[1 + ax] *= X
            # each expert coordinate's elements in the global piece
            pos = torch.arange(p.n * X).view(glob).split(local[1 + ax],
                                                          dim=1 + ax)
            n_pad = _pad(p.n * X)
            piece_src = torch.full((n_pad,), X * self.n_local,
                                   dtype=torch.long)
            for xx in range(X):
                piece_src[pos[xx].reshape(-1)] = (xx * self.n_local + lo
                                                  + torch.arange(p.n))
            src.append(piece_src)
            own.append((lo, g_off + pos[x].reshape(-1)))
            self.spans[p.path] = (g_off, p.n * X)
            g_off += n_pad
        self.n_global = g_off
        self.src = (torch.cat(src) if src
                    else torch.zeros(0, dtype=torch.long)).to(device)
        own_idx = torch.full((self.n_local,), g_off, dtype=torch.long)
        for lo, positions in own:
            own_idx[lo:lo + positions.numel()] = positions
        self.own = own_idx.to(device)

    def to_global(self, rows: torch.Tensor, group) -> torch.Tensor:
        """A row's expert part ``[..., n_local]`` (this rank's experts) →
        ``[..., n_global]``, every expert of the expert group (``group``)
        in JAX's layout (an all-gather over it)."""
        lead = tuple(rows.shape[:-1])
        gathered = comm.all_gather(rows.contiguous(), group, tiled=False)
        flat = torch.movedim(gathered, 0, -2).reshape(
            lead + (self.X * self.n_local,))
        flat = torch.nn.functional.pad(flat, (0, 1))
        return flat.index_select(-1, self.src)

    def to_local(self, rows: torch.Tensor) -> torch.Tensor:
        """``[..., n_global]`` → this rank's experts ``[..., n_local]``
        (its pads zero)."""
        return torch.nn.functional.pad(rows, (0, 1)).index_select(
            -1, self.own)


def to_wire(engine, group: Group, row: torch.Tensor) -> torch.Tensor:
    """A packed row [..., n_row] as the int8 wire quantizes it: unchanged
    without an expert axis, else its expert pieces in JAX's layout
    (:class:`ExpertRows`)."""
    ex = engine.expert_rows(group)
    if ex is None:
        return row
    return torch.cat([row[..., :ex.n_dense],
                      ex.to_global(row[..., ex.n_dense:],
                                   engine.expert_group)], dim=-1)


def from_wire(engine, group: Group, rows: torch.Tensor) -> torch.Tensor:
    """Rows [..., n_wire] in the wire's layout → [..., n_row] (this
    rank's experts)."""
    ex = engine.expert_rows(group)
    if ex is None:
        return rows
    return torch.cat([rows[..., :ex.n_dense],
                      ex.to_local(rows[..., ex.n_dense:])], dim=-1)


def pack(group: Group, engine, src: torch.Tensor,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The rank's packed row of ``group`` from a local buffer (its pads
    zero, so they quantize as JAX's padding does), on the engine's device
    in ``dtype`` (default ``src``'s): from a master in pinned host memory
    (the streaming ``offload_param`` tier) this is the group's
    host-to-device copy."""
    dtype = src.dtype if dtype is None else dtype
    if group.identity:
        row = src[:group.n_row]
        if row.device == engine.device and row.dtype == dtype:
            return row
        return row.to(engine.device, dtype, non_blocking=True)
    out = torch.zeros(group.n_row, dtype=dtype, device=engine.device)
    for p in group.pieces:
        if not p.n:
            continue
        loc = engine._local(src, p.shard)
        if p.layers is not None:
            loc = loc[:, p.layers[0]:p.layers[1]]
        out[p.offset:p.offset + p.n].view(loc.shape).copy_(loc)
    return out


def unpack(group: Group, rows: torch.Tensor, world: int, dst) -> None:
    """Gathered rows [world, n_row] → each sharded piece's full value,
    copied into ``dst(piece)`` (the leaf's layout; cast on copy)."""
    for p in group.pieces:
        if not p.n:
            continue
        moved = p.moved(world)
        full = rows[:, p.offset:p.offset + p.n].reshape(
            (moved[0] * moved[1],) + moved[2:])
        dst(p).copy_(torch.movedim(full, 0, p.shard.dim))


def gather_group(group: Group, engine, src: torch.Tensor, quant: bool,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One group's synchronous gather over the engine's shard group → rows
    [Z, n_row]: the int8 wire from the fp32 master (``out``: fp32 rows to
    dequantize into) or the exact gather of the compute-dtype shard."""
    send = pack(group, engine, src)
    if quant:
        if engine.expert_rows(group) is not None:
            rows = C._q_allgather(to_wire(engine, group, send),
                                  engine.shard_group, engine.shard_world)
            return from_wire(engine, group, rows)
        return C._q_allgather(send, engine.shard_group, engine.shard_world,
                              out=out)
    return C.gather_rows(send, engine.shard_group, engine.shard_world,
                         send.dtype, False)


class _ChunkGather(torch.autograd.Function):
    """A group's gather as one autograd node: forward waits for the
    group's rows and returns its parameters (one output a layer and
    leaf); backward hands the gradients to the coordinator. Saves no
    tensor."""

    @staticmethod
    def forward(ctx, anchor, coord, key):
        ctx.coord, ctx.key = coord, key
        ctx.set_materialize_grads(False)
        return tuple(coord._materialize(key))

    @staticmethod
    def backward(ctx, *grads):
        ctx.coord._backward(ctx.key[0], grads)
        return None, None, None


class Stage3Params(ParamHook):
    """The ZeRO-3 parameter coordinator of one :class:`~deepspeed_tpu_torch.
    runtime.engine.Zero3Engine` (see the module docstring). The engine
    calls :meth:`begin_forward`, the model's loss with this object as its
    parameters, :meth:`begin_backward`, the backward, then
    :meth:`finish_micro`. ``counts`` holds this step's gathers (by pass)
    and reduces."""

    def __init__(self, engine, chunk_bounds, prefetch: bool,
                 recompute: bool):
        # a weak reference: the engine owns the coordinator, and a cycle
        # would keep a dropped engine's buffers until the next collection
        self.e = weakref.proxy(engine)
        # a spec whose builder takes the hook (``causal_lm_spec``): the
        # head group and its layer chunks; any other spec: the whole tree
        # as one group (``tree``)
        bounds = [tuple(b) for b in chunk_bounds] or (
            [(0, engine.model_spec.config.num_layers)] if engine._hooked
            else [])
        self.groups = gather_groups(engine._shards, bounds,
                                    frozenset(engine._expert_dims))
        self.chunk_of = {l: c for c, (s, e) in enumerate(bounds, start=1)
                         for l in range(s, e)}
        self.prefetch = prefetch
        self.recompute = recompute
        # a pipeline stage's passes (module docstring); 1F1B's ÷ M
        self.piped = engine.pp > 1
        self.grad_div = 1.0
        if self.piped and any(p.layers is None and p.path[0] == BLOCKS
                              for p in self.groups[0].pieces):
            raise ValueError("ZeRO-3 under pipe: a layer-stacked leaf in "
                             "the head group (its layer dim is the stage's)")
        self.queue = comm.CommQueue()
        self.anchor = torch.zeros((), device=engine.device,
                                  requires_grad=True)
        self._pass = "fwd"
        self._inflight: Dict[Tuple[int, str], Any] = {}
        self._cache: Dict[Tuple[int, str], Tuple[torch.Tensor, ...]] = {}
        self._head: Optional[Dict[Tuple[str, ...], torch.Tensor]] = None
        self._reduces: List[Tuple[Any, int]] = []
        self.counts = {"gather_fwd": 0, "gather_bwd": 0, "reduce": 0}
        # each group's outputs: (piece, layer or None) in output order
        self._layout = []
        for g in self.groups:
            if g.layers is None:
                self._layout.append([(p, None) for p in g.pieces])
            else:
                self._layout.append([(p, l) for l in range(*g.layers)
                                     for p in g.pieces])

    # ------------------------------------------------------------------ #
    # the gathers
    # ------------------------------------------------------------------ #
    def _issue(self, key: Tuple[int, str]) -> None:
        g = self.groups[key[0]]
        W, e = self.e.shard_world, self.e
        with torch.no_grad(), telemetry.span("zero3_gather_issue"):
            if e._quant_weights():
                q, s = C.quantize_int8(to_wire(e, g, pack(g, e,
                                                          e.flat_master)),
                                       DEFAULT_BLOCK)
                outs = [torch.empty((W,) + tuple(q.shape), dtype=q.dtype,
                                    device=q.device),
                        torch.empty((W,) + tuple(s.shape), dtype=s.dtype,
                                    device=s.device)]
                ins = [q, s]
            else:
                src = e._gather_source()
                if e._streaming() and src is e.flat_master:
                    # fp32: the group streamed from the host master
                    e.stream_counts["gather_h2d"] += 1
                send = pack(g, e, src)
                outs = [torch.empty(W, g.n_row, dtype=send.dtype,
                                    device=send.device)]
                ins = [send]
            handle = self.queue.submit(comm.all_gather_op(e.shard_group),
                                       outs, ins, slot=f"z3g{key[0] % 2}",
                                       group=e.shard_group)
        self._inflight[key] = handle

    def _materialize(self, key: Tuple[int, str]) -> List[torch.Tensor]:
        """Wait for the group's rows; its parameters in the leaf layout
        (compute dtype), one output a (layer, piece)."""
        gi = key[0]
        g, e = self.groups[gi], self.e
        if key not in self._inflight:
            self._issue(key)
        handle = self._inflight.pop(key)
        with telemetry.span("zero3_gather_wait"):
            outs = handle.wait()
        self.counts[f"gather_{key[1]}"] += 1
        with telemetry.span("zero3_gather_unpack"):
            if e._quant_weights():
                qg, sg = outs
                rows = from_wire(e, g, C.dequant_reduce(
                    qg.view(1, -1), sg.view(1, -1),
                    DEFAULT_BLOCK).view(e.shard_world, -1))
            else:
                rows = outs[0]
            full = {}
            for p in g.pieces:
                full[p.path] = torch.empty(p.shape(), dtype=e.compute_dtype,
                                           device=e.device)
                if not p.n:                 # replicated: the local copy
                    loc = e._local(e._gather_source(), p.shard)
                    if p.layers is not None:
                        loc = loc[p.layers[0]:p.layers[1]]
                    full[p.path].copy_(loc)
            unpack(g, rows, e.shard_world, lambda p: full[p.path])
            del rows, outs
        start = g.layers[0] if g.layers is not None else 0
        return [full[p.path] if l is None else full[p.path][l - start]
                for p, l in self._layout[gi]]

    def _take(self, gi: int) -> Tuple[torch.Tensor, ...]:
        key = (gi, self._pass)
        out = self._cache.get(key)
        if out is None:
            out = _ChunkGather.apply(self.anchor, self, key)
            self._cache[key] = out
        return out

    def _submit_ahead(self, gi: int, pass_: str) -> None:
        """Submit a gather ahead of its use (``overlap_comm``); the head
        group (0) only at the forward's start."""
        if self.prefetch and 0 <= gi < len(self.groups) \
                and (gi, pass_) not in self._inflight \
                and (gi, pass_) not in self._cache:
            self._issue((gi, pass_))

    # ------------------------------------------------------------------ #
    # the model's hook
    # ------------------------------------------------------------------ #
    def begin_forward(self) -> None:
        self._pass = "fwd"
        if self.piped:
            self._cache.clear()
            return
        self._submit_ahead(0, "fwd")
        self._submit_ahead(1, "fwd")

    def begin_backward(self) -> None:
        self._pass = "bwd"
        if self.piped:
            self._cache.clear()

    def head(self) -> Dict[str, Any]:
        outs = _ChunkGather.apply(self.anchor, self, (0, "fwd"))
        self._head = {p.path: t for (p, _), t in zip(self._layout[0], outs)}
        tree: Dict[str, Any] = {}
        for path, t in self._head.items():
            if path[0] != BLOCKS:
                _set_path(tree, path, t)
        return tree

    def tree(self) -> Dict[str, Any]:
        """A spec without the hook: the whole parameter tree, gathered as
        one group for this forward (autograd keeps it for the backward;
        its gradient is reduced when the backward is done)."""
        outs = _ChunkGather.apply(self.anchor, self, (0, "fwd"))
        tree: Dict[str, Any] = {}
        for (p, _), t in zip(self._layout[0], outs):
            _set_path(tree, p.path, t)
        return tree

    def _piped_chunk(self, layer: int) -> Tuple[int, Tuple]:
        """A pipeline pass's chunk of ``layer`` (gathered at the pass's
        first use, dropped once each of its layers was taken)."""
        gi = self.chunk_of[layer]
        entry = self._cache.get(gi)
        if entry is None:
            start, stop = self.groups[gi].layers
            entry = self._cache[gi] = (
                _ChunkGather.apply(self.anchor, self, (gi, self._pass)),
                set(range(start, stop)))
        outs, left = entry
        left.discard(layer)
        if not left:
            del self._cache[gi]
        return gi, outs

    def _planned_chunk(self, layer: int) -> Tuple[int, Tuple]:
        """The chunk of ``layer`` in the plan's order: the next one
        submitted at a chunk's first layer (the previous one in the
        backward), dropped after its last."""
        gi = self.chunk_of[layer]
        start, stop = self.groups[gi].layers
        fwd = self._pass == "fwd"
        first = layer == (start if fwd else stop - 1)
        last = layer == (stop - 1 if fwd else start)
        if first and (fwd or gi > 1):
            self._submit_ahead(gi + 1 if fwd else gi - 1, self._pass)
        outs = self._take(gi)
        if last:
            del self._cache[(gi, self._pass)]
            if fwd and gi == len(self.groups) - 1 and self.recompute:
                self._submit_ahead(gi, "bwd")
        return gi, outs

    def layer(self, layer: int) -> Dict[str, Any]:
        gi, outs = (self._piped_chunk if self.piped
                    else self._planned_chunk)(layer)
        lp: Dict[str, Any] = {}
        for (p, l), t in zip(self._layout[gi], outs):
            if l == layer:
                _set_path(lp, p.path[1:], t)
        for path, t in self._head.items():      # blocks leaves sharded on 0
            if path[0] == BLOCKS:
                _set_path(lp, path[1:], t[layer])
        return lp

    # ------------------------------------------------------------------ #
    # the gradients
    # ------------------------------------------------------------------ #
    def reduce_head(self, grads: Dict[str, Any]) -> None:
        """The head group's gradient from a tree of whole leaves (1F1B's
        extras, summed over ``pipe`` and ÷ M by the schedule): reduced as
        a gather's backward reduces it."""
        flat = dict(_flatten(grads))
        self._backward(0, [flat.get(p.path) for p, _ in self._layout[0]],
                       div=1.0)

    def _backward(self, gi: int, grads, div: Optional[float] = None) -> None:
        g, e = self.groups[gi], self.e
        div = self.grad_div if div is None else div
        if div != 1.0:
            grads = [None if gr is None else gr / div for gr in grads]
        with torch.no_grad():
            if e.flat_grad is not None:          # qgZ / LoCo
                self._to_full_grad(gi, grads)
                return
            with telemetry.span("zero3_reduce_issue"):
                rows = torch.zeros(e.shard_world, g.n_row,
                                   dtype=torch.float32, device=e.device)
                for (p, l), gr in zip(self._layout[gi], grads):
                    if gr is None:
                        continue
                    if not p.n:
                        rep = e._rep_view(p.shard)
                        (rep if l is None else rep[l]).add_(gr)
                        continue
                    moved = p.moved(e.shard_world)
                    dst = rows[:, p.offset:p.offset + p.n].view(moved)
                    if l is not None:
                        dst = dst[:, :, l - g.layers[0]]
                        gr = torch.movedim(gr, p.shard.dim - 1, 0)
                    else:
                        gr = torch.movedim(gr, p.shard.dim, 0)
                    dst.copy_(gr.reshape(dst.shape))
                mine = torch.empty(g.n_row, dtype=torch.float32,
                                   device=e.device)
                handle = self.queue.submit(
                    comm.reduce_scatter_op(e.shard_group,
                                           e.hops(g.n_dense, g.n_row)),
                    [mine], [rows], slot=f"z3r{gi % 2}", group=e.shard_group)
            self.counts["reduce"] += 1
            self._reduces.append((handle, gi))
            while len(self._reduces) > 2:       # bound what is in flight
                self._land(*self._reduces.pop(0))

    def _to_full_grad(self, gi: int, grads) -> None:
        e = self.e
        for (p, l), gr in zip(self._layout[gi], grads):
            if gr is None:
                continue
            dst = e._view(e.flat_grad, p.shard.slot)
            if p.layers is not None:
                dst = dst[l]
            dst.copy_(gr)

    def _land(self, handle, gi: int) -> None:
        """A reduce has landed: its sum (both hops under hpZ) ÷ the
        engine's ``grad_world`` (the world, less a ``tensor`` axis) into the
        accumulator."""
        g, e = self.groups[gi], self.e
        with telemetry.span("zero3_reduce_wait"):
            mine, = handle.wait()
        with torch.no_grad():
            mine.div_(torch.tensor(float(e.grad_world), device=e.device))
            for p in g.pieces:
                if not p.n:
                    continue
                acc = e._local(e.flat_grad_acc, p.shard)
                if p.layers is not None:
                    acc = acc[:, p.layers[0]:p.layers[1]]
                acc.add_(mine[p.offset:p.offset + p.n].view(acc.shape))

    def finish_micro(self) -> None:
        """After the backward: every reduce landed, nothing in flight or
        cached (gloo must see no queued op before the engine's own)."""
        while self._reduces:
            self._land(*self._reduces.pop(0))
        self.queue.drain()
        self._head = None
        if self.piped:
            self._cache.clear()
        if self._inflight or self._cache:
            raise RuntimeError(f"ZeRO-3: gathers left after the micro-batch:"
                               f" {sorted(self._inflight)} "
                               f"{sorted(self._cache)}")

    def gathers_per_micro(self) -> int:
        """Gathers a micro-batch: the head group, each chunk in the
        forward, and again in the backward's recompute (a spec without
        the hook: its one group)."""
        chunks = len(self.groups) - 1
        return 1 + chunks * (2 if self.recompute else 1)

    def close(self) -> None:
        self.queue.close()


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) of a tree of dicts (None leaves left out)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        elif v is not None:
            yield prefix + (k,), v


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
