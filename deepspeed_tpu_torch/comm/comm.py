"""DeepSpeed-shaped collective API over ``torch.distributed``.

Ports ``deepspeed_tpu/comm/comm.py``: ``ReduceOp`` (:42),
``init_distributed`` (:59), ``is_initialized`` / ``destroy_process_group``
/ ``get_world_size`` / ``get_rank`` / ``get_local_rank`` /
``get_data_parallel_world_size`` (:99-163), ``barrier`` (:169) and the
collectives ``all_reduce`` (:267), ``all_gather`` / ``all_gather_into_tensor``
(:296, :313), ``reduce_scatter`` / ``reduce_scatter_tensor`` (:320, :341),
``all_to_all_single`` (:347) and ``broadcast`` (:374). The JAX functions
run over named mesh axes of one program; these run between processes, each
passing its own tensor, with ``torch.distributed``'s semantics: a
collective returns the local result (``all_reduce`` and ``broadcast`` in
place, the ``*_into_tensor`` / ``*_tensor`` forms into ``output``).

The backend is the caller's choice and is never switched: ``nccl`` by
default (CUDA tensors), ``gloo`` when asked (CPU tensors, or several
processes sharing one card, which NCCL refuses). gloo runs its collectives
in host memory: for a CUDA tensor it copies through host buffers itself
where it takes CUDA tensors at all, and refuses them for other ops. So
every gloo collective on a CUDA tensor goes through
:func:`_gloo_via_pinned_host`, which copies the operands into pinned host
buffers, runs the collective there and copies the result back — one path
for every op. The compute stays on the device.

:class:`CommQueue` runs collectives while the card computes (ZeRO-3's
chunk gathers and gradient reduces, ``parallel/stage3.py``; the exact
stage 1-2 wire's chunk and bucket reduces and the ``overlap_step``
publish, ``runtime/engine.py``): one worker
thread takes them in the order they were submitted, so every rank issues
the same collectives in the same order; on gloo with CUDA tensors it
stages them through its own pinned buffers, one set a slot, on a side
stream. ``submit`` returns a :class:`Handle` to wait on. An op left in
flight past a step (:func:`leave_in_flight`) lands before any collective
of this module outside a queue (:func:`settle`).

The MoE layer's collectives differentiate: :func:`all_to_all_autograd`
(the tiled all-to-all of dim 0, whose backward is the all-to-all of the
gradient, JAX's transpose of ``lax.all_to_all(..., tiled=True)``) and
:func:`all_reduce_mean_autograd` (the mean over a group, whose backward is
the mean of the gradients, JAX's transpose of ``pmean``). They run on the
MoE layer's own groups (``MeshManager.moe_group``) through the same gloo
staging.

Every collective counts itself in :data:`traffic` under its group's label
(``world``, the ``zshard`` / ``data`` / ``expert`` axis groups, the MoE
layer's ``batch`` group; ``comm/mesh.group_label``) and its kind: calls, the elements this rank
sends in, and the host seconds the calling thread spent in it (the
queue's worker thread included). A call costs two clock reads and a few
additions; the counts show which group carries what (no parameter gather
on ``data`` under hpZ).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import datetime
import enum
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm import mesh as mesh_mod
from deepspeed_tpu_torch.runtime.config_utils import logger


class ReduceOp(enum.Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
              ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
              ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX}
# newer torch names the flat-tensor forms *_single and deprecates the old
_all_gather_flat = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single",
                               dist.reduce_scatter_tensor)


# --------------------------------------------------------------------------- #
# bring-up and queries
# --------------------------------------------------------------------------- #

def init_distributed(dist_backend: str = "nccl",
                     auto_mpi_discovery: bool = True, verbose: bool = True,
                     timeout=None, init_method: Optional[str] = None,
                     dist_init_required: Optional[bool] = None, config=None,
                     rank: int = -1, world_size: int = -1,
                     mesh_config: Optional[mesh_mod.MeshConfig] = None
                     ) -> None:
    """Join the default process group and resolve the mesh over it.

    ``rank`` / ``world_size`` of -1 and ``init_method=None`` leave them to
    torch, which reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` from the environment (``env://``). ``timeout`` is in
    seconds (or a ``timedelta``). A second call is a no-op."""
    if not dist.is_initialized():
        if dist_init_required is False:
            return
        kw = {}
        if timeout is not None:
            kw["timeout"] = (timeout if isinstance(timeout, datetime.timedelta)
                             else datetime.timedelta(seconds=float(timeout)))
        if rank >= 0:
            kw["rank"] = rank
        if world_size >= 0:
            kw["world_size"] = world_size
        dist.init_process_group(backend=dist_backend, init_method=init_method,
                                **kw)
    mesh_mod.initialize_mesh(mesh_config)
    if verbose:
        logger.info(f"init_distributed: backend={dist.get_backend()} "
                    f"rank={dist.get_rank()} world={dist.get_world_size()} "
                    f"mesh={mesh_mod.get_mesh_manager()}")


# --------------------------------------------------------------------------- #
# ops an engine leaves in flight past its step
# --------------------------------------------------------------------------- #

# (handle, land): queued ops left in flight past a step (the overlap_step
# publish), oldest first, each with what lands its outputs; they hold no
# engine, so a dropped engine's ops are settled all the same
_in_flight: List[Tuple["Handle", Callable[[List[torch.Tensor]], None]]] = []


def leave_in_flight(handle: "Handle",
                    land: Callable[[List[torch.Tensor]], None],
                    keep: int = 2) -> None:
    """Leave a :class:`CommQueue` op in flight: ``land(outputs)`` runs when
    it is settled — before every collective this module issues outside a
    queue, so gloo sees every rank's collectives in one order, or when more
    than ``keep`` ops are in flight (the oldest first)."""
    _in_flight.append((handle, land))
    settle(keep)


def settle(keep: int = 0) -> None:
    """Wait for and land the ops left in flight, all but the ``keep``
    newest."""
    while len(_in_flight) > keep:
        handle, land = _in_flight.pop(0)
        land(handle.wait())


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def destroy_process_group() -> None:
    settle()
    if is_initialized():
        dist.destroy_process_group()
    _pinned.clear()
    mesh_mod.reset_mesh()


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def get_rank(group=None) -> int:
    return dist.get_rank(group) if is_initialized() else 0


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def get_data_parallel_world_size() -> int:
    return mesh_mod.get_mesh_manager().dp_world_size


def get_backend(group=None) -> Optional[str]:
    return dist.get_backend(group) if is_initialized() else None


def barrier(group=None) -> None:
    settle()
    if get_world_size(group) > 1:
        dist.barrier(group)


# --------------------------------------------------------------------------- #
# gloo on CUDA tensors: through pinned host buffers
# --------------------------------------------------------------------------- #

_PinnedT = Dict[Tuple[str, int, torch.dtype], torch.Tensor]
_pinned: _PinnedT = {}

# "<group label>/<kind>" → [calls, elements sent in, host seconds], this
# process's
traffic: Dict[str, List[float]] = {}


@contextlib.contextmanager
def _traffic(group, kind: str, t: torch.Tensor):
    c = traffic.setdefault(f"{mesh_mod.group_label(group)}/{kind}",
                           [0, 0, 0.0])
    t0 = time.perf_counter()
    try:
        yield
    finally:
        c[0] += 1
        c[1] += t.numel()
        c[2] += time.perf_counter() - t0


def reset_traffic() -> None:
    traffic.clear()


def _host_buffer(slot: str, like: torch.Tensor,
                 pool: Optional[_PinnedT] = None) -> torch.Tensor:
    """A host tensor of ``like``'s size and dtype, pinned when a card is
    present, kept in ``pool`` (default: the module's) per (slot, size,
    dtype) for the next call."""
    pool = _pinned if pool is None else pool
    key = (slot, like.numel(), like.dtype)
    buf = pool.get(key)
    if buf is None:
        buf = torch.empty(like.numel(), dtype=like.dtype,
                          pin_memory=torch.cuda.is_available())
        pool[key] = buf
    return buf.view(like.shape)


def _gloo_via_pinned_host(op: Callable[[torch.Tensor, torch.Tensor], None],
                          out: torch.Tensor, inp: torch.Tensor) -> None:
    """Run ``op(host_out, host_in)`` — a gloo collective — on host copies
    of ``inp`` and copy its result into ``out`` (``out is inp`` for the
    in-place ops)."""
    h_in = _host_buffer("in", inp)
    h_in.copy_(inp)
    h_out = h_in if out is inp else _host_buffer("out", out)
    op(h_out, h_in)
    out.copy_(h_out)


def _run(op: Callable[[torch.Tensor, torch.Tensor], None], out: torch.Tensor,
         inp: torch.Tensor, group=None) -> torch.Tensor:
    if inp.device.type == "cuda" and get_backend(group) == "gloo":
        _gloo_via_pinned_host(op, out, inp)
    else:
        op(out, inp)
    return out


# --------------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------------- #

def all_reduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
               group=None) -> torch.Tensor:
    """In-place all-reduce; AVG is a SUM divided by the world size (gloo
    has no AVG)."""
    settle()
    world = get_world_size(group)
    with _traffic(group, "all_reduce", tensor):
        if world <= 1:
            return tensor
        top = _TORCH_OPS[ReduceOp.SUM if op == ReduceOp.AVG else op]
        _run(lambda o, i: dist.all_reduce(o, op=top, group=group), tensor,
             tensor, group)
    if op == ReduceOp.AVG:
        tensor.div_(torch.tensor(float(world), device=tensor.device))
    return tensor


def all_gather_into_tensor(output_tensor: torch.Tensor, tensor: torch.Tensor,
                           group=None) -> torch.Tensor:
    """``output_tensor`` [world × n] ← every rank's ``tensor`` [n], in rank
    order."""
    settle()
    with _traffic(group, "all_gather", tensor):
        if get_world_size(group) <= 1:
            return output_tensor.copy_(tensor.reshape(output_tensor.shape))
        return _run(lambda o, i: _all_gather_flat(
            o.view(-1), i.reshape(-1), group=group), output_tensor, tensor,
            group)


def all_gather(tensor: torch.Tensor, group=None, gather_axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along ``gather_axis``
    (``tiled``) or stacked on a new leading axis."""
    world = get_world_size(group)
    t = tensor.movedim(gather_axis, 0).contiguous()
    out = torch.empty((world,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    all_gather_into_tensor(out, t, group)
    if not tiled:
        return out
    return out.reshape((-1,) + tuple(t.shape[1:])).movedim(0, gather_axis)


def reduce_scatter_tensor(output_tensor: torch.Tensor, tensor: torch.Tensor,
                          op: ReduceOp = ReduceOp.SUM,
                          group=None) -> torch.Tensor:
    """``output_tensor`` [n] ← this rank's chunk of the reduction of every
    rank's ``tensor`` [world × n]; SUM or AVG."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"reduce_scatter supports SUM/AVG, got {op}")
    settle()
    world = get_world_size(group)
    with _traffic(group, "reduce_scatter", tensor):
        if world <= 1:
            output_tensor.copy_(tensor.reshape(output_tensor.shape))
        else:
            _run(lambda o, i: _reduce_scatter_flat(
                o.view(-1), i.reshape(-1), op=dist.ReduceOp.SUM,
                group=group), output_tensor, tensor, group)
    if op == ReduceOp.AVG:
        output_tensor.div_(torch.tensor(float(world),
                                        device=output_tensor.device))
    return output_tensor


def reduce_scatter(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                   group=None, scatter_axis: int = 0,
                   tiled: bool = True) -> torch.Tensor:
    """This rank's chunk along ``scatter_axis`` of the reduction (``tiled``;
    otherwise ``scatter_axis`` has the world's length and is dropped)."""
    world = get_world_size(group)
    t = tensor.movedim(scatter_axis, 0).contiguous()
    out = torch.empty((t.shape[0] // world,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    reduce_scatter_tensor(out, t, op, group)
    if not tiled:
        return out[0]
    return out.movedim(0, scatter_axis)


def all_to_all_single(tensor: torch.Tensor, group=None, split_axis: int = 0,
                      concat_axis: int = 0) -> torch.Tensor:
    """Row r of dim 0 goes to rank r; the result's row r came from rank r
    (``split_axis = concat_axis = 0``, the tiled form)."""
    if split_axis != 0 or concat_axis != 0:
        raise ValueError("all_to_all_single splits and concatenates dim 0")
    settle()
    with _traffic(group, "all_to_all", tensor):
        if get_world_size(group) <= 1:
            return tensor.clone()
        out = torch.empty_like(tensor)
        return _run(lambda o, i: dist.all_to_all_single(o, i, group=group),
                    out, tensor.contiguous(), group)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all of dim 0 over ``group``; backward: the
    all-to-all of the gradient (the exchange is its own transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_single(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_single(g.contiguous(), ctx.group), None


def all_to_all_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable :func:`all_to_all_single` (rows of dim 0 split
    evenly over the group's ranks)."""
    return _AllToAll.apply(x, group)


class _AllReduceMean(torch.autograd.Function):
    """The mean over ``group`` of every rank's tensor; backward: the mean
    of every rank's gradient. With each rank differentiating its own loss
    L_r, rank r then receives d(Σ_s L_s)/dx_r, so the engine's sum (or
    mean) of the ranks' gradients is the gradient of the ranks' summed (or
    mean) loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = all_reduce(x.detach().clone(), group=group)
        return out / float(get_world_size(group))

    @staticmethod
    def backward(ctx, g):
        out = all_reduce(g.detach().clone(), group=ctx.group)
        return out / float(get_world_size(ctx.group)), None


def all_reduce_mean_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable mean of ``x`` over ``group``."""
    return _AllReduceMean.apply(x, group)


def broadcast(tensor: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    settle()
    with _traffic(group, "broadcast", tensor):
        if get_world_size(group) <= 1:
            return tensor
        return _run(lambda o, i: dist.broadcast(o, src=src, group=group),
                    tensor, tensor, group)


# --------------------------------------------------------------------------- #
# collectives in flight: one ordered queue
# --------------------------------------------------------------------------- #

class Handle:
    """A submitted collective. :meth:`wait` returns its outputs once they
    hold the result; the caller's later work on them is then safe."""

    def __init__(self, outs: Sequence[torch.Tensor], future=None,
                 keep: Sequence[torch.Tensor] = ()):
        self._outs = list(outs)
        self._future = future
        self._keep = list(keep)       # inputs alive until the op is done

    def done(self) -> bool:
        return self._future is None or self._future.done()

    def wait(self) -> List[torch.Tensor]:
        if self._future is not None:
            self._future.result()     # raises the op's own error
            self._future = None
            self._keep = []
        return self._outs


class CommQueue:
    """Collectives that run while the card computes, in submission order.

    ``submit(op, outs, ins, slot, group)`` runs ``op(outs, ins)`` —
    collectives on those tensors, of ``group`` (None: the default group)
    or, for a two-hop op, of hpZ's ``zshard`` then ``data`` group — after
    every earlier submission. gloo matches collectives by issue order in
    each group; one worker thread that takes every submission in order on
    every rank keeps that order for all groups at once. gloo runs them in
    that worker thread, started at the first submission:
    on CPU tensors directly; on CUDA tensors through pinned host buffers
    kept per ``(slot, size, dtype)``, copied on a side stream that first
    waits for the work the submitting stream had queued (an event recorded
    at submission), so the copies never block the submitting thread. Each
    op finishes — its outputs copied back to the card and synchronised —
    before the next one starts; a slot a chunk keeps two consecutive
    chunks' buffers apart all the same, and the buffers are keyed by the
    op's group too, so two groups' ops never share one. NCCL needs no
    staging: the op runs in the caller's thread, on NCCL's own stream.

    The caller waits on every handle (or :meth:`drain`) before it issues a
    collective outside the queue: gloo matches collectives by issue order
    across ranks. :meth:`close` drains, stops the thread and frees the
    pinned buffers."""

    def __init__(self):
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._stream = None
        self._pinned: _PinnedT = {}
        self._pending: List[Handle] = []

    def _worker(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dstpu-comm")
        return self._pool

    def submit(self, op: Callable[[List[torch.Tensor], List[torch.Tensor]],
                                  None],
               outs: Sequence[torch.Tensor], ins: Sequence[torch.Tensor],
               slot: str, group=None) -> Handle:
        outs, ins = list(outs), list(ins)
        dev = ins[0].device
        slot = f"{mesh_mod.group_label(group)}:{slot}"
        if dev.type == "cuda" and get_backend(group) != "gloo":
            op(outs, ins)                       # NCCL: its own stream
            return Handle(outs)
        if dev.type != "cuda":
            fut = self._worker().submit(op, outs, ins)
        else:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            fut = self._worker().submit(self._staged, op, outs, ins, slot,
                                        ready, dev)
        handle = Handle(outs, fut, keep=ins)
        self._pending = [h for h in self._pending if not h.done()]
        self._pending.append(handle)
        return handle

    def _staged(self, op, outs, ins, slot, ready, dev) -> None:
        with torch.cuda.device(dev):
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            side = self._stream
            side.wait_event(ready)
            h_ins = [_host_buffer(f"{slot}/in{i}", t, self._pinned)
                     for i, t in enumerate(ins)]
            h_outs = [_host_buffer(f"{slot}/out{i}", t, self._pinned)
                      for i, t in enumerate(outs)]
            with torch.cuda.stream(side):
                for h, t in zip(h_ins, ins):
                    h.copy_(t, non_blocking=True)
            side.synchronize()
            op(h_outs, h_ins)
            with torch.cuda.stream(side):
                for t, h in zip(outs, h_outs):
                    t.copy_(h, non_blocking=True)
            side.synchronize()

    def drain(self) -> None:
        """Wait for every submitted op."""
        pending, self._pending = self._pending, []
        for h in pending:
            h.wait()

    def close(self) -> None:
        self.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._pinned.clear()


def all_gather_op(group=None):
    """``CommQueue`` op: ``outs[i]`` [world × n_i] ← every rank's
    ``ins[i]`` [n_i] over ``group``, for each pair (one gather, or q and
    its scales)."""
    def op(outs, ins):
        for o, i in zip(outs, ins):
            with _traffic(group, "all_gather", i):
                _all_gather_flat(o.view(-1), i.reshape(-1), group=group)
    return op


def reduce_scatter_op(group=None, replica_group=None, replicas=False):
    """``CommQueue`` op: ``outs[0]`` [n] ← this rank's chunk of the sum of
    every rank's ``ins[0]`` [world × n] over ``group``; with ``replicas``
    (hpZ) that chunk then summed over ``replica_group`` too (the second
    hop, exact)."""
    def op(outs, ins):
        with _traffic(group, "reduce_scatter", ins[0]):
            _reduce_scatter_flat(outs[0].view(-1), ins[0].reshape(-1),
                                 op=dist.ReduceOp.SUM, group=group)
        if replicas:
            with _traffic(replica_group, "all_reduce", outs[0]):
                if get_world_size(replica_group) > 1:
                    dist.all_reduce(outs[0], op=dist.ReduceOp.SUM,
                                    group=replica_group)
    return op


def all_reduce_row_op(row: int, group=None, replica_group=None,
                      replicas=False):
    """``CommQueue`` op: ``outs[0]`` [n] ← row ``row`` of the sum of every
    rank's ``ins[0]`` [world × n] over ``group`` (the exact stage-1
    reduce: every rank sums everything and keeps its shard); with
    ``replicas`` (hpZ) that row then summed over ``replica_group`` too.
    ``ins[0]`` is summed in place."""
    def op(outs, ins):
        with _traffic(group, "all_reduce", ins[0]):
            if get_world_size(group) > 1:
                dist.all_reduce(ins[0], op=dist.ReduceOp.SUM, group=group)
        outs[0].copy_(ins[0][row])
        if replicas:
            with _traffic(replica_group, "all_reduce", outs[0]):
                if get_world_size(replica_group) > 1:
                    dist.all_reduce(outs[0], op=dist.ReduceOp.SUM,
                                    group=replica_group)
    return op
