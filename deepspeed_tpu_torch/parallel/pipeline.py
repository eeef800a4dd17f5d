"""Pipeline parallelism: the micro-batch tick schedules over the ``pipe``
mesh axis.

Ports ``deepspeed_tpu/parallel/pipeline.py``: ``stage_perm`` (:38),
``pipelined_apply`` (:51, GPipe), ``pipelined_infer`` (:117, the fill
wavefront only), ``microbatch`` (:164) and ``pipelined_train_1f1b`` (:177,
1F1B with its explicit backward). JAX runs each schedule as one
``lax.scan`` over ticks inside a ``shard_map`` manual over ``pipe``; here
each rank is one stage (``MeshManager.pipe()``, a
:class:`~deepspeed_tpu_torch.comm.mesh.PipeGroup`) and runs the ticks as a
Python loop on its own layers, its hops one ``comm.pipe_exchange`` with
its neighbours on the pipeline's own ``pipe`` group. At tick t stage s
computes micro-batch t − s (the diagonal wavefront), then hands its
activation to stage s + 1.

Where the eager port differs from JAX's program, the values do not:

* JAX's ``ppermute`` is cyclic (``stage_perm``): its wrap-around hop
  carries a value stage 0 never reads. The port sends P − 1 hops: the
  last stage sends no activation and the first no cotangent.
* JAX computes every stage on every tick and masks a micro-batch out of
  range with ``where``. The port skips a stage's compute, and its hop, on
  a tick whose micro-batch is out of range; so a stage sends exactly M
  activations (and, in 1F1B, M cotangents) a schedule. In 1F1B the last
  stage also skips the forward of its forward tick, whose output no
  stage reads: its backward tick, the same tick, recomputes the stage
  from the saved input anyway (the aux loss is taken there, the same
  value).
* ``DSTPU_PIPE_UNROLL`` (JAX :226) unrolls XLA's tick scan; an eager loop
  has nothing to unroll, so it is not ported.

GPipe (:func:`pipelined_apply`): backward is autograd over the recorded
ticks. Each hop is a differentiable op (its backward sends the cotangent
back and receives the next stage's). The leaves replicated over ``pipe``
— ``extra`` and the stage-0 input — pass through one op whose backward
sums their cotangents over the ``pipe`` group (JAX's vma psum, the
reference's ``ReduceTiedGrads``), so every stage holds the same
gradients of them. A zero scalar threads through that op and every hop
in tick order into the loss: autograd then runs the hops' backwards in
reverse tick order, and the sum after them all, on every stage, so gloo
sees one order of messages on the group.

1F1B (:func:`pipelined_train_1f1b`): at tick t stage s forwards
micro-batch t − s without a graph, keeping its input in a buffer of 2P,
and backwards micro-batch t − (2P − 2 − s) by a VJP with the stage
recomputed from that input (``torch.autograd.grad``): at most 2P − 1
stage inputs are live, O(P) whatever M. The loss seeds the last stage's
VJP, the received cotangent the others'. With :data:`tick_stats` a dict,
each 1F1B run adds its wall clock and its stage's compute sections to it
(the measured bubble, ``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm import mesh as mesh_mod

PyTree = Any

#: None, or a dict to which each ``pipelined_train_1f1b`` run adds
#: ``runs``, ``wall_s`` (the schedule's wall clock, the device synchronised
#: at both ends) and ``compute_s`` (the stage's own forward and backward
#: sections: CUDA events on a card, the host clock on the CPU), and each
#: run's pair under ``per_run``; the stage's measured bubble is
#: 1 − compute_s / wall_s
tick_stats: Optional[Dict[str, float]] = None


class _Sections:
    """The compute sections of one run, timed for :data:`tick_stats`."""

    def __init__(self, dev: torch.device):
        self.dev, self.pairs, self.host = dev, [], 0.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.t0 = time.perf_counter()

    @contextlib.contextmanager
    def section(self):
        if self.dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self.pairs.append((a, b))
        else:
            t = time.perf_counter()
            yield
            self.host += time.perf_counter() - t

    def close(self, stats: Dict[str, float]) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            self.host = sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3
        wall = time.perf_counter() - self.t0
        for k, v in (("runs", 1), ("wall_s", wall), ("compute_s", self.host)):
            stats[k] = stats.get(k, 0) + v
        stats.setdefault("per_run", []).append((wall, self.host))


def stage_perm(n_stages: int) -> List[Tuple[int, int]]:
    """JAX's cyclic stage permutation (the port's hops leave out its
    wrap-around pair)."""
    return [(j, (j + 1) % n_stages) for j in range(n_stages)]


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """[B, ...] → [M, B/M, ...]."""
    B = x.shape[0]
    if B % n_micro != 0:
        raise ValueError(f"batch {B} not divisible by pipeline microbatches "
                         f"{n_micro}")
    return x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))


def pipe_of(pp=None):
    """``pp``, else the installed mesh's pipe group; a mesh without a
    ``pipe`` axis above 1 raises ``ValueError``."""
    if pp is None and mesh_mod.mesh_is_initialized():
        pp = mesh_mod.get_mesh_manager().pipe()
    if pp is None:
        raise ValueError("no 'pipe' mesh axis above 1: a pipelined schedule "
                         "needs a mesh with pipe > 1")
    return pp


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts (sorted keys), lists and tuples."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [] if tree is None else [tree]


def _rebuild(tree, values):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``values``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return None if tree is None else next(values)


def _like(t: torch.Tensor):
    return tuple(t.shape), t.dtype, t.device


class _Replicated(torch.autograd.Function):
    """The leaves replicated over ``pipe`` (identity forward) and a zero
    scalar, the link the hops thread; backward, the leaves' cotangents
    summed over the ``pipe`` group (one all-reduce of their fp32
    concatenation), which autograd runs after every hop's backward."""

    @staticmethod
    def forward(ctx, pp, link, *ts):
        ctx.pp = pp
        return (link.detach().clone(),) + tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, g_link, *gs):
        out = list(gs)
        if gs:
            flat = torch.cat([g.reshape(-1).float() for g in gs])
            comm.all_reduce(flat, group=ctx.pp.group)
            off = 0
            for i, g in enumerate(gs):
                out[i] = flat[off:off + g.numel()].view_as(g).to(g.dtype)
                off += g.numel()
        return (None, g_link, *out)


class _Hop(torch.autograd.Function):
    """One GPipe hop: ``y`` (None: nothing sent) to stage s + 1, the
    activation of stage s − 1 received where ``recv_like`` is given (else
    an empty tensor), and the link passed on; backward, the received
    activation's cotangent back to stage s − 1 and ``y``'s from stage
    s + 1, in one exchange."""

    @staticmethod
    def forward(ctx, y, link, pp, recv_like):
        ctx.pp, ctx.recv_like = pp, recv_like
        ctx.send_like = None if y is None else _like(y)
        got, _ = comm.pipe_exchange(pp, to_next=y, from_prev=recv_like)
        return (link.new_zeros(0) if got is None else got,
                link.detach().clone())

    @staticmethod
    def backward(ctx, g_recv, g_link):
        to_prev = g_recv if ctx.recv_like is not None else None
        _, gy = comm.pipe_exchange(ctx.pp, to_prev=to_prev,
                                   from_next=ctx.send_like)
        return gy, g_link, None, None


def _in_range(t: int, lag: int, M: int) -> bool:
    return 0 <= t - lag < M


def pipelined_apply(inputs: Dict[str, torch.Tensor], blocks: PyTree,
                    extra: PyTree, stage_fn: Callable, finalize_fn: Callable,
                    pp=None, remat_ticks: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GPipe schedule on this stage; returns (mean finalize value, mean
    aux), the same on every stage.

    * ``inputs`` — tensors with leading micro-batch dim M; ``"x"`` is the
      stage-0 input (e.g. the embedded activations [M, b, S, H]), which
      every stage holds; the rest feed ``finalize_fn`` (e.g. targets).
    * ``blocks`` — this stage's layers (``partitioning.pp_slice`` of the
      stack), whatever ``stage_fn`` takes.
    * ``extra`` — a tree of tensors every stage holds (norms, head, rope
      tables); those that require grad get their cotangents summed over
      ``pipe``, and so does ``x``.
    * ``stage_fn(x, blocks, extra) -> (y, aux scalar)``;
      ``finalize_fn(y, micro_inputs, extra) -> scalar`` (the last stage's
      loss of one micro-batch).
    * ``pp`` — the stage's ``PipeGroup`` (default: the installed mesh's).
    * ``remat_ticks`` — each tick's compute under
      ``torch.utils.checkpoint`` (only its input kept), JAX's
      ``jax.checkpoint(tick)``; its hop stays outside the checkpoint.
    """
    pp = pipe_of(pp)
    P, s = pp.size, pp.stage
    xm = inputs["x"]
    M = xm.shape[0]
    ex_leaves = _leaves(extra)
    diff = [i for i, t in enumerate(ex_leaves) if t.requires_grad]
    reps = [ex_leaves[i] for i in diff] + ([xm] if xm.requires_grad else [])
    link0 = torch.zeros((), device=xm.device,
                        requires_grad=torch.is_grad_enabled())
    link, *outs = _Replicated.apply(pp, link0, *reps)
    for i, t in zip(diff, outs):
        ex_leaves[i] = t
    x_r = outs[-1] if xm.requires_grad else xm
    extra_r = _rebuild(extra, iter(ex_leaves))
    like = _like(xm[0])
    last = s == P - 1

    def tick(x_in, m):
        y, aux = stage_fn(x_in, blocks, extra_r)
        if not last:
            return y, aux, torch.zeros((), device=y.device)
        micro = {k: v[m] for k, v in inputs.items() if k != "x"}
        return y, aux, finalize_fn(y, micro, extra_r).float()

    loss_sum = torch.zeros((), dtype=torch.float32, device=xm.device)
    aux_sum = torch.zeros((), dtype=torch.float32, device=xm.device)
    recv = None
    for t in range(M + P - 1):
        y = None
        if _in_range(t, s, M):
            x_in = x_r[t - s] if s == 0 else recv
            if remat_ticks and torch.is_grad_enabled():
                y, aux, loss_m = checkpoint(tick, x_in, t - s,
                                            use_reentrant=False,
                                            preserve_rng_state=False)
            else:
                y, aux, loss_m = tick(x_in, t - s)
            loss_sum = loss_sum + loss_m
            aux_sum = aux_sum + aux.float()
        send = y if not last else None
        recv_like = like if s > 0 and _in_range(t, s - 1, M) else None
        if send is not None or recv_like is not None:
            recv, link = _Hop.apply(send, link, pp, recv_like)
    sums = comm.reduce_from_tensor(torch.stack([loss_sum + link, aux_sum]),
                                   pp.group)
    return sums[0] / M, sums[1] / M


def pipelined_infer(inputs: Dict[str, torch.Tensor], blocks: PyTree,
                    extra: PyTree, stage_fn: Callable, head_fn: Callable,
                    out_like: Tuple[Tuple[int, ...], torch.dtype], pp=None
                    ) -> torch.Tensor:
    """The forward-only schedule (reference ``runtime/pipe/schedule.py:135
    InferenceSchedule``): the fill wavefront only, M + P − 1 ticks, no
    graph. The last stage applies ``head_fn(y, extra)`` to each
    micro-batch's output, and the stacked [M, ...] result goes to every
    stage by one broadcast over ``pipe`` (JAX: a psum of the last stage's
    buffer). ``out_like``: (shape, dtype) of one micro-batch's head output
    (JAX takes it from ``jax.eval_shape``), for the other stages' buffer."""
    pp = pipe_of(pp)
    P, s = pp.size, pp.stage
    xm = inputs["x"]
    M = xm.shape[0]
    like = _like(xm[0])
    shape, dtype = out_like
    out = torch.zeros((M,) + tuple(shape), dtype=dtype, device=xm.device)
    recv = None
    with torch.no_grad():
        for t in range(M + P - 1):
            y = None
            if _in_range(t, s, M):
                y, _ = stage_fn(xm[t - s] if s == 0 else recv, blocks, extra)
                if s == P - 1:
                    out[t - s] = head_fn(y, extra).to(dtype)
            send = y if s < P - 1 else None
            recv_like = like if s > 0 and _in_range(t, s - 1, M) else None
            if send is not None or recv_like is not None:
                recv, _ = comm.pipe_exchange(pp, to_next=send,
                                             from_prev=recv_like)
        comm.broadcast(out, src=pp.ranks[-1], group=pp.group)
    return out


def pipelined_train_1f1b(inputs: Dict[str, torch.Tensor], blocks: PyTree,
                         extra: PyTree, stage_fn: Callable,
                         finalize_fn: Callable, input_grad_fn: Callable,
                         pp=None, loss_scale=None, aux_seed=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, PyTree,
                                    PyTree, PyTree]:
    """The 1F1B schedule with its explicit backward (reference
    ``runtime/pipe/schedule.py:189 TrainSchedule``) on this stage.

    Stage s forwards micro-batch t − s and backwards micro-batch
    t − (2P − 2 − s) at tick t, over M + 2P − 2 ticks; the activation
    goes to s + 1 and the cotangent to s − 1 in one exchange a tick.

    * ``stage_fn``, ``finalize_fn``: as :func:`pipelined_apply`;
    * ``input_grad_fn(dx, micro_inputs, acc) -> acc`` folds the cotangent
      of the stage-0 input onto the embedding parameters (stage 0's
      backward ticks); ``input_grad_fn(None, None, None)`` gives the zero
      accumulators;
    * ``loss_scale`` multiplies the loss's seed (fp16 loss scaling);
      ``aux_seed`` seeds each stage's aux output (the MoE aux coefficient,
      the scale included; None: aux not differentiated).

    Returns (mean loss, mean aux, ``blocks``' gradients — this stage's,
    fp32, ÷ M —, ``extra``'s gradients summed over ``pipe`` ÷ M, the
    embedding gradients summed over ``pipe`` ÷ M); the loss, the aux and
    the sums are one all-reduce over ``pipe``. A leaf that does not
    require grad gets zeros.

    ``blocks`` may be a parameter hook (a ZeRO-3 engine's
    ``parallel/stage3.Stage3Params``, which ``stage_fn`` asks for each
    layer): the schedule marks each pass on it (``begin_forward`` before a
    forward, ``begin_backward`` before a VJP's backward) and takes its
    ``anchor`` among a VJP's inputs, so that the hook's gathers hand it
    the layers' gradients as each VJP computes them; the blocks' result is
    None then."""
    pp = pipe_of(pp)
    P, s = pp.size, pp.stage
    first, last = s == 0, s == P - 1
    xm = inputs["x"]
    M = xm.shape[0]
    dt, dev = xm.dtype, xm.device
    like = _like(xm[0])
    hook = blocks if hasattr(blocks, "anchor") else None
    bl, ex = ([] if hook is not None else _leaves(blocks)), _leaves(extra)
    bl_d = [t for t in bl if t.requires_grad]
    ex_d = [t for t in ex if t.requires_grad]
    gbl = [torch.zeros(t.shape, dtype=torch.float32, device=dev) for t in bl]
    gex = [torch.zeros(t.shape, dtype=torch.float32, device=dev) for t in ex]
    gemb = input_grad_fn(None, None, None)
    seed = torch.tensor(1.0 if loss_scale is None else float(loss_scale),
                        dtype=torch.float32, device=dev)
    aseed = None if aux_seed is None else torch.tensor(
        float(aux_seed), dtype=torch.float32, device=dev)
    store: List[Optional[torch.Tensor]] = [None] * (2 * P)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
    fwd_recv = bwd_recv = None
    lag_b = 2 * (P - 1) - s
    stats = tick_stats
    sections = _Sections(dev) if stats is not None else None

    def timed():
        return (sections.section() if sections is not None
                else contextlib.nullcontext())

    for t in range(M + 2 * P - 2):
        # ---- forward: micro-batch t - s ---------------------------------
        y = None
        if _in_range(t, s, M):
            x_in = xm[t - s] if first else fwd_recv
            store[(t - s) % (2 * P)] = x_in
            if not last:
                if hook is not None:
                    hook.begin_forward()
                with torch.no_grad(), timed():
                    y, aux = stage_fn(x_in, blocks, extra)
                aux_sum = aux_sum + aux.float()
        # ---- backward: micro-batch t - (2P-2-s) -------------------------
        dx = None
        if _in_range(t, lag_b, M):
            m = t - lag_b
            micro = {k: v[m] for k, v in inputs.items() if k != "x"}
            x = store[m % (2 * P)].detach().requires_grad_(True)
            store[m % (2 * P)] = None
            if hook is not None:
                hook.begin_forward()
            with torch.enable_grad(), timed():
                yy, aux = stage_fn(x, blocks, extra)
                if last:
                    loss_m = finalize_fn(yy, micro, extra).float()
                    outs, seeds = [loss_m], [seed]
                    loss_sum = loss_sum + loss_m.detach()
                    aux_sum = aux_sum + aux.detach().float()
                else:
                    outs, seeds = [yy], [bwd_recv]
                if aseed is not None and aux.requires_grad:
                    outs.append(aux.float())
                    seeds.append(aseed)
                if hook is not None:
                    hook.begin_backward()
                grads = torch.autograd.grad(
                    outs, [x] + bl_d + ex_d + ([hook.anchor] if hook
                                               is not None else []),
                    seeds, allow_unused=True)
            dx = grads[0]
            for acc, g in zip((a for a, t_ in zip(gbl, bl)
                               if t_.requires_grad), grads[1:1 + len(bl_d)]):
                if g is not None:
                    acc.add_(g.float())
            for acc, g in zip((a for a, t_ in zip(gex, ex)
                               if t_.requires_grad), grads[1 + len(bl_d):]):
                if g is not None:
                    acc.add_(g.float())
            if first:
                gemb = input_grad_fn(dx, micro, gemb)
            del grads, yy, x
        # ---- hops: activation to s+1, cotangent to s-1 -----------------
        to_next = y if not last else None
        to_prev = dx.to(dt) if dx is not None and not first else None
        from_prev = like if not first and _in_range(t, s - 1, M) else None
        from_next = like if not last and _in_range(t, lag_b - 1, M) \
            else None
        if any(v is not None for v in (to_next, to_prev, from_prev,
                                       from_next)):
            fwd_recv, bwd_recv = comm.pipe_exchange(pp, to_next, to_prev,
                                                    from_prev, from_next)
    if sections is not None:
        sections.close(stats)
    ge = _leaves(gemb)
    flat = torch.cat([torch.stack([loss_sum, aux_sum])]
                     + [g.reshape(-1).float() for g in gex + ge])
    comm.all_reduce(flat, group=pp.group)
    flat.div_(float(M))
    vals, off = [], 2
    for g in gex + ge:
        vals.append(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()
    gblocks = None if hook is not None else _rebuild(
        blocks, iter([g.div_(float(M)) for g in gbl]))
    gextra = _rebuild(extra, iter(vals[:len(gex)]))
    gemb = _rebuild(gemb, iter(vals[len(gex):]))
    return flat[0], flat[1], gblocks, gextra, gemb
