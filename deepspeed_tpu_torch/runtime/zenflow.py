"""ZenFlow: importance-split optimizer updates (hot now, cold deferred).

Ports ``deepspeed_tpu/runtime/zenflow.py`` (``ZenFlowOptimizer`` :52,
``maybe_wrap_zenflow`` :117; reference ``runtime/zenflow/
zenflow_stage_1_and_2.py``) over the engines' flat buffers. Each step the
top ``topk_ratio`` coordinates of every leaf by |g| (the hot ones) take
the inner optimizer's update now; the rest (cold) add into a ``cold_acc``
moment, whose mean over the window joins the applied gradient every
``update_interval`` steps and is then dropped. The first
``full_warm_up_rounds`` steps apply the whole gradient (and drop
``cold_acc`` too). Warm-up and the boundary read the inner state's
step + 1, as JAX.

The hot mask is taken per leaf, never over the whole flat buffer and never
over the alignment pads between leaves: the engine binds one
:class:`Segment` a leaf (its place in the flat buffer, and for a leaf
sharded over ranks the gather that gives the whole leaf's |g|).
``k = max(1, int(n * topk_ratio))`` with n the whole leaf's size, and the
mask is ``|g| >= the k-th largest |g|``, so ties select more than k, as
``lax.top_k`` does in JAX; ``torch.topk`` picks the threshold, on the card
as on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch

from deepspeed_tpu_torch.ops.optimizer import TPUOptimizer


@dataclasses.dataclass
class Segment:
    """One leaf's part of a flat buffer: ``[start, start + n)``; ``gather``
    maps that part's |g| to the whole leaf's (None: the part is the whole
    leaf)."""
    start: int
    n: int
    gather: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


@dataclasses.dataclass
class ZenFlowOptimizer(TPUOptimizer):
    """Wraps a flat-buffer optimizer with hot/cold importance-split
    updates. ``bind`` must give the leaves' segments before the first
    update (the engines do)."""

    inner: Optional[TPUOptimizer] = None
    topk_ratio: float = 0.01
    update_interval: int = 4
    full_warm_up_rounds: int = 0

    def __post_init__(self):
        self.segments: List[Segment] = []
        if self.inner is not None:
            self.lr = self.inner.lr
            self.weight_decay = self.inner.weight_decay
            self.moment_names = tuple(self.inner.moment_names) + ("cold_acc",)

    def bind(self, segments: List[Segment]) -> None:
        self.segments = list(segments)

    def init(self, params: torch.Tensor):
        state = self.inner.init(params)
        state["cold_acc"] = torch.zeros_like(params)
        return state

    def hot_mask(self, g: torch.Tensor,
                 gather: Optional[Callable] = None) -> torch.Tensor:
        """Bool mask of the top ``topk_ratio`` of one leaf by |g| (JAX
        ``_hot_mask``); ``gather`` gives the whole leaf's |g| when ``g`` is
        a rank's shard of it."""
        a = g.abs()
        full = a.reshape(-1) if gather is None else gather(a.reshape(-1))
        if full.numel() == 0:
            return torch.ones_like(g, dtype=torch.bool)
        k = max(1, int(full.numel() * self.topk_ratio))
        threshold = torch.topk(full, k).values[-1]
        return a >= threshold

    def update(self, grads, state, params, lr=None, out=None):
        """One step on flat fp32 ``grads`` (overwritten with the applied
        gradient), ``state`` and ``params``, in place; ``out`` as the inner
        optimizer's."""
        return self._split_update(grads, state, params, lr, out,
                                  self.inner.update)

    def host_update(self, grads, state, params, lr=None, out=None,
                    clip=None, threads=None):
        """The host step's update: the clip applied to the whole gradient
        first (the split reads the clipped gradient), then the split and
        the inner optimizer's ``host_update``."""
        if clip is not None:
            grads.mul_(torch.tensor(clip, dtype=torch.float32))

        def inner(g, st, p, lr=None, out=None):
            return self.inner.host_update(g, st, p, lr=lr, out=out,
                                          threads=threads)

        return self._split_update(grads, state, params, lr, out, inner)

    def _split_update(self, grads, state, params, lr, out, inner_update):
        if not self.segments:
            raise RuntimeError("ZenFlowOptimizer.update: no segments bound "
                               "(the engine binds its leaves)")
        step = state["step"] + 1
        warm = step <= self.full_warm_up_rounds
        boundary = step % self.update_interval == 0
        acc = state["cold_acc"]
        if not warm:
            interval = torch.tensor(float(self.update_interval),
                                    dtype=torch.float32, device=acc.device)
            for seg in self.segments:
                g = grads[seg.start:seg.start + seg.n]
                a = acc[seg.start:seg.start + seg.n]
                hot = self.hot_mask(g, seg.gather).to(g.dtype)
                a.add_(g * (1.0 - hot))          # new_acc = acc + g (1 - hot)
                g.mul_(hot)                      # hot_g
                if boundary:
                    g.add_(a / interval)         # hot_g + new_acc / interval
        if warm or boundary:
            acc.zero_()
        inner = {k: v for k, v in state.items() if k != "cold_acc"}
        params, inner = inner_update(grads, inner, params, lr=lr, out=out)
        state.update(inner)
        return params, state


def maybe_wrap_zenflow(optimizer: TPUOptimizer, zcfg: Any) -> TPUOptimizer:
    if zcfg is None or not zcfg.enabled:
        return optimizer
    return ZenFlowOptimizer(
        inner=optimizer, topk_ratio=zcfg.topk_ratio,
        update_interval=zcfg.update_interval,
        full_warm_up_rounds=zcfg.full_warm_up_rounds)
