"""FastGen's ticks captured as CUDA graphs and replayed.

Parity: the JAX package compiles a SplitFuse tick once per shape
(``deepspeed_tpu/inference/fastgen.py`` ``_build_tick`` :371) and a window
of decode ticks into one ``lax.scan`` (``_build_decode_scan`` :389), both
cached in ``FastGenEngine._ticks``. On the card the counterpart of a
compiled tick is a captured ``torch.cuda.CUDAGraph``: :class:`TickGraph`
holds one tick of one shape — ``models/paged.forward_paged`` (L layers of
norms, projections, rotary, the in-place KV write, paged attention, the
FFN) and ``sample_logits`` — and a replay is one ``cudaGraphLaunch`` where
the eager tick made about a thousand kernel launches from a Python loop.

A decode graph ends by writing its sampled tokens into its own token buffer
and adding 1 to its positions, so a window of n decode ticks is n replays
of one graph: one tick is captured, not the window (a 64-tick window of
llama2_7b would be some 83k graph nodes for each key and rung).

Building a key runs, once:

1. a warm-up tick, eagerly, on the capture stream. Every row is a pad row
   (token 0, position 0, an all-zero table row), so it writes only the
   trash block 0 of the pool. It makes what a capture cannot make: the
   Triton JIT and the CUDA library's load, the kernels' shared-memory
   attributes, the paged-attention split counters of that stream, the rope
   table (copied from host memory) and cuBLAS's handle and workspace;
2. the capture, which records the kernels and runs none of them;
3. the instantiation.

Every graph of an engine shares one memory pool, so the graphs' activations
take about one tick's worth of memory. The KV pool and the parameters are
never reallocated: the graph holds their addresses.

The kernel wrappers count their launches in Python, which under a graph
runs only at the capture. So the capture's counts are taken back and kept
as the graph's ``launch_delta``, which every replay adds again: a counter
still counts the launches the card made.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import grouped_gemm as GG
from deepspeed_tpu_torch.ops import norms
from deepspeed_tpu_torch.ops import paged_attention as PA

#: the launch counters of the kernels a tick launches (the grouped GEMM:
#: an MoE model's experts)
TICK_COUNTERS = (PA.launches, norms.launches, GG.launches)

#: ``tick(tokens, positions, tables, generator) -> (logits, sampled)``
TickFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                   Optional[torch.Generator]],
                  Tuple[torch.Tensor, torch.Tensor]]


def _counts() -> Dict[Tuple[int, str], int]:
    return {(i, k): v for i, d in enumerate(TICK_COUNTERS)
            for k, v in d.items()}


def add_counts(delta: Dict[Tuple[int, str], int], times: int = 1) -> None:
    """Add ``times`` x a launch delta to the counters."""
    for (i, k), n in delta.items():
        TICK_COUNTERS[i][k] += n * times


def counted(fn: Callable[[], object]):
    """Run ``fn`` (a capture) and take back the launch counts it made →
    (its result, the counts as a delta), the counts taken back also when
    it raises."""
    before = _counts()
    try:
        out = fn()
    finally:
        delta = {k: n - before.get(k, 0) for k, n in _counts().items()
                 if n != before.get(k, 0)}
        add_counts(delta, -1)
    return out, delta


def warmup_inputs(rows: int, mb: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tokens, positions, tables) of a warm-up tick: every row a pad row
    (token 0 at position 0 through an all-zero table row), so the tick
    writes only the trash block 0 of the pool."""
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.zeros(rows, **i32), torch.zeros(rows, **i32),
            torch.zeros(rows, mb, **i32))


class TickGraph:
    """One tick of ``rows`` rows and a table width ``mb``, captured
    (:meth:`capture` builds one).

    Static inputs ``tokens`` [rows], ``positions`` [rows] and ``tables``
    [rows, mb] (int32, contiguous); static outputs ``logits`` [rows, V]
    (fp32) and ``sampled`` [rows] (int32). ``decode``: the tick then also
    writes ``sampled`` into ``tokens`` and adds 1 to ``positions``.
    ``launch_delta``: the kernel launches of one replay, by counter."""

    def __init__(self, graph, inputs, outputs, decode: bool,
                 launch_delta: Dict[Tuple[int, str], int],
                 seconds: Dict[str, float]):
        self.graph = graph
        self.tokens, self.positions, self.tables = inputs
        self.logits, self.sampled = outputs
        self.rows, self.mb = self.tables.shape
        self.decode = decode
        self.launch_delta = launch_delta
        self.seconds = seconds
        self.replays = 0
        # what the host last copied into each input (None: unknown, as
        # after a decode replay moved tokens and positions on the device)
        self._loaded: Dict[str, Optional[np.ndarray]] = {
            "tokens": None, "positions": None, "tables": None}

    @classmethod
    def capture(cls, tick: TickFn, rows: int, mb: int, device: torch.device,
                pool, stream: torch.cuda.Stream, decode: bool,
                generator: Optional[torch.Generator] = None) -> "TickGraph":
        """Warm up, capture and instantiate a tick. ``pool``: the engine's
        ``torch.cuda.graph_pool_handle()``, ``stream`` its capture stream.
        ``generator``: the engine's sampling generator, registered with the
        graph so that every replay draws from it (at temperature 0 the tick
        draws nothing and none is given; a capture that draws from a
        generator not registered raises). The warm-up draws from a
        generator of its own, so it leaves the engine's untouched."""
        seconds = {}
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            scratch = (torch.Generator(device).manual_seed(0)
                       if generator is not None else None)
            tick(*warmup_inputs(rows, mb, device), scratch)
        stream.synchronize()
        seconds["warmup_s"] = time.perf_counter() - t0

        inputs = warmup_inputs(rows, mb, device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None:
            graph.register_generator_state(generator)

        def record():
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                logits, sampled = tick(*inputs, generator)
                if decode:
                    inputs[0].copy_(sampled)
                    inputs[1].add_(1)
            return logits, sampled

        t0 = time.perf_counter()
        outputs, delta = counted(record)
        seconds["capture_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph.instantiate()
        seconds["instantiate_s"] = time.perf_counter() - t0
        return cls(graph, inputs, outputs, decode, delta, seconds)

    def load(self, tokens: Optional[np.ndarray] = None,
             positions: Optional[np.ndarray] = None,
             tables: Optional[np.ndarray] = None) -> None:
        """Copy host arrays into the static inputs, each only where it
        differs from what the host last copied there. The copies go through
        pinned memory and do not wait for the card."""
        for name, arr in (("tokens", tokens), ("positions", positions),
                          ("tables", tables)):
            if arr is None:
                continue
            last = self._loaded[name]
            if last is not None and np.array_equal(last, arr):
                continue
            arr = np.ascontiguousarray(arr, dtype=np.int32)
            getattr(self, name).copy_(torch.from_numpy(arr).pin_memory(),
                                      non_blocking=True)
            self._loaded[name] = arr.copy()

    def chain_from(self, other: "TickGraph") -> None:
        """Take the tokens and positions that another decode graph of the
        same rows left on the device (a device-to-device copy)."""
        self.tokens.copy_(other.tokens)
        self.positions.copy_(other.positions)
        self._loaded["tokens"] = self._loaded["positions"] = None

    def replay(self) -> None:
        """One ``cudaGraphLaunch`` of the tick, on the current stream."""
        self.graph.replay()
        add_counts(self.launch_delta)
        self.replays += 1
        if self.decode:
            self._loaded["tokens"] = self._loaded["positions"] = None

    def stats(self) -> Dict[str, object]:
        return {"rows": self.rows, "mb": self.mb, "decode": self.decode,
                **self.seconds, "replays": self.replays,
                "launches_per_replay": {k: n for (_, k), n in
                                        sorted(self.launch_delta.items())}}
