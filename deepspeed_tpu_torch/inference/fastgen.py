"""FastGen-class continuous batching: paged KV + Dynamic SplitFuse scheduling.

Parity: ``deepspeed_tpu/inference/fastgen.py`` (``BlockAllocator``, ``_Seq``,
``FastGenEngine``: ``put``/``step``/``decode_steps``/``query``/``flush``/
``generate_all``), itself the analog of the reference's
``inference/v2/engine_v2.py`` and its Dynamic SplitFuse scheduler.

* KV lives in a block pool ``[L, NB, bs, K, D]`` on the device; each
  sequence owns a host-side block table (``BlockAllocator`` free list,
  block 0 = pad trash).
* Every ``step()`` packs a token budget T: one decode token per running
  sequence plus prefill chunks of admitted prompts (long prompts split
  across ticks, short ones fused — Dynamic SplitFuse), padded to a tier.
* The tick (``models/paged.forward_paged``) embeds the flat tokens, writes
  K/V through the block tables into the pool in place, runs paged attention
  and the norms through their kernels (CUDA / Triton on the GPU, plain
  PyTorch on the CPU) and samples every row on the device; the host keeps
  only rows flagged as sequence heads.
* ``decode_steps`` runs ``n`` pure-decode ticks with the sampled tokens kept
  on the device and fetches the ``[n, B]`` tokens once at the end — the
  JAX package's fused ``lax.scan`` window; ``decode_stream`` chains such
  windows with one always in flight while the last one drains.
* On a CUDA device with the kernels, every tick replays a captured CUDA
  graph (``inference/graphs.TickGraph``), one per tick shape: the
  counterpart of the JAX package's jitted tick and decode scan, cached as
  its ``_ticks``. A key's first tick warms up, captures and instantiates
  its graph. The plain path (``use_kernels=False``) and the CPU run ticks
  eagerly, as the plain paged attention reads the lengths on the host.

Host scheduling (tiers, rotation, backpressure, rollback, deadlines) is the
JAX package's, rule for rule, so greedy outputs match it token for token.

Tensor-parallel serving (``tp``, JAX ``fastgen.py:145-199``): with a live
mesh whose ``tensor`` axis is above 1, ``tp=None`` or ``True`` serves on
it — every rank of the axis runs the same engine on the same requests,
holding its slices of the parameters and its ``kv_heads / T`` heads of the
pool (``models/paged.forward_paged``), and samples from the gathered
logits with the engine's generator (one seed on every rank), so every rank
emits the same tokens. An incompatible model (the KV or query heads, the
FFN or the vocab not divisible by the axis) raises under ``tp=True`` and
warns "serving replicated" under ``tp=None``; ``tp=False`` never engages.
Where JAX refuses its Pallas kernel under TP and serves with XLA
attention, the port runs its CUDA paged kernels on each rank's heads. The
ticks run eagerly, with the kernels: a CUDA graph cannot capture a gloo
collective, which copies through pinned host memory and synchronises
(``comm._gloo_via_pinned_host``), and NCCL will not put two ranks on one
device (``graph_stats()`` says so). Request deadlines are refused under TP:
each rank's host clock would expire a request on its own.

Not in this slice (they raise ``NotImplementedError``): planned serving
(``generate_all(planned=True)``, ``serve_planned``) and
weight-only-quantized params.
"""
from __future__ import annotations

import collections
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.comm import mesh as mesh_mod
from deepspeed_tpu_torch.inference.graphs import TickGraph
from deepspeed_tpu_torch.inference.sampling import sample_logits
from deepspeed_tpu_torch.models import paged as PG
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.models.convert import params_from_numpy

_QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate", "lm_head")


def _later_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not supported by deepspeed_tpu_torch yet; it comes in a "
        "later slice of the port")


class BlockAllocator:
    """Fixed-pool block allocator (reference ``blocked_allocator.py:1-105``).

    Block 0 is reserved as the trash block pad tokens write into."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(1, n_blocks))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def allocate(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: want {n} blocks, {len(self._free)} free")
        out, self._free = self._free[:n], self._free[n:]
        return out

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b:
                self._free.append(b)


class _Seq:
    """Host-side descriptor (reference ``sequence_descriptor.py``)."""

    def __init__(self, uid: int, prompt: List[int], max_blocks: int,
                 deadline_s: Optional[float] = None):
        self.uid = uid
        self.prompt = prompt
        self.prefilled = 0            # prompt tokens written to cache
        self.pos = 0                  # total tokens in cache
        self.blocks: List[int] = []   # block table (grows)
        self.table = np.zeros((max_blocks,), np.int32)
        self.generated: List[int] = []
        self.last_tok: Optional[int] = None   # next decode input
        self.done = False
        self.admit_t = time.perf_counter()    # TTFT anchor (telemetry)
        self.first_tok_seen = False
        # absolute expiry (perf_counter clock); None = no deadline
        self.deadline = (self.admit_t + deadline_s
                         if deadline_s is not None else None)
        self.expired = False

    @property
    def prefill_remaining(self) -> int:
        return len(self.prompt) - self.prefilled


class FastGenEngine:
    """``put/query/flush`` continuous-batching engine (engine_v2 analog).

    ``device``: ``None`` → the first CUDA device, raising without one;
    ``"cpu"`` runs the plain PyTorch path. ``use_kernels``: ``None`` → on
    for a CUDA device, where every tick then replays a captured CUDA graph
    (``inference/graphs.py``); ``False`` takes the plain versions of the
    kernels in eager ticks (the comparison path). ``params``: ``None``
    initialises from ``seed`` on the device; a :class:`~deepspeed_tpu_torch.
    models.paged.PagedTransformer`, or a nested dict of tensors/arrays
    under the JAX keys (floating leaves cast to the compute dtype), whole:
    under TP each rank keeps its slices. ``tp``: None engages a live
    mesh's ``tensor`` axis (and serves replicated, with a warning, a model
    the axis cannot cut), True raises for such a model, False never
    engages."""

    def __init__(self, cfg: Union[str, T.TransformerConfig],
                 params: Optional[Any] = None,
                 n_blocks: int = 128, block_size: int = 32,
                 max_blocks_per_seq: int = 16, token_budget: int = 64,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 use_kernels: Optional[bool] = None,
                 tp: Optional[bool] = None,
                 request_deadline_s: Optional[float] = None,
                 device=None, **overrides):
        if isinstance(cfg, str):
            cfg = T.get_model_config(cfg, **overrides)
        T._check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        #: this rank's place on a live mesh's tensor axis (None: the whole
        #: model here)
        self.tp = self._resolve_tp(tp)
        if self.tp is not None and request_deadline_s is not None:
            raise _later_slice("request deadlines under tensor-parallel "
                               "serving (each rank's clock would expire a "
                               "request on its own)")
        self.model = self._resolve_params(params, seed)
        self.params = self.model.tree()
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.token_budget = token_budget
        # cap at the model's position range: learned pos-emb gathers would
        # read past the table, so never let sequences grow past it
        self.max_len = min(block_size * max_blocks_per_seq, cfg.max_seq_len)
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.eos_token_id = eos_token_id
        # default per-request deadline (seconds from admission; None = no
        # deadline): expired requests are dropped at the next scheduling
        # tick. put() can override per request.
        self.request_deadline_s = request_deadline_s

        self.allocator = BlockAllocator(n_blocks)
        self.pool = PG.init_paged_kv(cfg, n_blocks, block_size,
                                     device=self.device, tp=self.tp)
        self.seqs: Dict[int, _Seq] = {}
        self._admit_order: List[int] = []
        self._decode_rr = 0
        # sampling noise for temperature > 0 (greedy draws nothing)
        self._gen = torch.Generator(self.device).manual_seed(seed)
        # tick shapes seen: a shape's first tick may build or JIT a kernel,
        # so its wall time is kept out of the latency accumulators
        self._seen_shapes: set = set()
        #: TTFTs (seconds, host-observed) of this engine's recent requests
        self.ttft_log: collections.deque = collections.deque(maxlen=4096)
        #: the ticks the device ran, by (how, rows): "eager", "warmup" (a
        #: graph's eager first tick, every row a pad row) or "replay"
        self.device_ticks: collections.Counter = collections.Counter()
        self._setup_telemetry()
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        self._use_kernels = bool(use_kernels)
        # ticks replay CUDA graphs on the card with the kernels; the
        # comparison of graph against eager ticks turns this off, and so
        # does TP (a graph cannot capture a gloo collective)
        self._graphs = (self.device.type == "cuda" and self._use_kernels
                        and self.tp is None)
        #: why the ticks run eagerly where graphs would replay (None: they
        #: replay, or the plain path runs)
        self.eager_reason = None
        if self.tp is not None and self.device.type == "cuda" \
                and self._use_kernels:
            self.eager_reason = (
                f"tensor-parallel ticks (tensor={self.tp.size}) run eagerly "
                "with the kernels: a CUDA graph cannot capture the gloo "
                "collectives (pinned-host copies and a host synchronisation)"
                ", and NCCL will not put two ranks on one device")
        self._tick_graphs: Dict[tuple, TickGraph] = {}
        self._graph_pool = self._graph_stream = None
        # a decode_stream window is in flight (see _assert_stream_drained)
        self._stream_inflight = False

    def _resolve_tp(self, tp: Optional[bool]):
        """JAX's ``tp`` (fastgen.py:145-199): a live mesh's tensor axis,
        unless ``tp`` is False; a model the axis cannot cut raises under
        ``tp=True`` and serves replicated, with a warning, under None. An
        MoE model is served replicated too (queue A.5: JAX's FastGen
        serves no MoE model, and the port's MoE serving is held at one
        process only), though training runs it under ``tensor``."""
        if tp is False or not mesh_mod.mesh_is_initialized():
            return None
        group = mesh_mod.get_mesh_manager().tensor()
        if group is None:
            return None
        what = T.check_tensor_parallel(self.cfg, group.size)
        if self.cfg.n_experts > 0:
            what = ["an MoE model (queue A.5)"] + what
        if not what:
            return group
        problem = f"mesh tensor={group.size} with {', '.join(what)}"
        if tp:
            raise NotImplementedError(f"FastGen TP: {problem} (queue A.4)")
        warnings.warn(f"FastGen TP disabled ({problem}); serving replicated")
        return None

    def _resolve_params(self, params, seed: int) -> PG.PagedTransformer:
        cfg, dev = self.cfg, self.device
        if params is None:
            gen = torch.Generator(dev).manual_seed(seed)
            tree = T.init_params(cfg, gen, dev, dtype=cfg.compute_dtype)
        elif isinstance(params, PG.PagedTransformer):
            tree = params.tree()
        elif isinstance(params, dict):
            tree = params
        else:
            raise TypeError(f"params: want a PagedTransformer or a dict, got "
                            f"{type(params).__name__}")
        blocks = tree.get("blocks", {})
        if any(isinstance(blocks.get(k), dict) or isinstance(tree.get(k), dict)
               for k in _QUANTIZABLE):
            raise _later_slice("weight-only-quantized params")
        return params_from_numpy(tree, cfg, dev, tp=self.tp)

    # ------------------------------------------------------------------ #
    # telemetry (the JAX package's fastgen_* metric catalog)
    # ------------------------------------------------------------------ #
    def _setup_telemetry(self) -> None:
        """Serving metrics on the process-wide registry; per tick a
        handful of dict updates plus an O(live-sequences) gauge sweep."""
        self._tm_ttft = telemetry.histogram(
            "fastgen_ttft_seconds",
            "admission (put) to first generated token, host-observed")
        self._tm_tok_lat = telemetry.histogram(
            "fastgen_decode_token_seconds",
            "per-token decode latency (window wall time / tokens)")
        # per-ENGINE accumulators behind est_token_seconds (the histogram
        # is process-global; two engines must not blend)
        self._tok_lat_sum = 0.0
        self._tok_lat_n = 0
        # sliding-window twin (ring of (interval, sum, n) over ~60s)
        self._tok_lat_win: collections.deque = collections.deque()
        self._tok_lat_win_interval_s = 10.0
        self._tok_lat_win_intervals = 6
        self._tm_ticks = telemetry.counter(
            "fastgen_ticks_total",
            "engine ticks by kind (mixed SplitFuse / fused decode) and "
            "block-table width tier")
        self._tm_gen_tok = telemetry.counter(
            "fastgen_generated_tokens_total", "tokens sampled and kept")
        self._tm_prefill_tok = telemetry.counter(
            "fastgen_prefill_tokens_total",
            "prompt tokens written into the KV cache")
        self._tm_preempt = telemetry.counter(
            "fastgen_preemptions_total",
            "sequences deferred a tick by KV-pool backpressure")
        self._tm_deadline = telemetry.counter(
            "fastgen_deadline_expired_total",
            "requests dropped past their deadline, by state at expiry "
            "(waiting=still prefilling, running=decoding)")
        self._tm_evict = telemetry.counter(
            "fastgen_evicted_blocks_total",
            "KV blocks released at sequence finish/flush")
        self._tm_finished = telemetry.counter(
            "fastgen_sequences_finished_total", "sequences that completed")
        self._tm_queue = telemetry.gauge(
            "fastgen_queue_depth",
            "live sequences by state (waiting=prefill pending, "
            "running=decoding)")
        self._tm_queue_peak = telemetry.gauge(
            "fastgen_queue_depth_peak", "high-water mark of live sequences")
        self._tm_occup = telemetry.gauge(
            "fastgen_batch_occupancy",
            "fraction of the tick's rows carrying real work")
        self._tm_kv = telemetry.gauge(
            "fastgen_kv_pool_utilization",
            "fraction of the KV block pool allocated")
        self._tm_kv_peak = telemetry.gauge(
            "fastgen_kv_pool_utilization_peak",
            "high-water mark of KV pool utilization")
        self._tm_kv_tier = telemetry.gauge(
            "fastgen_kv_blocks_in_use",
            "allocated KV blocks bucketed by the owning sequence's "
            "block-table width tier (quarter/half/full)")

    def _mb_tier_name(self, mb: int) -> str:
        quarter, half = self._mb_tier_bounds()
        return "quarter" if mb <= quarter else \
            "half" if mb <= half else "full"

    def _tm_sched_gauges(self) -> None:
        """Refresh queue/pool gauges from host scheduler state."""
        live = [s for s in self.seqs.values() if not s.done]
        waiting = sum(1 for s in live if s.prefill_remaining > 0)
        self._tm_queue.set(waiting, state="waiting")
        self._tm_queue.set(len(live) - waiting, state="running")
        self._tm_queue_peak.set_max(len(live))
        util = self.kv_utilization()
        self._tm_kv.set(util)
        self._tm_kv_peak.set_max(util)
        in_use = {"quarter": 0, "half": 0, "full": 0}
        for s in live:
            if s.blocks:
                in_use[self._mb_tier_name(len(s.blocks))] += len(s.blocks)
        for tier, n in in_use.items():
            self._tm_kv_tier.set(n, tier=tier)

    def _observe_tok_lat(self, per_token_s: float, n: int) -> None:
        """One funnel for every decode-latency observation: the global
        histogram and the per-engine accumulators."""
        self._tm_tok_lat.observe(per_token_s, n=n)
        self._tok_lat_sum += per_token_s * n
        self._tok_lat_n += n
        idx = int(time.perf_counter() // self._tok_lat_win_interval_s)
        ring = self._tok_lat_win
        if not ring or ring[-1][0] != idx:
            ring.append([idx, 0.0, 0])
        while ring and ring[0][0] <= idx - self._tok_lat_win_intervals:
            ring.popleft()
        ring[-1][1] += per_token_s * n
        ring[-1][2] += n

    def _tm_first_token(self, seq: _Seq) -> None:
        if not seq.first_tok_seen:
            seq.first_tok_seen = True
            ttft = time.perf_counter() - seq.admit_t
            self._tm_ttft.observe(ttft)
            self.ttft_log.append(ttft)

    # ------------------------------------------------------------------ #
    # tiers (one rule each, shared by every path)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _slot_tier(n_slots: int) -> int:
        """Pow2 slot-count tier (min 4) of a decode window."""
        ns = 4
        while ns < n_slots:
            ns *= 2
        return ns

    def _mb_tier_bounds(self):
        """(quarter, half) table-width tier bounds."""
        quarter = max(2, self.max_blocks_per_seq // 4)
        return quarter, max(quarter, self.max_blocks_per_seq // 2)

    def _mb_tier(self, mb_need: int) -> int:
        """Table-width tiers (quarter/half/full): the width of the tables a
        tick hands the attention kernel."""
        quarter, half = self._mb_tier_bounds()
        if mb_need <= quarter:
            return quarter
        if mb_need <= half:
            return half
        return self.max_blocks_per_seq

    def _bucket(self, need: int) -> int:
        """Two tick-size tiers (small for decode-heavy ticks, full budget
        otherwise)."""
        small = max(8, self.token_budget // 8)
        return small if need <= small else self.token_budget

    # ------------------------------------------------------------------ #
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _run_tick(self, tokens: torch.Tensor, positions: torch.Tensor,
                  tables: torch.Tensor,
                  generator: Optional[torch.Generator]):
        """Forward + sampling → (logits [T, V] fp32, sampled [T] int32),
        on the device: what a tick graph captures."""
        logits, _ = PG.forward_paged(self.params, tokens, positions, tables,
                                     self.pool, self.cfg,
                                     use_kernels=self._use_kernels,
                                     tp=self.tp)
        return logits, sample_logits(logits, generator, self.temperature,
                                     self.top_k, self.top_p).to(torch.int32)

    def _tick(self, tokens: torch.Tensor, positions: torch.Tensor,
              tables: torch.Tensor) -> torch.Tensor:
        """One eager tick → sampled tokens [T] int32 (still on the
        device)."""
        sampled = self._run_tick(tokens, positions, tables, self._gen)[1]
        self.device_ticks[("eager", tokens.shape[0])] += 1
        return sampled

    def _tick_graph(self, key: tuple, rows: int, mb: int,
                    decode: bool) -> TickGraph:
        """The key's graph, captured at its first use (the JAX package's
        ``_ticks`` cache). A capture that fails raises: nothing carries on
        eagerly."""
        g = self._tick_graphs.get(key)
        if g is None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._graph_stream = torch.cuda.Stream(self.device)
            g = TickGraph.capture(
                self._run_tick, rows, mb, self.device, self._graph_pool,
                self._graph_stream, decode,
                generator=self._gen if self.temperature > 0 else None)
            self._tick_graphs[key] = g
            self.device_ticks[("warmup", rows)] += 1
        return g

    def graph_stats(self) -> Dict[str, Dict[str, object]]:
        """Per captured key: rows, table width, warm-up, capture and
        instantiation seconds, replays, kernel launches a replay; under
        TP on the card, ``{"eager": {"reason": ...}}`` (no graph is
        captured)."""
        if self.eager_reason is not None:
            return {"eager": {"reason": self.eager_reason}}
        return {str(k): g.stats() for k, g in self._tick_graphs.items()}

    def _cold(self, key: tuple) -> bool:
        """Whether a tick of this key is its first (which may JIT a kernel)
        or captures its graph: its wall time stays out of the latency
        accumulators."""
        cold = key not in self._seen_shapes or (
            self._graphs and key not in self._tick_graphs)
        self._seen_shapes.add(key)
        return cold

    def _queue_tick(self, tokens: np.ndarray, positions: np.ndarray,
                    tables: np.ndarray) -> torch.Tensor:
        """One SplitFuse tick from host arrays (tables [T, mb]) → sampled
        tokens [T] int32 on the device: the (T, mb) graph replayed, or an
        eager tick."""
        if not self._graphs:
            return self._tick(self._to_dev(tokens), self._to_dev(positions),
                              self._to_dev(tables))
        rows, mb = tables.shape
        g = self._tick_graph((rows, mb), rows, mb, decode=False)
        g.load(tokens, positions, tables)
        g.replay()
        self.device_ticks[("replay", rows)] += 1
        return g.sampled

    def _queue_decode(self, chain, Bt: int, mb: int, n: int,
                      out: torch.Tensor, tokens: Optional[np.ndarray] = None,
                      positions: Optional[np.ndarray] = None,
                      tables: Optional[np.ndarray] = None):
        """Queue ``n`` pure-decode ticks of ``Bt`` rows at table width
        ``mb``; tick t's sampled tokens go to ``out[t]`` ([n, Bt] int32 on
        the device). Host ``tokens`` and ``positions`` start a chain;
        without them the window chains on what the last window (``chain``)
        left on the device. Host ``tables`` [Bt, mb] replace the chain's.
        Returns the chain for the next window: the ("dec", Bt, mb) graph,
        or the eager path's (tokens, positions, tables) tensors."""
        if self._graphs:
            g = self._tick_graph(("dec", Bt, mb), Bt, mb, decode=True)
            if tokens is not None:
                g.load(tokens=tokens, positions=positions)
            elif chain is not g:
                if tables is None:
                    raise ValueError("a decode window on another graph needs "
                                     "its tables")
                g.chain_from(chain)
            g.load(tables=tables)
            for t in range(n):
                g.replay()
                out[t].copy_(g.tokens)
            self.device_ticks[("replay", Bt)] += n
            return g
        toks, pos, tbl = chain if chain is not None else (None,) * 3
        if tokens is not None:
            toks, pos = self._to_dev(tokens), self._to_dev(positions)
        if tables is not None:
            tbl = self._to_dev(tables)
        for t in range(n):
            toks = self._tick(toks, pos, tbl)
            out[t].copy_(toks)
            pos = pos + 1
        return toks, pos, tbl

    def _blocks_needed(self, seq: _Seq, upto_pos: int) -> int:
        return max(0, upto_pos // self.block_size + 1 - len(seq.blocks))

    #: fused-decode window lengths — a fixed short ladder
    DECODE_TIERS = (64, 32, 8)

    def decode_steps(self, max_ticks: int,
                     allow_overshoot: bool = False) -> Dict[int, List[int]]:
        """Fused multi-tick decode for an all-decode state. Returns
        {uid: [tokens]} (EOS/max-len trimmed). Returns {} — caller falls
        back to :meth:`step` — when any live sequence still needs prefill
        or the pool/length headroom allows no ladder rung.

        ``allow_overshoot``: run the smallest ladder rung even when it
        exceeds ``max_ticks`` (callers with a fixed total budget trim the
        extras). On the card the window's n ticks are n replays of one
        decode graph."""
        self._assert_stream_drained()
        self._expire_deadlines()
        live = [self.seqs[u] for u in self._admit_order
                if u in self.seqs and not self.seqs[u].done]
        if not live or any(s.prefill_remaining > 0 or s.last_tok is None
                           for s in live):
            return {}
        if max_ticks < 1:
            return {}
        headroom = min(self.max_len - 1 - s.pos for s in live)

        def fits(tier):
            return tier <= headroom and sum(
                self._blocks_needed(s, s.pos + tier - 1)
                for s in live) <= self.allocator.free_blocks

        n = 0
        if allow_overshoot:
            # round UP to the smallest tier covering the remaining work
            for tier in reversed(self.DECODE_TIERS):
                if tier >= max_ticks and fits(tier):
                    n = tier
                    break
        if n < 1:
            n = self._fit_decode_tier(
                live, max_ticks if not allow_overshoot
                else max(max_ticks, self.DECODE_TIERS[-1]))
        if n < 1:
            return {}
        B = len(live)
        Bt = self._slot_tier(B)
        mb, tables, _ = self._decode_window_tensors(live, Bt, n)
        tokens, positions = self._decode_inputs(live, Bt)
        cold = self._cold(("dec", Bt, mb))
        t0 = time.perf_counter()
        with telemetry.span("decode_window", ticks=n):
            out = torch.empty((n, Bt), dtype=torch.int32, device=self.device)
            self._queue_decode(None, Bt, mb, n, out, tokens, positions,
                               tables[:, :mb])
            out = out.cpu().numpy()                 # [n, Bt]: one fetch
        if not cold:
            self._observe_tok_lat(
                (time.perf_counter() - t0) / (n * B), n=n * B)
        self._tm_ticks.inc(n, kind="decode", mb_tier=self._mb_tier_name(mb))
        self._tm_occup.set(B / Bt, phase="decode")
        self._tm_sched_gauges()
        return self._drain_decode_out(out, live, n, pos_advanced=False)

    @staticmethod
    def _decode_inputs(live: List[_Seq], Bt: int):
        """Host (tokens, positions) [Bt] of a decode window's first tick;
        pad rows are token 0 at position 0 (trash block 0)."""
        tokens = np.zeros((Bt,), np.int32)
        positions = np.zeros((Bt,), np.int32)
        for i, s in enumerate(live):
            tokens[i] = s.last_tok
            positions[i] = s.pos
        return tokens, positions

    def _drain_decode_out(self, out, live, n: int, pos_advanced: bool,
                          pos0: Optional[List[int]] = None
                          ) -> Dict[int, List[int]]:
        """Fold a window's [n, Bt] sampled tokens into host bookkeeping.
        ``pos_advanced``: decode_stream advances ``s.pos`` when it queues a
        window (the next window chains on the device before this one
        drains) and passes ``pos0``, each row's position before the window,
        so that the max-len cutoff applies at each tick's own position; the
        synchronous path advances ``s.pos`` here."""
        result: Dict[int, List[int]] = {}
        for i, s in enumerate(live):
            got: List[int] = []
            for t in range(n):
                tok = int(out[t, i])
                if not pos_advanced:
                    s.pos += 1      # this tick's input token entered the cache
                s.last_tok = tok
                before = len(s.generated)
                self._note_token(
                    s, tok, pos=None if pos0 is None else pos0[i] + t + 1)
                if len(s.generated) > before:
                    got.append(tok)
                if s.done:
                    break           # post-EOS rows are garbage — discard
            result[s.uid] = got
        return result

    def decode_stream(self, window: int = 8):
        """Generator of fused decode windows with ONE window always in
        flight: window N+1 is queued, chained on the tokens and positions
        window N left on the device, before N's tokens are fetched. Yields
        {uid: [tokens]} per drained window.

        On the card window N's tokens go to a pinned host buffer by a copy
        queued right after its ticks, and the host waits on that copy's
        event only; two buffers alternate. The tables are copied to the
        device only when a block was added or the width tier changed.

        The chain holds while the live set, slot tier and window tier are
        unchanged and no admission is pending; any change (EOS found at a
        drain, a new put(), block exhaustion, an expired deadline) drains
        the window in flight and the generator returns: callers re-enter
        after rescheduling. A sequence that hits EOS one window early costs
        at most one window of wasted ticks.

        If the caller breaks out (closing the generator), the window in
        flight is still drained into engine bookkeeping: those tokens are
        visible through ``query`` but were never yielded."""
        self._assert_stream_drained()   # a 2nd concurrent stream would
        # read the optimistic pos/stale last_tok and corrupt both chains
        pending = None          # (host tokens, copy event, live, n, pos0)
        dev_chain = None        # what the next window chains on
        tables_mb = None
        chain = None            # (tier Bt, n, live uids) the chain was built on
        bufs = None             # two (device out, host out, copy event)
        prev_drain_t = [None]   # drain-to-drain timing = steady-state rate
        cold = [False]          # a graph was captured since the last drain

        def drain(p):
            host, copied, p_live, p_n, p_pos0 = p
            if copied is not None:
                copied.synchronize()      # this window's copy, nothing else
            now = time.perf_counter()
            if prev_drain_t[0] is not None and not cold[0]:
                # with a window always in flight, drain-to-drain wall time
                # over the window's tokens IS the per-token serving rate
                self._observe_tok_lat(
                    (now - prev_drain_t[0]) / max(1, p_n * len(p_live)),
                    n=p_n * len(p_live))
            prev_drain_t[0] = now
            cold[0] = False
            return self._drain_decode_out(
                host.numpy(), p_live, p_n, pos_advanced=True, pos0=p_pos0)

        last = None
        k = 0
        try:
            while True:
                # deadline expiry changes the live set, which breaks the
                # chain below and drains — as a flush() mid-stream does
                self._expire_deadlines()
                live = [self.seqs[u] for u in self._admit_order
                        if u in self.seqs and not self.seqs[u].done]
                n = self._fit_decode_tier(live, window)
                Bt = self._slot_tier(len(live)) if live else 0
                key_now = (Bt, n, tuple(s.uid for s in live))
                if n < 1 or (chain is not None and key_now != chain):
                    break       # drain in-flight below; caller reschedules
                chain = key_now
                mb, tables, grew = self._decode_window_tensors(live, Bt, n)
                upload = None
                if tables_mb is None or grew or mb != tables_mb:
                    upload = tables[:, :mb]
                    tables_mb = mb
                start = (None, None)
                if dev_chain is None:
                    start = self._decode_inputs(live, Bt)
                if bufs is None:
                    bufs = self._stream_buffers(n, Bt)
                out, host, copied = bufs[k % 2]
                k += 1
                cold[0] |= self._cold(("dec", Bt, mb))
                pos0 = [s.pos for s in live]
                with telemetry.span("decode_window", ticks=n):
                    dev_chain = self._queue_decode(dev_chain, Bt, mb, n, out,
                                                   *start, tables=upload)
                    if copied is not None:
                        host.copy_(out, non_blocking=True)
                        copied.record()
                self._tm_ticks.inc(n, kind="decode",
                                   mb_tier=self._mb_tier_name(mb))
                self._tm_occup.set(len(live) / Bt, phase="decode")
                self._tm_sched_gauges()
                # the device is now computing THIS window; positions advance
                # now so the next iteration's block math is right
                for s in live:
                    s.pos += n
                prev, pending = pending, (host, copied, live, n, pos0)
                # while a window is in flight, s.pos is a window ahead of
                # s.last_tok: step()/decode_steps() would decode a stale
                # token at an advanced position, so they raise until drained
                self._stream_inflight = True
                if prev is not None:
                    yield drain(prev)
                    if any(s.done for s in prev[2]):
                        # EOS found late: the window in flight ran garbage
                        # for that row (bounded waste); drain it and end
                        res = drain(pending)
                        pending = None
                        self._stream_inflight = False
                        yield res
                        return
        finally:
            # the caller broke out (GeneratorExit) or the chain ended: the
            # window in flight MUST fold into host bookkeeping or
            # last_tok/pos go stale and later windows decode garbage
            if pending is not None:
                last = drain(pending)
                pending = None
            self._stream_inflight = False
        if last is not None:
            yield last

    def _stream_buffers(self, n: int, Bt: int):
        """decode_stream's two alternating (device out [n, Bt], host out,
        copy event): on the card the host buffers are pinned and an event
        marks each copy; on the CPU the device buffer is the host's."""
        i32 = dict(dtype=torch.int32)
        out = [torch.empty((n, Bt), device=self.device, **i32)
               for _ in range(2)]
        if self.device.type != "cuda":
            return [(o, o, None) for o in out]
        return [(o, torch.empty((n, Bt), pin_memory=True, **i32),
                 torch.cuda.Event()) for o in out]

    def serve_planned(self, *args, **kwargs):
        raise _later_slice("planned serving (serve_planned)")

    def _fit_decode_tier(self, live: List[_Seq], cap: int) -> int:
        """Largest DECODE_TIERS rung ≤ ``cap`` that fits every live row's
        length headroom and the allocator's free blocks."""
        if not live or any(s.prefill_remaining > 0 or s.last_tok is None
                           for s in live):
            return 0
        headroom = min(self.max_len - 1 - s.pos for s in live)
        for tier in self.DECODE_TIERS:
            if tier <= min(cap, headroom) and sum(
                    self._blocks_needed(s, s.pos + tier - 1)
                    for s in live) <= self.allocator.free_blocks:
                return tier
        return 0

    def _decode_window_tensors(self, live: List[_Seq], Bt: int, n: int):
        """Allocate blocks for an n-tick window and build the padded block
        tables; returns (mb tier, tables [Bt, max_blocks], grew: whether
        any table changed, so that a chained window knows the device's copy
        is stale)."""
        grew = False
        for s in live:
            before = len(s.blocks)
            self._ensure_blocks(s, s.pos + n - 1)
            grew |= len(s.blocks) != before
        mb_need = (max(s.pos for s in live) + n - 1) // self.block_size + 1
        mb = self._mb_tier(mb_need)
        tables = np.zeros((Bt, self.max_blocks_per_seq), np.int32)
        for i, s in enumerate(live):
            tables[i] = s.table
        return mb, tables, grew

    def _assert_stream_drained(self) -> None:
        """decode_stream misuse guard: while its window is in flight, s.pos
        is a window ahead of s.last_tok, so step(), decode_steps() or a
        second stream would decode a stale token at an advanced position.
        Exhaust or close() the stream first (closing drains the window).
        put() is not guarded: it is host bookkeeping only, and admission
        mid-stream ends the chain at its next window."""
        if self._stream_inflight:
            raise RuntimeError(
                "decode_stream window in flight — exhaust or close the "
                "stream before step()/decode_steps()/decode_stream()")

    # ------------------------------------------------------------------ #
    def put(self, uids: Sequence[int], prompts: Sequence[Sequence[int]],
            deadline_s: Optional[float] = None) -> None:
        """Admit sequences — host bookkeeping only. Prefill happens chunked
        inside subsequent ``step()`` ticks. ``deadline_s`` overrides the
        engine's ``request_deadline_s`` for this admission batch. The batch
        is validated whole before anything is admitted."""
        if deadline_s is None:
            deadline_s = self.request_deadline_s
        if deadline_s is not None and self.tp is not None:
            raise _later_slice("request deadlines under tensor-parallel "
                               "serving")
        batch = []
        seen = set()
        for uid, prompt in zip(uids, prompts):
            prompt = list(prompt)
            if uid in self.seqs or uid in seen:
                raise ValueError(
                    f"uid {uid} is still active — flush() it before re-use")
            if len(prompt) >= self.max_len:
                raise ValueError(
                    f"prompt len {len(prompt)} >= max_len {self.max_len}")
            seen.add(uid)
            batch.append((uid, prompt))
        for uid, prompt in batch:
            self.seqs[uid] = _Seq(uid, prompt, self.max_blocks_per_seq,
                                  deadline_s=deadline_s)
            self._admit_order.append(uid)
        self._tm_sched_gauges()

    def _expire_deadlines(self) -> int:
        """Drop live sequences past their deadline (blocks freed, marked
        done+expired)."""
        now = time.perf_counter()
        n = 0
        for seq in self.seqs.values():
            if seq.done or seq.deadline is None or now <= seq.deadline:
                continue
            state = "waiting" if seq.prefill_remaining > 0 else "running"
            seq.expired = True
            self._finish(seq)
            self._tm_deadline.inc(state=state)
            n += 1
        if n:
            self._tm_sched_gauges()
        return n

    def expired(self, uid: int) -> bool:
        """Whether ``uid`` was dropped by deadline expiry (False for unknown
        or flushed uids)."""
        seq = self.seqs.get(uid)
        return seq.expired if seq is not None else False

    def kv_utilization(self, extra_blocks: int = 0) -> float:
        """Fraction of the usable KV pool allocated (block 0 excluded);
        ``extra_blocks`` projects an admission's needs on top."""
        cap = max(1, self.allocator.n_blocks - 1)
        return (cap - self.allocator.free_blocks + extra_blocks) / cap

    def est_token_seconds(self) -> Optional[float]:
        """Mean per-token decode latency observed by this engine (None
        before the first warm tick), preferring the last ~60 s."""
        if self._tok_lat_n == 0:
            return None
        now_idx = int(time.perf_counter() // self._tok_lat_win_interval_s)
        win_sum = win_n = 0
        for idx, s, n in self._tok_lat_win:
            if idx > now_idx - self._tok_lat_win_intervals:
                win_sum += s
                win_n += n
        if win_n:
            return win_sum / win_n
        return self._tok_lat_sum / self._tok_lat_n

    def _snapshot_host(self, seqs) -> tuple:
        """Snapshot every scheduler-mutated host field of ``seqs`` plus the
        allocator free list (``generated`` is append-only within a tick, so
        its length suffices)."""
        return ({s.uid: (s.prefilled, s.pos, list(s.blocks), s.table.copy(),
                         len(s.generated), s.last_tok, s.done,
                         s.first_tok_seen)
                 for s in seqs},
                list(self.allocator._free))

    def _restore_host(self, snap: tuple) -> None:
        seq_snap, free = snap
        for u, st in seq_snap.items():
            s = self.seqs.get(u)
            if s is None:
                continue
            s.prefilled, s.pos = st[0], st[1]
            s.blocks, s.table = st[2], st[3]
            del s.generated[st[4]:]
            s.last_tok, s.done = st[5], st[6]
            s.first_tok_seen = st[7]
        self.allocator._free = free

    def _ensure_blocks(self, seq: _Seq, upto_pos: int) -> bool:
        """Grow the sequence's block table to cover ``upto_pos``. Returns
        False (per-seq state untouched) when the pool can't supply the
        blocks — the scheduler then defers that sequence."""
        need = upto_pos // self.block_size + 1
        grow = need - len(seq.blocks)
        if grow > self.allocator.free_blocks:
            return False
        for blk in self.allocator.allocate(max(grow, 0)):
            seq.table[len(seq.blocks)] = blk
            seq.blocks.append(blk)
        return True

    def step(self) -> Dict[int, int]:
        """One SplitFuse tick: decode every running sequence + prefill
        chunks under the token budget. Returns {uid: sampled token} for
        sequences that produced one this tick.

        Exception-safe: the scheduler advances host bookkeeping before the
        device call lands, so any failure mid-tick rolls all of it back
        before re-raising. A fault inside the device work itself may have
        written into the pool in place; that is a dead-device condition,
        not state this rollback can save."""
        self._assert_stream_drained()
        self._expire_deadlines()
        live = [self.seqs[u] for u in self._admit_order
                if u in self.seqs and not self.seqs[u].done]
        snap = self._snapshot_host(live)
        rr_snap = self._decode_rr
        try:
            return self._step_impl(live)
        except BaseException:
            self._restore_host(snap)
            self._decode_rr = rr_snap
            raise

    def _schedule_tick(self, live: List[_Seq]):
        """Host-side SplitFuse packing of one tick: (tokens [Tn], positions
        [Tn], tables [Tn, max_blocks], heads [(row, seq, is_decode)], rows
        used). Mutates scheduler state (prefill progress, blocks)."""
        need = sum(1 for s in live
                   if s.prefill_remaining == 0 and s.last_tok is not None)
        need += sum(s.prefill_remaining for s in live)
        Tn = self._bucket(need)
        tokens = np.zeros((Tn,), np.int32)
        positions = np.zeros((Tn,), np.int32)
        tables = np.zeros((Tn, self.max_blocks_per_seq), np.int32)
        heads: List[tuple] = []
        row = 0

        # 1) decode tokens — one per fully-prefilled live sequence, from a
        # rotating offset so tails never starve when live sequences exceed
        # the budget
        order = self._admit_order
        rr = self._decode_rr % max(len(order), 1)
        for uid in order[rr:] + order[:rr]:
            seq = self.seqs.get(uid)
            if seq is None or seq.done or seq.prefill_remaining > 0 \
                    or seq.last_tok is None:
                continue
            if row >= Tn:
                break
            if not self._ensure_blocks(seq, seq.pos):
                self._tm_preempt.inc(phase="decode")
                continue   # pool full — this sequence waits a tick
            tokens[row] = seq.last_tok
            positions[row] = seq.pos
            tables[row] = seq.table
            heads.append((row, seq, True))
            row += 1
        self._decode_rr += 1

        # 2) prefill chunks — FIFO admission, split to fit the remaining
        # budget (Dynamic SplitFuse: long prompts stream across ticks)
        for uid in self._admit_order:
            seq = self.seqs.get(uid)
            if seq is None or seq.done or seq.prefill_remaining == 0:
                continue
            if row >= Tn:
                break
            chunk = min(seq.prefill_remaining, Tn - row)
            # capacity backpressure: shrink the chunk to the blocks the
            # pool can supply; zero → the prompt waits for a flush
            fits = (len(seq.blocks) + self.allocator.free_blocks) \
                * self.block_size - seq.pos
            chunk = min(chunk, fits)
            if chunk <= 0:
                self._tm_preempt.inc(phase="prefill")
                continue
            self._ensure_blocks(seq, seq.pos + chunk - 1)
            lo = seq.prefilled
            tokens[row:row + chunk] = seq.prompt[lo:lo + chunk]
            positions[row:row + chunk] = np.arange(seq.pos, seq.pos + chunk)
            tables[row:row + chunk] = seq.table
            row += chunk
            seq.prefilled += chunk
            seq.pos += chunk
            if seq.prefill_remaining == 0:
                heads.append((row - 1, seq, False))  # first generated token
        return tokens, positions, tables, heads, row

    def _step_impl(self, live: List[_Seq]) -> Dict[int, int]:
        # host-side packing gets its own span: schedule (host) vs tick
        with telemetry.span("schedule_tick"):
            tokens, positions, tables, heads, row = self._schedule_tick(live)
        if row == 0:
            return {}
        Tn = tokens.shape[0]
        # table width tier: bounds the blocks a row can name
        mb_need = int(positions[:row].max()) // self.block_size + 1
        mb = self._mb_tier(mb_need)

        cold = self._cold((Tn, mb))
        t0 = time.perf_counter()
        with telemetry.span("decode_tick"):
            sampled = self._queue_tick(tokens, positions, tables[:, :mb])
            sampled = sampled.cpu().numpy()
        n_decode_rows = sum(1 for _, _, is_d in heads if is_d)
        if not cold and n_decode_rows:
            # tick wall time over decode rows (slightly over-counts when
            # prefill shares the tick — conservative for latency hints)
            self._observe_tok_lat(
                (time.perf_counter() - t0) / n_decode_rows,
                n=n_decode_rows)
        self._tm_ticks.inc(kind="mixed", mb_tier=self._mb_tier_name(mb))
        self._tm_prefill_tok.inc(row - n_decode_rows)
        self._tm_occup.set(row / Tn, phase="mixed")
        self._tm_sched_gauges()

        out: Dict[int, int] = {}
        for r, seq, is_decode in heads:
            tok = int(sampled[r])
            if is_decode:
                seq.pos += 1   # the decode input token entered the cache
            seq.last_tok = tok
            self._note_token(seq, tok)
            out[seq.uid] = tok
        return out

    def _note_token(self, seq: _Seq, tok: int,
                    pos: Optional[int] = None) -> None:
        """``pos``: the sequence's position at the tick that produced this
        token — decode_stream drains with ``seq.pos`` already a window or
        two ahead, so the max-len cutoff must use the tick's position."""
        if seq.done:
            return
        # TTFT anchors on the first sampled token even when it's EOS
        self._tm_first_token(seq)
        if self.eos_token_id is not None and tok == self.eos_token_id:
            self._finish(seq)
            return
        seq.generated.append(tok)
        self._tm_gen_tok.inc()
        if (seq.pos if pos is None else pos) + 1 >= self.max_len:
            self._finish(seq)

    def _finish(self, seq: _Seq) -> None:
        """Mark done and release KV blocks immediately (holding them until
        flush() would starve waiting prompts)."""
        seq.done = True
        if seq.blocks:
            self._tm_evict.inc(len(seq.blocks))
        self._tm_finished.inc()
        self.allocator.free(seq.blocks)
        seq.blocks = []
        seq.table[:] = 0

    def query(self, uid: int):
        d = self.seqs[uid]
        return d.done, list(d.generated)

    def rematerialize(self, uid: int) -> Optional[Dict[str, Any]]:
        """Host-side request snapshot for resubmission on another engine:
        the prompt, the tokens generated so far, and how much of the prompt
        was prefilled. None for unknown uids."""
        seq = self.seqs.get(uid)
        if seq is None:
            return None
        return {"prompt": list(seq.prompt),
                "generated": list(seq.generated),
                "prefilled": seq.prefilled}

    def flush(self, uids: Sequence[int]) -> None:
        for uid in uids:
            d = self.seqs.pop(uid, None)
            if d is not None:
                if d.blocks:
                    self._tm_evict.inc(len(d.blocks))
                self.allocator.free(d.blocks)
                d.blocks = []
                d.done = True
                if uid in self._admit_order:
                    self._admit_order.remove(uid)
        self._tm_sched_gauges()

    # ------------------------------------------------------------------ #
    def generate_all(self, uids, prompts, max_new_tokens: int = 32,
                     planned: Optional[bool] = None):
        """Convenience driver: put + serve with SplitFuse ticks for prefill
        and fused decode windows for pure-decode phases; returns {uid:
        tokens} and flushes. ``planned=True`` (one-dispatch planned
        serving) comes in a later slice; ``None`` means dynamic here."""
        if planned:
            raise _later_slice("generate_all(planned=True)")
        self.put(uids, prompts)
        self._generate_dynamic(uids, max_new_tokens)
        out = {u: self.query(u)[1][:max_new_tokens] for u in uids}
        self.flush(uids)
        return out

    def _generate_dynamic(self, uids, max_new_tokens: int) -> None:
        while True:
            for u in uids:
                s = self.seqs.get(u)
                if s and not s.done and len(s.generated) >= max_new_tokens:
                    self._finish(s)
            live = [self.seqs[u] for u in uids
                    if u in self.seqs and not self.seqs[u].done]
            if not live:
                break
            # max (not min) remaining: sequences that hit max_new mid-window
            # keep decoding into their own blocks and get trimmed above
            remaining = max(max_new_tokens - len(s.generated) for s in live)
            got = self.decode_steps(remaining, allow_overshoot=True) \
                if remaining > 0 else {}
            if got:
                continue
            out = self.step()
            if not out and not any(
                    s.prefill_remaining > 0 and not s.done
                    for s in self.seqs.values()):
                break  # stalled: no tokens and nothing left to prefill
