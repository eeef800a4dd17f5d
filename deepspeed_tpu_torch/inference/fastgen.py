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
  JAX package's fused ``lax.scan`` window, as a Python loop of eager ticks.

Host scheduling (tiers, rotation, backpressure, rollback, deadlines) is the
JAX package's, rule for rule, so greedy outputs match it token for token.
Not in this slice (they raise ``NotImplementedError``): planned serving
(``generate_all(planned=True)``, ``serve_planned``), ``decode_stream``,
tensor-parallel serving (``tp=True``) and weight-only-quantized params.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.inference.sampling import sample_logits
from deepspeed_tpu_torch.models import paged as PG
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.models.convert import tree_from_numpy

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
    for a CUDA device; ``False`` takes the plain versions of the kernels
    (the comparison path). ``params``: ``None`` initialises from ``seed``
    on the device; a :class:`~deepspeed_tpu_torch.models.paged.
    PagedTransformer`, or a nested dict of tensors/arrays under the JAX
    keys (floating leaves cast to the compute dtype)."""

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
        if tp:
            raise _later_slice("tensor-parallel FastGen serving (tp=True)")
        if isinstance(cfg, str):
            cfg = T.get_model_config(cfg, **overrides)
        T._check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
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
                                     device=self.device)
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
        self._setup_telemetry()
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        self._use_kernels = bool(use_kernels)

    def _resolve_params(self, params, seed: int) -> PG.PagedTransformer:
        cfg, dev = self.cfg, self.device
        if params is None:
            gen = torch.Generator(dev).manual_seed(seed)
            return PG.PagedTransformer(
                cfg, T.init_params(cfg, gen, dev, dtype=cfg.compute_dtype))
        if isinstance(params, PG.PagedTransformer):
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
        return PG.PagedTransformer(
            cfg, tree_from_numpy(tree, cfg.compute_dtype, dev))

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

    def _tick(self, tokens: torch.Tensor, positions: torch.Tensor,
              tables: torch.Tensor) -> torch.Tensor:
        """One forward + sampling on the device → sampled tokens [T] int32
        (still on the device)."""
        logits, _ = PG.forward_paged(self.params, tokens, positions, tables,
                                     self.pool, self.cfg,
                                     use_kernels=self._use_kernels)
        return sample_logits(logits, self._gen, self.temperature,
                             self.top_k, self.top_p).to(torch.int32)

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
        extras)."""
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
        mb, tables = self._decode_window_tensors(live, Bt, n)
        tokens = np.zeros((Bt,), np.int32)
        positions = np.zeros((Bt,), np.int32)
        for i, s in enumerate(live):
            tokens[i] = s.last_tok
            positions[i] = s.pos                    # pad rows → trash block 0

        key = ("dec", Bt, n, mb)
        cold = key not in self._seen_shapes
        self._seen_shapes.add(key)
        t0 = time.perf_counter()
        with telemetry.span("decode_window", ticks=n):
            toks = self._to_dev(tokens)
            pos = self._to_dev(positions)
            tbl = self._to_dev(tables[:, :mb])
            outs = []
            for _ in range(n):
                toks = self._tick(toks, pos, tbl)
                outs.append(toks)
                pos = pos + 1
            out = torch.stack(outs).cpu().numpy()   # [n, Bt]: one fetch
        if not cold:
            self._observe_tok_lat(
                (time.perf_counter() - t0) / (n * B), n=n * B)
        self._tm_ticks.inc(n, kind="decode", mb_tier=self._mb_tier_name(mb))
        self._tm_occup.set(B / Bt, phase="decode")
        self._tm_sched_gauges()
        return self._drain_decode_out(out, live, n)

    def _drain_decode_out(self, out, live, n: int) -> Dict[int, List[int]]:
        """Fold a window's [n, Bt] sampled tokens into host bookkeeping."""
        result: Dict[int, List[int]] = {}
        for i, s in enumerate(live):
            got: List[int] = []
            for t in range(n):
                tok = int(out[t, i])
                s.pos += 1          # this tick's input token entered the cache
                s.last_tok = tok
                before = len(s.generated)
                self._note_token(s, tok)
                if len(s.generated) > before:
                    got.append(tok)
                if s.done:
                    break           # post-EOS rows are garbage — discard
            result[s.uid] = got
        return result

    def decode_stream(self, window: int = 8):
        raise _later_slice("decode_stream")

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
        tables; returns (mb tier, tables [Bt, max_blocks])."""
        for s in live:
            self._ensure_blocks(s, s.pos + n - 1)
        mb_need = (max(s.pos for s in live) + n - 1) // self.block_size + 1
        mb = self._mb_tier(mb_need)
        tables = np.zeros((Bt, self.max_blocks_per_seq), np.int32)
        for i, s in enumerate(live):
            tables[i] = s.table
        return mb, tables

    # ------------------------------------------------------------------ #
    def put(self, uids: Sequence[int], prompts: Sequence[Sequence[int]],
            deadline_s: Optional[float] = None) -> None:
        """Admit sequences — host bookkeeping only. Prefill happens chunked
        inside subsequent ``step()`` ticks. ``deadline_s`` overrides the
        engine's ``request_deadline_s`` for this admission batch. The batch
        is validated whole before anything is admitted."""
        if deadline_s is None:
            deadline_s = self.request_deadline_s
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

        key = (Tn, mb)
        cold = key not in self._seen_shapes
        self._seen_shapes.add(key)
        t0 = time.perf_counter()
        with telemetry.span("decode_tick"):
            sampled = self._tick(self._to_dev(tokens),
                                 self._to_dev(positions),
                                 self._to_dev(tables[:, :mb]))
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

    def _note_token(self, seq: _Seq, tok: int) -> None:
        if seq.done:
            return
        # TTFT anchors on the first sampled token even when it's EOS
        self._tm_first_token(seq)
        if self.eos_token_id is not None and tok == self.eos_token_id:
            self._finish(seq)
            return
        seq.generated.append(tok)
        self._tm_gen_tok.inc()
        if seq.pos + 1 >= self.max_len:
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
