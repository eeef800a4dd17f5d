"""Paged attention: the CUDA kernels' wrapper and its plain PyTorch version.

Ports ``deepspeed_tpu/ops/pallas/paged_attention.py`` (``_kernel`` via
``paged_attention``) to the hand-written CUDA kernels in
``ops/csrc/paged_attention.cu``. Shapes (the JAX package's): q [T, N, D];
kpool/vpool [NB, bs, K, D]; tables [T, MB] int32; lengths [T] int32 (context
length per token, pos+1). GQA: query head n reads kv head n // (N/K).

:func:`paged_attention` runs the plain version for a tensor on the CPU and
launches the kernels for a tensor on a CUDA device — or raises; it never
falls back. On the card a tick's rows take two regimes, assigned by a
:class:`PagedPlan` that :func:`build_plan` makes on the device from the
tables alone, in one launch of a plan kernel (no host synchronisation):

* a run of at least ``MIN_RUN`` consecutive rows whose whole table rows are
  equal (a prompt's chunk, or the pad rows) is cut into tiles of up to
  ``TILE_ROWS`` rows; bf16 tiles go to the prefill kernel, which reads each
  KV tile once for all of a tile's rows on the tensor cores;
* every other row is a decode row: split-KV over ``SPLIT_SLOTS``-slot
  splits, whose fp32 partials the last split of a row to finish merges.

A row's output depends only on q[t], lengths[t] and its table row, so any
assignment of rows to regimes gives the same function. fp32 sends every row
through the decode kernel (no fp32 tensor-core kernel), and so does a bf16
tick of fewer than ``MIN_RUN`` rows, which holds no run: neither builds nor
reads a plan (:func:`uses_plan`). ``launches`` counts
wrapper calls (``"paged_attention"``) and each kernel's launches (decode,
prefill, plan).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import on_device
from deepspeed_tpu_torch.ops import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_REP = 8

#: cache slots one decode block covers (a split)
SPLIT_SLOTS = 128
#: rows a prefill tile holds at most (the kernel's 64 query-head rows)
TILE_ROWS = 64
#: rows of equal tables from which a run goes to the prefill kernel
MIN_RUN = 16
#: a cap on the decode grid's x, whose blocks walk the decode rows with
#: that stride (None: one block row a row). The host cannot tell a tick's
#: decode rows from its rows, so the grid's blocks past the decode rows
#: cost a prefill tick time, and a capped grid serialises a wide decode
#: tick: 32 came within 3.5 % of the best cap at a 256-row prefill tick and
#: at decode ticks of 32 and 64 rows (chip_smoke.py times phase,
#: ``decode_grid_rows``)
DECODE_GRID_ROWS: Optional[int] = 32

launches: Dict[str, int] = {"paged_attention": 0, "paged_attention_decode": 0,
                            "paged_attention_prefill": 0,
                            "paged_attention_plan": 0}


def paged_attention_reference(q: torch.Tensor, kpool: torch.Tensor,
                              vpool: torch.Tensor, tables: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """Gather + masked softmax (``deepspeed_tpu/models/paged.py:49``).

    Token t attends to its sequence's first ``lengths[t]`` cache slots. One
    intended difference from the JAX reference: a row of length 0 gives 0,
    as both kernels do (the JAX reference averages V over the masked row
    there; FastGen never produces such a row, lengths = pos + 1 >= 1)."""
    Tn, N, D = q.shape
    _, bs, K, _ = kpool.shape
    MB = tables.shape[1]
    idx = tables.long()
    kg = kpool[idx].reshape(Tn, MB * bs, K, D)           # [T, ctx, K, D]
    vg = vpool[idx].reshape(Tn, MB * bs, K, D)
    if K != N:
        kg = kg.repeat_interleave(N // K, dim=2)
        vg = vg.repeat_interleave(N // K, dim=2)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))   # fp32 1/sqrt(D)
    s = torch.einsum("tnd,tcnd->tnc", q.float(), kg.float()) * scale
    ctx = torch.arange(MB * bs, device=q.device)
    mask = ctx[None, None, :] < lengths.long()[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * (lengths > 0).float()[:, None, None]
    return torch.einsum("tnc,tcnd->tnd", p, vg.float()).to(q.dtype)


class PagedPlan:
    """Which rows of a tick go to which kernel: one int32 buffer on the
    device, ``dec_rows`` [T] (the decode rows in order, then zeros),
    ``n_dec`` [1], ``n_tiles`` [1], ``tile_start`` [TM] and ``tile_rows``
    [TM] (prefill tile x < n_tiles covers rows tile_start[x] ..
    + tile_rows[x]; zeros past n_tiles), then the plan kernel's scratch
    [2 T + 1]. TM = :func:`tile_slots` (T) bounds the tiles, so the host
    knows every size; the counts are read only by the kernels."""

    FIELDS = ("dec_rows", "n_dec", "n_tiles", "tile_start", "tile_rows")

    def __init__(self, buf: torch.Tensor, T: int):
        self.buf, self.T, self.TM = buf, T, tile_slots(T)

    @staticmethod
    def size(T: int) -> int:
        return 3 * T + 3 + 2 * tile_slots(T)

    def _view(self, lo: int, n: int) -> torch.Tensor:
        return self.buf[lo:lo + n]

    dec_rows = property(lambda self: self._view(0, self.T))
    n_dec = property(lambda self: self._view(self.T, 1))
    n_tiles = property(lambda self: self._view(self.T + 1, 1))
    tile_start = property(lambda self: self._view(self.T + 2, self.TM))
    tile_rows = property(lambda self: self._view(self.T + 2 + self.TM,
                                                 self.TM))

    def fields(self):
        return tuple(getattr(self, f) for f in self.FIELDS)


def tile_slots(T: int) -> int:
    """A bound on a plan's tiles: a run of n >= MIN_RUN rows makes
    ceil(n / TILE_ROWS) <= n // MIN_RUN tiles."""
    return max(1, T // MIN_RUN)


def uses_plan(dtype: torch.dtype, T: int) -> bool:
    """Whether a call of T rows launches the prefill kernel and so reads a
    plan: bf16 with at least ``MIN_RUN`` rows (fewer hold no run). Both are
    known on the host."""
    return dtype == torch.bfloat16 and T >= MIN_RUN


def prefill_blocks(rep: int) -> Tuple[int, int]:
    """(rows, blocks): a prefill block takes ``TILE_ROWS // rep`` rows of a
    tile with their rep heads (the kernel's 64 query-head rows), and
    ceil(TILE_ROWS / rows) blocks cover a tile at any rep (rep 3: 4 blocks
    of 21 rows) -- the kernel's ``pre_rows`` / ``pre_blocks``."""
    rows = TILE_ROWS // rep
    return rows, -(-TILE_ROWS // rows)


def build_plan_reference(tables: torch.Tensor) -> PagedPlan:
    """The plan of a tick with these tables [T, MB] int32, in tensor ops:
    rows t and t-1 are one run exactly when their whole table rows are
    equal. Lengths need not enter: each row's own length masks its own
    slots in either kernel. Entries past the counts are 0."""
    T = tables.shape[0]
    dev = tables.device
    idx = torch.arange(T, device=dev)
    start = torch.ones(T, dtype=torch.bool, device=dev)
    if T > 1:
        start[1:] = (tables[1:] != tables[:-1]).any(dim=1)
    run_id = start.long().cumsum(0) - 1
    run_len = torch.zeros(T, dtype=torch.long, device=dev).scatter_add_(
        0, run_id, torch.ones_like(run_id))[run_id]
    head = torch.where(start, idx, torch.zeros_like(idx)).cummax(0).values
    pos = idx - head                                    # row within its run
    prefill = run_len >= MIN_RUN
    tile_head = prefill & (pos % TILE_ROWS == 0)
    TM = tile_slots(T)

    def compact(flags, values, size):
        # values at the flagged rows, in order, into [size]; the rest land
        # in a dump slot past the end
        dst = torch.where(flags, flags.long().cumsum(0) - 1,
                          torch.full_like(idx, size))
        return torch.zeros(size + 1, dtype=torch.int32, device=dev).scatter_(
            0, dst, values.to(torch.int32))[:size]

    counts = torch.stack([(~prefill).sum(), tile_head.sum()]).to(torch.int32)
    return PagedPlan(torch.cat([
        compact(~prefill, idx, T), counts, compact(tile_head, idx, TM),
        compact(tile_head, (run_len - pos).clamp(max=TILE_ROWS), TM),
        torch.zeros(2 * T + 1, dtype=torch.int32, device=dev)]), T)


def build_plan(tables: torch.Tensor) -> PagedPlan:
    """:func:`build_plan_reference` on the CPU; on a GPU one launch of the
    plan kernel (one block), so a tick's plan costs one launch. ``tables``
    [T, MB] int32, contiguous."""
    if tables.device.type == "cpu":
        return build_plan_reference(tables)
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or not tables.is_contiguous():
        raise ValueError(f"build_plan: want tables [T, MB] int32 contiguous, "
                         f"got {tables.dtype} {tuple(tables.shape)}")
    T, MB = tables.shape
    plan = PagedPlan(torch.empty(PagedPlan.size(T), dtype=torch.int32,
                                 device=tables.device), T)
    if T == 0:
        return plan
    fn = _bind()["plan"]
    with on_device(tables.device):
        err = fn(tables.data_ptr(), plan.buf.data_ptr(), T, MB, plan.TM,
                 MIN_RUN, TILE_ROWS,
                 torch.cuda.current_stream(tables.device).cuda_stream)
    _launched("plan", err)
    return plan


def paged_attention_emulated(q: torch.Tensor, kpool: torch.Tensor,
                             vpool: torch.Tensor, tables: torch.Tensor,
                             lengths: torch.Tensor,
                             plan: PagedPlan) -> torch.Tensor:
    """What the kernels compute, in plain PyTorch and fp32, for the tests:
    decode rows by ``SPLIT_SLOTS``-slot splits whose (m, l, acc) partials
    merge as the decode kernel's last split does; each prefill tile's rows
    through the table row of the tile's first row, in an online softmax
    over 64-slot kv tiles, block by block as the kernel's grid splits the
    tile (:func:`prefill_blocks`). P stays fp32 (the bf16 prefill kernel
    rounds it for the tensor cores). A row that no block covers stays NaN."""
    Tn, N, D = q.shape
    _, bs, K, _ = kpool.shape
    MB = tables.shape[1]
    rep = N // K
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    qf = q.float()
    out = torch.full((Tn, N, D), float("nan"))
    lens = lengths.long().clamp(0, MB * bs).tolist()

    def kv(table_row, lo, hi):
        slots = torch.arange(lo, hi)
        blk = tables[table_row].long()[slots // bs]
        k = kpool[blk, slots % bs].float().repeat_interleave(rep, dim=1)
        v = vpool[blk, slots % bs].float().repeat_interleave(rep, dim=1)
        return k, v                                      # [n, N, D]

    def part(rows, table_row, lo, hi):
        """(m, l, acc) of rows [R] over slots lo..hi-1, masked per row."""
        if hi <= lo:                                     # an empty row
            return (torch.full((len(rows), N), NEG_INF),
                    torch.zeros(len(rows), N), torch.zeros(len(rows), N, D))
        k, v = kv(table_row, lo, hi)
        s = torch.einsum("rnd,cnd->rnc", qf[rows], k) * scale
        live = torch.arange(lo, hi)[None, :] < torch.tensor(
            [lens[r] for r in rows])[:, None]
        s = torch.where(live[:, None, :], s, torch.full_like(s, -np.inf))
        m = s.amax(-1).clamp(min=NEG_INF)                 # [R, N]
        p = torch.exp(s - m[..., None])
        return m, p.sum(-1), torch.einsum("rnc,cnd->rnd", p, v)

    def merge(parts):
        m = torch.stack([p[0] for p in parts])           # [S, R, N]
        e = torch.exp(m - m.amax(0))
        l = (torch.stack([p[1] for p in parts]) * e).sum(0)
        acc = (torch.stack([p[2] for p in parts]) * e[..., None]).sum(0)
        return acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]

    for t in plan.dec_rows[:int(plan.n_dec[0])].tolist():
        splits = range(max(1, -(-lens[t] // SPLIT_SLOTS)))
        out[t] = merge([part([t], t, s * SPLIT_SLOTS,
                             min(lens[t], (s + 1) * SPLIT_SLOTS))
                        for s in splits])[0]
    per, blocks = prefill_blocks(rep)
    for x in range(int(plan.n_tiles[0])):
        t0, n = int(plan.tile_start[x]), int(plan.tile_rows[x])
        for z in range(blocks):                          # the grid's z
            rows = list(range(t0 + z * per, t0 + min(n, (z + 1) * per)))
            if not rows:
                continue
            end = max(lens[r] for r in rows)
            tiles = [part(rows, t0, c0, min(end, c0 + 64))
                     for c0 in range(0, end, 64)] or [part(rows, t0, 0, 0)]
            out[rows] = merge(tiles)
    return out.to(q.dtype)


_fns: Dict[str, object] = {}   # the bound C entry points, at the first launch
#: the decode kernel's split counters [T * K] int32 per (device, stream):
#: zero between launches (the last split of a row resets its own), so a
#: captured CUDA graph finds them zero at every replay
_sems: Dict[tuple, torch.Tensor] = {}
#: counters outgrown by a wider tick: a graph captured with one still
#: holds its address, so it is never freed
_retired_sems: List[torch.Tensor] = []


def _bind():
    if not _fns:
        lib = build.load("paged_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        for name, args in (("attention", [P] * 9 + [I] * 11 + [P]),
                           ("plan", [P] * 2 + [I] * 5 + [P])):
            fn = getattr(lib, f"dstpu_paged_{name}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
            _fns[name] = fn
        if lib.dstpu_paged_tile_rows() != TILE_ROWS or any(
                lib.dstpu_paged_prefill_blocks(r) != prefill_blocks(r)[1]
                for r in range(1, _MAX_REP + 1)):
            raise RuntimeError("paged_attention: the prefill kernel's tile "
                               "differs from TILE_ROWS / prefill_blocks")
    return _fns


def _check(q, kpool, vpool, tables, lengths) -> None:
    dev = q.device
    for name, t in (("kpool", kpool), ("vpool", vpool), ("tables", tables),
                    ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on {dev}")
    if q.dim() != 3 or kpool.dim() != 4 or vpool.shape != kpool.shape:
        raise ValueError(
            f"paged_attention: want q [T, N, D] and pools [NB, bs, K, D], got "
            f"q {tuple(q.shape)}, kpool {tuple(kpool.shape)}, "
            f"vpool {tuple(vpool.shape)}")
    Tn, N, D = q.shape
    _, bs, K, D2 = kpool.shape
    if q.dtype not in _DTYPES or kpool.dtype != q.dtype \
            or vpool.dtype != q.dtype:
        raise TypeError(f"paged_attention: q/kpool/vpool must share one of "
                        f"float32/bfloat16, got {q.dtype}/{kpool.dtype}/"
                        f"{vpool.dtype}")
    if D != D2 or D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {D} (pool {D2}); the "
                         f"kernel takes D in {_HEAD_DIMS}")
    if N % K or N // K > _MAX_REP:
        raise ValueError(f"paged_attention: N={N} heads over K={K} kv heads; "
                         f"the kernel takes N/K integral and <= {_MAX_REP}")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != Tn or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (Tn,):
        raise ValueError(
            f"paged_attention: want tables [T, MB] int32 and lengths [T] "
            f"int32 with T={Tn}, got {tables.dtype} {tuple(tables.shape)} and "
            f"{lengths.dtype} {tuple(lengths.shape)}")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be 16-byte aligned")


def _check_plan(plan: PagedPlan, Tn: int, dev: torch.device) -> None:
    b = plan.buf
    if plan.T != Tn or b.device != dev or b.dtype != torch.int32 \
            or b.shape != (PagedPlan.size(Tn),):
        raise ValueError(
            f"paged_attention: want a plan of {Tn} rows on {dev} (build_plan "
            f"of these tables), got {plan.T} rows, {b.dtype} "
            f"{tuple(b.shape)} on {b.device}")


def paged_attention(q: torch.Tensor, kpool: torch.Tensor, vpool: torch.Tensor,
                    tables: torch.Tensor, lengths: torch.Tensor,
                    plan: Optional[PagedPlan] = None) -> torch.Tensor:
    """Drop-in for :func:`paged_attention_reference`: the plain version on
    the CPU (``plan`` unused), the CUDA kernels on a GPU. ``plan`` is
    :func:`build_plan` of these ``tables``, built once a tick by the
    caller; without one the call builds it when :func:`uses_plan` (bf16 and
    at least ``MIN_RUN`` rows), and ignores it otherwise."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, kpool, vpool, tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check(q, kpool, vpool, tables, lengths)
    Tn, N, D = q.shape
    _, bs, K, _ = kpool.shape
    MB = tables.shape[1]
    out = torch.empty_like(q)
    launches["paged_attention"] += 1
    if Tn == 0:
        return out
    planned = uses_plan(q.dtype, Tn)
    if planned:
        if plan is None:
            plan = build_plan(tables)
        _check_plan(plan, Tn, q.device)
    fn = _bind()["attention"]
    S = -(-MB * bs // SPLIT_SLOTS)
    # the partials of split rows: acc [T, N, S, D], then (m, l) [T, N, S]
    part = torch.empty(Tn * N * S * (D + 2), dtype=torch.float32,
                       device=q.device)
    # the C side launches on the calling thread's current device
    with on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        key = (q.device.index, stream)
        sem = _sems.get(key)
        if sem is None or sem.numel() < Tn * K:
            if sem is not None:
                _retired_sems.append(sem)
            sem = _sems[key] = torch.zeros(Tn * K, dtype=torch.int32,
                                           device=q.device)
        # no plan: every row a decode row
        err = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                 tables.data_ptr(), lengths.data_ptr(),
                 plan.buf.data_ptr() if planned else None, out.data_ptr(),
                 part.data_ptr(), sem.data_ptr(), Tn, N, K, D, bs, MB, S,
                 SPLIT_SLOTS, min(Tn, DECODE_GRID_ROWS or Tn), tile_slots(Tn),
                 _DTYPES[q.dtype], stream)
    _launched("decode", err)
    if planned:
        launches["paged_attention_prefill"] += 1
    return out


def _launched(kernel: str, err: int) -> None:
    if err:
        raise RuntimeError(f"paged_attention {kernel} kernel launch failed: "
                           f"cudaError {err}")
    launches[f"paged_attention_{kernel}"] += 1
