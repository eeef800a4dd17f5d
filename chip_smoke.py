#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

Drives the port's serving and training paths on the card and holds every
kernel on them against its plain PyTorch version:

1. card      — nvidia-smi name and power limit, torch device name and count;
2. build     — nvcc builds of ``ops/csrc/*.cu`` (one process per source,
               started together) and Triton's first compile, timed; each
               flash, block-sparse, grouped-GEMM, Evoformer and paged-
               attention instantiation's registers, spills and shared
               memory on a line of its own, and its SASS: the bf16
               attention kernels (paged prefill too) hold bf16 HMMA (fp32
               sums) and LDGSTS (cp.async), the paged decode kernels
               LDGSTS, the bf16 grouped GEMM bf16 HGMMA (wgmma, fp32 sums),
               the fp32 kernels neither HMMA nor HGMMA; the host library
               of the host-executed step (``ops/csrc/cpu_adam.cpp``, g++
               -O3 -march=native -ffp-contract=off), its seconds and flags;
3. kernels   — paged attention (the three main-path shapes and PA_TICKS:
               prefill runs, mixed ticks, GQA with a chunk, a shared
               prefix, interleaved rows, unordered lengths, 2048-slot
               contexts; the plan kernel bit-equal to its plain version;
               bf16 prefill rows by FLASH_BF16_RULE), RMSNorm/LayerNorm,
               flash attention
               (forward, dq, dkv), fused Adam, the grouped GEMM (gmm, gmm
               with the rhs transposed, tgmm), block-sparse attention
               (forward, dq, dkv) and the Evoformer forward against their
               plain versions, bf16 and fp32, at the main-path shapes and
               edge cases (unaligned S, GQA, non-causal; ragged groups, an
               empty group, moe_1b's width; sparse layouts with an inactive
               row; a dense layout against flash; Evoformer at OpenFold's
               widths, D 8, a masked row, unaligned S); the bf16 flash,
               block-sparse and Evoformer outputs by FLASH_BF16_RULE's
               relative-L2 rule (the tensor cores take P and dS in bf16);
4. llama2_7b — ``FastGenEngine`` at full width and depth (random weights
               from a seed, bf16) serves 8 requests through ``generate_all``,
               every tick a replay of a captured CUDA graph; launch counters
               prove every tick went through the kernels (one plan, L paged
               decode and L paged prefill launches a tick; a replay counts
               its capture's launches, a key's warm-up tick its own); the
               graph gates: G1 a 32-tick decode window and a SplitFuse tick
               of >= 16 rows, graphs against eager ticks from one state
               (tokens equal, logits bit-equal); G2 a capture changes no KV
               block but the trash block 0; G3 decode_stream against
               decode_steps; G4 parameters and pool never move, one capture
               a key; G5 sampling at temperature 0.8 through the graphs,
               one seed giving one stream of tokens; one mixed tick's plan
               has rows in both regimes, and its logits on the kernel path
               vs the plain path;
5. gpt2_125m — the LayerNorm / learned-position / GELU path, same checks;
5b. moe_350m — the MoE model at full size (4 experts, top-2, the dropless
               dispatch over each tick's rows, 2 gmm launches a layer and
               tick), the same checks, then its decode rate and TTFT;
6. train_gpt2_125m  — ``initialize`` + ``train_batch`` at the repo's
               headline training settings (micro 32, seq 1024, gas 4, bf16,
               ZeRO-1, flash attention, remat full, Adam lr 1e-4), full
               width and depth, a fixed batch: the loss falls, the counters
               prove every step launched flash fwd/dq/dkv, fused Adam and the
               norms; one step kernel path vs plain path in fp32, and bf16 no
               further from that fp32 reference than the plain bf16 path;
7. train_llama_750m — the same at micro 4, seq 2048, gas 4 (RMSNorm, RoPE,
               SwiGLU, head_dim 128);
8. train_moe_350m — the same at micro 16, seq 1024, gas 4 for the MoE
               model (4 experts, top-2, dropless): the counters prove every
               step launched gmm 288 times and tgmm 96 times; the step gate
               adds the routing agreement and the aux loss;
9. train_llama_750m_sparse — llama_750m's run with
               ``attention="sparse:fixed"`` (block-sparse attention, block
               64, the causal fixed layout): the counters prove every step
               launched the block-sparse forward 160 times and dq, dkv 80
               times each, and flash attention never;
10. evoformer — ``msa_row_attention_with_pair_bias`` at OpenFold's
               Evoformer widths (MSA [128, 256, 256], 8 heads of 32, pair
               bias [8, 256, 256], gated), forward and backward on the card
               through the Evoformer kernel, held against the plain path;
11. train_llama_750m_zeropp_dp2 — two ranks (spawned processes, gloo, both
               on the one card by explicit device) train llama_750m at full
               width and depth with ZeRO-2 + qgZ + qwZ + LoCo (the repo's
               zero2_qgz_llama_750m_bf16 row: micro 4 a rank, seq 2048, gas
               4, bf16, flash, remat full, Adam): the loss falls, the
               counters prove every step launched the int8 quantize and
               dequant-reduce kernels; four gates (the wire bit-exact on the
               step's real packed gradient; one fp32 step all kernels vs all
               plain within a tenth of the wire's own noise; bf16 no further
               from it than twice the plain bf16 path; the int8 error within
               half a quantization step a rank); then exact ZeRO-2 at world
               2 as the baseline, with overlap_comm and overlap_step (the
               defaults: each layer chunk's gradient reduced when its
               backward is done, the other leaves by reduce_bucket_size
               buckets, the update and its publish by update_bucket_size
               buckets; the reduces and publishes a step by formula), and
               once more with the once-a-step reduce; one fp32 step of
               each from one master by the training rule;
12. train_llama_750m_zero3_dp2 — the same two ranks train llama_750m at
               full width, ZERO3_LAYERS of its 20 layers, with ZeRO-3 (the
               repo's zero3_llama_750m_bf16 row, overlap_comm on: 8 layer
               chunks of JAX's plan, each gathered where the forward and
               the recompute use it, the next in flight): (a) exact, (b) +
               qgZ + qwZ + LoCo, (c) exact ZeRO-2 at the same depth: step,
               tokens/s, MFU, peak a rank, the wire's host
               waits with the prefetch on and off; gates Z1 (one fp32 step
               ZeRO-3 vs ZeRO-2 at 4 layers, full width, by the training
               rule), Z2 (bf16: the loss within 1e-5, the update no
               further from fp32 than 2x ZeRO-2's), Z3 (each chunk's qwZ
               gather within half a step of the exact gather; the zeropp
               wire gate on (b)), Z4 ((a)'s peak >= 3 GB x layers / 20
               below (c)'s), Z5
               (the launches and the 17 gathers a micro-batch); then ZeRO-3
               for a spec without the parameter hook (a 4-layer MLP at width
               4096, fp32, built here) at world 2 against the same spec at
               world 1 without ZeRO by the training rule;
13. train_llama_750m_hpz_dp4 — four ranks (mesh data 2 x zshard 2, rank
               r at data r // 2, zshard r % 2) train llama_750m at full
               width, HPZ_LAYERS of its 20 layers, at the
               zero3_llama_750m_bf16 row's settings:
               (a) the ZeRO++ trio, ZeRO-3 + hpZ (zero_hpz_partition_size
               2) + qwZ + qgZ, (b) MiCS at stage 3 (mics_shard_size 2,
               exact): step, tokens/s, MFU, each rank's peak and their sum
               against the card's memory, the host seconds in each
               group's collectives; gates H1 (one fp32 step of hpZ ZeRO-3
               and of hpZ ZeRO-2 against the same step at data = 4, 4
               layers, by the training rule), H2 (bf16: the first loss
               bit-equal to data = 4's, the update no further from fp32
               than 2x), H3 (the step's real reduced shard through the
               replica hop: its quantize and dequant-reduce kernels
               bit-equal to their plain versions, the int8 two-hop mean
               within half a step a hop of the exact one), H4 (each
               group's collectives and elements a step by formula: no
               parameter gather on the data group, which carries the
               replica hop only), H5 (the launches and gathers a step);
13b. train_moe_350m_ep — moe_350m over the expert axis (MOE_EP,
               MOE_EP_B): (a) two ranks at mesh {expert: 2}, full width and
               depth, each holding 2 of the 4 experts, the choices sent to
               their expert's rank by all-to-all; (b) four ranks at mesh
               {data: 2, expert: 2}, 4 layers; gates E1-E5 (the fp32 step
               by the training rule against the same ranks without the
               expert axis, and against one process; bf16 within 2x the
               plain bf16 path; the grouped GEMM on a rank's received
               buffer; the all-to-alls and the aux loss's means a step by
               formula, nothing dropped); step, tokens/s, MFU by active
               parameters, peak a rank, the expert group's host seconds,
               the idle share;
14. quantized_reduce_scatter — the entry point at world 2 and 4 (ranks on
               the one card), 2^26 fp32 a rank: kernels vs plain bit-equal,
               the error against the exact mean within the bound, the ranks'
               chunks concatenating to the whole reduction;
15. train_llama2_7b_super_offload — the host's facts (MemAvailable, cores,
               threads, the NVMe directory's disk), then llama2_7b at full
               width under SuperOffload (the fp32 master and Adam's moments
               in host memory, the update on the host's cores; bf16, flash,
               remat full, micro 2, seq 2048, gas 4) at the depth the
               host's memory holds: gates S1 (one fp32 host step, overlap
               off, against the device path: loss bit-equal, master within
               1e-6), S2 (bf16: the update no further from S1's than 2x
               the device bf16 step's), S3 (the overlap schedule's losses)
               at 4 layers; then 3 steps with overlap and 2 without, the
               update in the compiled host library: step time, tokens/s,
               MFU, the card's idle share, the host update's seconds and
               GB/s against the host copy rate, the copies' GB/s, device
               peak, pinned bytes, host RSS, the flash and norm launches
               and the library's calls; S0 on a 64 M-element slice of the
               step's real gradient, master and moments: the library
               bit-equal to the CUDA fused-Adam kernel, m and v bit-equal
               to fused_adam_ref (p off only where PyTorch's CPU sqrt is),
               the norm's sum the same at 1 thread and at all;
16. train_llama_750m_offload — llama_750m at its training shape with
               (a) offload_optimizer cpu, (b) nvme, each bit-equal to the
               run without offload, (c) ZenFlow (top 1 %, a boundary every
               2 steps) and its kernels-vs-plain step at 4 layers by the
               training rule, (d) ZeRO-3 at world 1 on a spawned rank with
               offload_param cpu and nvme at 8 layers in JAX's in-step
               streaming mode (the master off the card through the step,
               streamed a chunk at a time): bit-equal, the peak of the
               forward and backward and of the step, the streamed pass's
               GB/s; and the int8 wire at world 2 (two ranks), which keeps
               the boundary swap, bit-equal;
17. times    — kernels vs plain vs library calls vs their bounds (CUDA
               events; paged attention at a decode, a prefill and a mixed
               tick, each kernel's own time by the profiler, and the plan
               kernel), decode tokens/s, device ms, idle share, kernels and
               CUDA runtime calls a tick with graphs against eager ticks
               from one state, decode_stream's rate, TTFT, each graph key's
               capture cost, the norm and paged-decode kernels' device time
               a launch inside the graph, training step time, tokens/s,
               MFU (active parameters), idle share, the profiler's split of
               a step, peak memory. It times what the phases before it ran:
               the serving, Adam and grouped-GEMM rows need their phases.

Prints one JSON line per phase, then the nvidia-smi line, then the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero without the last line. It needs one CUDA device
and the repository beside it, and does not import jax.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases card,build,kernels
    python3 chip_smoke.py --phases card,build,kernels,train_llama_750m_sparse,evoformer,times
    python3 chip_smoke.py --phases card,build,kernels,train_moe_350m,evoformer,times
    python3 chip_smoke.py --phases card,build,kernels,train_llama_750m_zeropp_dp2,quantized_reduce_scatter,times
    python3 chip_smoke.py --phases card,build,kernels,train_llama_750m_zeropp_dp2,train_llama_750m_zero3_dp2,times
    python3 chip_smoke.py --phases card,build,kernels,train_llama_750m_hpz_dp4,times
    python3 chip_smoke.py --phases card,build,train_moe_350m_ep,moe_350m
    python3 chip_smoke.py --phases card,build,kernels,llama2_7b,gpt2_125m,times
    python3 chip_smoke.py --phases card,build,train_llama2_7b_super_offload,train_llama_750m_offload

The whole run takes the phases in PHASES order: the data-parallel phases
(11-14, 13b among them) and the offload phases (15-16) run right after the
kernels phase,
before the serving phases' engines take the card. Wire times of the
data-parallel phases are gloo's through host memory, the ranks sharing
one card: not NVLink's.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
# The data-parallel phases run before the serving phases, whose engines
# the parent holds until `times` (~23 GB beside two ranks' engines did not
# fit 80 GB); so do the offload phases (llama2_7b under SuperOffload needs
# the empty card).
PHASES = ("card", "build", "kernels", "train_llama_750m_zeropp_dp2",
          "train_llama_750m_zero3_dp2", "train_llama_750m_hpz_dp4",
          "train_moe_350m_ep", "quantized_reduce_scatter",
          "train_llama2_7b_super_offload", "train_llama_750m_offload",
          "llama2_7b", "gpt2_125m", "moe_350m", "train_gpt2_125m",
          "train_llama_750m", "train_moe_350m", "train_llama_750m_sparse",
          "evoformer", "times")

# Tolerances of a kernel against its plain version on the same inputs.
# fp32: both compute in fp32 and differ only in summation order (a few ulp
# of O(1) values). bf16: both compute in fp32 and round the output to bf16
# once, so they may differ by one bf16 ulp (2^-7 relative) where the fp32
# values straddle a rounding boundary.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-3, 2.0 ** -7)}   # atol, rtol
# One mixed tick of the whole model, kernel path vs plain path, on the
# main path's parameters and pool. In fp32 (the same weights upcast, exact)
# the kernels must give the plain path's logits: max|Δlogit| / max|logit|
# over the real rows within LOGIT_REL_TOL_FP32 (ulp-level differences
# carried through every layer) and the same argmax on TOP1_MIN of the rows.
# In bf16 a random-weight model turns one-ulp differences into logit
# noise of a few percent (4 % and 92 % top-1 agreement between two bf16
# paths of llama2_7b, measured on an NVIDIA H100 80GB HBM3 at 700 W), so
# there the kernel path is held against the fp32 reference instead: no
# more than BF16_VS_PLAIN times as far from it as the plain bf16 path, and
# its top-1 agreement with it at most BF16_TOP1_SLACK below the plain
# path's.
# Flash attention against its plain version: both sum in fp32, over up to
# S = 2048 keys and (dk, dv) rep x S queries, in other orders; the absolute
# error grows with the number of terms, so fp32 gets 1e-4 where one
# row-wise kernel gets 1e-5. bf16 adds one rounding of the output (2^-7).
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-3, 2.0 ** -7)}
# The bf16 kernels run every product on the tensor cores and so round P
# (forward, dv) and dS (dq, dk) to bf16 before it enters them, where the
# plain version keeps both fp32: each term moves by up to 2^-8 of itself,
# and where a sum of large terms cancels, the output moves by more than one
# bf16 ulp of itself. Measured on an NVIDIA H100 80GB HBM3 at 700 W, tens
# to a thousand elements of o, dq, dk and dv lie outside FLASH_TOL
# ["bfloat16"] at the main-path shapes. So each bf16 output of flash and
# block-sparse attention (FLASH_BF16_RULE) is held to the fp32 reference —
# the plain version on the fp32 upcast of the same inputs — instead: its
# relative L2 distance from it at most BF16_VS_PLAIN times the plain bf16
# path's (whose only error is the rounding of its output), or the fp32
# rtol, whichever is larger. Two independent roundings of the same size
# give sqrt(2); measured 1.20-1.43. lse (fp32 in both) and every fp32
# output keep FLASH_TOL.
FLASH_BF16_RULE = ("o", "dq", "dk", "dv")
# (label, B, S, N, K, D, causal): the training main-path shapes (the first
# three are timed), llama2_7b's under super_offload, then edges
FLASH_CASES = (("gpt2_125m", 32, 1024, 12, 12, 64, True),
               ("llama_750m", 4, 2048, 12, 12, 128, True),
               ("moe_350m", 16, 1024, 12, 12, 64, True),
               ("llama2_7b_train", 2, 2048, 32, 32, 128, True),
               ("unaligned_d64", 2, 1000, 4, 4, 64, True),
               ("unaligned_d128", 2, 1000, 4, 2, 128, True),
               ("gqa", 2, 512, 32, 8, 128, True),
               ("full_d64", 2, 512, 4, 4, 64, False),
               ("full_d128_unaligned", 1, 300, 4, 2, 128, False))
# Grouped GEMM against its plain version: both sum exact products in fp32,
# over up to K = 3072 terms (gmm) and a whole group's rows (tgmm, ~16k), in
# other orders, so fp32 gets flash attention's 1e-4 on outputs of O(1)
# (the inputs are scaled so); bf16 adds one rounding of the output (2^-7).
GMM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-3, 2.0 ** -7)}
# (label, M, K, N, E, tail): moe_350m's up and down projections (micro 16 x
# seq 1024 x top-2 rows), moe_1b's expert shape (bench.py moe_1b_large_
# experts) and a ragged case whose widths and group sizes are no multiples
# of the tiles and whose last `tail` rows lie past the groups. Group sizes:
# a fixed uneven split with group 1 empty (see gmm_sizes).
GMM_CASES = (("moe_350m_up", 32768, 768, 3072, 4, 0),
             ("moe_350m_down", 32768, 3072, 768, 4, 0),
             ("moe_1b_up", 32768, 1536, 6144, 8, 0),
             ("ragged", 1000, 264, 200, 8, 24))
# (kind, H, rows): the serving sizes (a decode tick to a prefill chunk),
# then the training main paths', micro x seq rows (llama2_7b's 4096 under
# super_offload; llama_750m's H 1536 is a masked BLOCK_H 2048 program)
NORM_CASES = (("rms_norm", 4096, (1, 37, 256, 4096)),
              ("rms_norm", 1536, (8192,)),
              ("layer_norm", 768, (1, 37, 256, 32768)))
# Paged-attention ticks of the kernels phase beside the three main-path
# shapes, (label, paged_tick kind, N, K, D, bs, MB): prefill runs of 1, 63,
# 64, 65 and 256 rows starting mid-block; a mixed tick (decode rows, two
# prompts' chunks, pad rows) at llama2_7b's and gpt2_125m's shapes; GQA rep
# 3, 4, 6 and 8 with a chunk of 70 rows (rep 3 and 6 do not divide the
# prefill kernel's 64 rows: its blocks take 21 and 10 rows of a tile, and
# the last block of each tile only the rest); two tables sharing a prefix;
# rows of two sequences
# interleaved; one run with unordered lengths (0, 1, past the table);
# contexts of MB * bs = 2048. fp32 outputs and the bf16 decode rows (fp32 P)
# are held at TOL; the bf16 prefill rows (P rounded to bf16 for the tensor
# cores) by FLASH_BF16_RULE.
PA_TICKS = tuple(
    [(f"run{n}", f"run{n}", 32, 32, 128, 32, 16) for n in (1, 63, 64, 65, 256)]
    + [("mixed", "mixed", 32, 32, 128, 32, 16),
       ("mixed_gpt2", "mixed", 12, 12, 64, 64, 16),
       ("gqa3", "gqa", 24, 8, 128, 32, 16),
       ("gqa4", "gqa", 32, 8, 128, 32, 16),
       ("gqa6", "gqa", 48, 8, 64, 32, 16),
       ("gqa8", "gqa", 32, 4, 128, 32, 16),
       ("shared_prefix", "shared_prefix", 32, 32, 128, 32, 16),
       ("interleaved", "interleaved", 32, 32, 128, 32, 16),
       ("ragged", "ragged", 32, 32, 128, 32, 16),
       ("long", "long", 32, 32, 128, 32, 64)])


def paged_tick(kind, bs, MB, seed=0):
    """(tables [T, MB] int32, lengths [T] int32, pool blocks NB) of one
    PA_TICKS tick. Each sequence names its own pool blocks (a permutation
    of 1 .. NB-1; block 0 is the trash block of the pad rows' all-zero
    tables); a chunk's rows share their sequence's table row, lengths
    start + 1 .. start + n."""
    rng = np.random.default_rng(seed)
    cap = MB * bs
    prefixes, rows = [], []      # per sequence: whose prefix it shares;
    #                              per row: (sequence or -1 for pad, length)

    def seq(prefix=None):
        prefixes.append(prefix)
        return len(prefixes) - 1

    def chunk(s, n, start):
        rows.extend((s, start + 1 + i) for i in range(n))

    if kind.startswith("run"):
        n = int(kind[3:])
        chunk(seq(), n, min(2 * bs + bs // 2, cap - n))
    elif kind == "mixed":
        for n in (1, bs + 3, cap - 5):
            rows.append((seq(), n))
        chunk(seq(), 40, bs // 2 + 1)
        chunk(seq(), 20, 3 * bs + 5)
        rows.extend([(-1, 1)] * 6)
    elif kind == "gqa":
        rows += [(seq(), bs + 1), (seq(), cap)]
        chunk(seq(), 70, bs // 2 + 3)
    elif kind == "shared_prefix":
        a = seq()
        b = seq(prefix=a)
        chunk(a, 20, bs * (MB // 2) + 1)
        chunk(b, 18, bs * (MB // 2) + 2)
        rows += [(a, cap - 3), (b, cap // 2 + 7)]
    elif kind == "interleaved":
        a, b = seq(), seq()
        for i in range(12):
            rows += [(a, 2 * bs + i + 1), (b, 3 * bs + i + 1)]
    elif kind == "ragged":
        s = seq()
        lens = [0, 1, cap, cap + 9] + [int(n) for n in
                                        rng.integers(1, cap, 16)]
        rng.shuffle(lens)
        rows += [(s, n) for n in lens]
    elif kind == "long":
        for n in (cap, cap + 100, cap - 1, 0):
            rows.append((seq(), n))
        chunk(seq(), 64, cap - 64)
    else:
        raise ValueError(f"unknown paged tick {kind!r}")
    NB = 1 + MB * len(prefixes)
    free = rng.permutation(np.arange(1, NB)).astype(np.int32)
    tabs = []
    for i, prefix in enumerate(prefixes):
        t = free[i * MB:(i + 1) * MB].copy()
        if prefix is not None:
            t[:MB // 2] = tabs[prefix][:MB // 2]
        tabs.append(t)
    tables = np.zeros((len(rows), MB), np.int32)
    for r, (s, _) in enumerate(rows):
        if s >= 0:
            tables[r] = tabs[s]
    return tables, np.array([n for _, n in rows], np.int32), NB


def prefill_rows(tables, min_run):
    """The rows of a tick that the plan sends to the prefill kernel,
    computed on the host: runs of at least ``min_run`` consecutive rows
    with equal table rows."""
    T = len(tables)
    out = np.zeros(T, bool)
    lo = 0
    for t in range(1, T + 1):
        if t == T or not np.array_equal(tables[t], tables[lo]):
            out[lo:t] = t - lo >= min_run
            lo = t
    return out


def serving_launches_want(L, tick_rows, norm_kind, min_run, moe_gmm=0):
    """Launch counts of a bf16 serving run of an L-layer model whose ticks
    had ``tick_rows`` rows each: each layer of each tick calls paged
    attention once, which launches the decode kernel (a tick with no decode
    row launches it all the same: its blocks find no work and exit); a tick
    of at least ``min_run`` rows, which may hold a run, launches the plan
    kernel once and the prefill kernel once a layer (a tick of fewer rows
    launches neither); the norm kernel 2 L + 1 times a tick; an MoE model's
    grouped GEMM ``moe_gmm`` times a layer and tick (one gmm an expert
    weight), and no tgmm."""
    n_ticks = len(tick_rows)
    n_planned = sum(1 for t in tick_rows if t >= min_run)
    out = {"paged_attention": L * n_ticks,
           "paged_attention_decode": L * n_ticks,
           "paged_attention_prefill": L * n_planned,
           "paged_attention_plan": n_planned,
           norm_kind: (2 * L + 1) * n_ticks}
    if moe_gmm:
        out.update(gmm=moe_gmm * L * n_ticks, tgmm=0)
    return out


# Block-sparse attention against its plain version: the flash kernels'
# bodies over the layout's active squares, so flash attention's tolerances
# and reasons. (label, B, S, N, K, D, layout, causal): llama_750m's shape
# with the model path's three layouts (block 64, causal), gpt2's D 64, GQA,
# and a non-causal layout with an all-inactive q row (o = 0, lse = -1e30,
# dq = 0 there; dk = dv = 0 for keys no row attends).
SPARSE_BLOCK = 64
SPARSE_CASES = (("llama_750m_fixed", 4, 2048, 12, 12, 128, "fixed", True),
                ("llama_750m_bigbird", 4, 2048, 12, 12, 128, "bigbird", True),
                ("llama_750m_bslongformer", 4, 2048, 12, 12, 128,
                 "bslongformer", True),
                ("gpt2_d64_fixed", 8, 1024, 12, 12, 64, "fixed", True),
                ("gqa", 2, 1024, 12, 4, 128, "fixed", True),
                ("inactive_row_d64", 2, 512, 4, 4, 64, "inactive_row", False),
                ("inactive_row_d128", 2, 512, 4, 2, 128, "inactive_row",
                 False))
# Evoformer forward against its plain version: the fp32 kernel sums each
# row's S <= 256 keys in fp32 like the plain version, so the kernels' TOL;
# the bf16 kernel runs P V on the tensor cores with P rounded to bf16, so
# its output is held by flash's bf16 rule (``close_flash``) instead.
# (label, G, S, N, D, bias): OpenFold's triangle attention (config.py:
# pair channels 128 = 4 heads of c_hidden_tri_att 32 at crop_size 256; a
# per-row mask bias [G, 1, 1, S], one row of it -inf everywhere, plus the
# shared triangle bias [1, N, S, S] → a per-row [256, 4, 256, 256]), its
# MSA-row attention (8 heads of c_hidden_msa_att 32 over max_msa_clusters
# 128 rows; the shared pair bias, Gb 1), the extra-MSA stack's D 8, and
# unaligned S with per-row and shared biases.
EVO_CASES = (("triangle", 256, 256, 4, 32, "mask+shared"),
             ("msa_row", 128, 256, 8, 32, "shared"),
             ("extra_msa_d8", 256, 256, 8, 8, "shared"),
             ("unaligned_s200", 8, 200, 4, 32, "per_row"),
             ("unaligned_d128", 2, 100, 2, 128, "shared"),
             ("d16", 4, 130, 2, 16, "per_row"),
             ("d64", 4, 130, 2, 64, "shared"))
# The evoformer phase: msa_row_attention_with_pair_bias at OpenFold's
# Evoformer widths (config.py: c_m 256, 8 heads of c_hidden_msa_att 32,
# max_msa_clusters 128, crop_size 256), gated.
EVO_MAIN = dict(rows=128, seq=256, c_m=256, heads=8, head_dim=32)
# Training runs: the repo's headline settings (bench.py train_bench), the
# zero3_llama_750m_bf16 row's shape and the moe_ulysses_moe_350m_bf16 row's
# (bench.py), at ZeRO stage 1 (one process partitions nothing), flash
# attention (ulysses_flash at sequence world 1) and remat full; then
# llama_750m's run again with block-sparse attention ("sparse:fixed", the
# model path's default kind; the JAX package's sparse training path).
# "model" names the preset where the run's key does not.
TRAIN = {"gpt2_125m": dict(micro=32, seq=1024, gas=4, steps=4,
                           norm="layer_norm", gate_micro=2),
         "llama_750m": dict(micro=4, seq=2048, gas=4, steps=3,
                            norm="rms_norm", gate_micro=1),
         "moe_350m": dict(micro=16, seq=1024, gas=4, steps=3,
                          norm="layer_norm", gate_micro=2),
         "llama_750m_sparse": dict(model="llama_750m",
                                   attention="sparse:fixed", micro=4,
                                   seq=2048, gas=4, steps=3, norm="rms_norm",
                                   gate_micro=1)}
TRAIN_LR = 1e-4
# One optimizer step, kernel path vs plain path, fp32, same weights and
# batch: loss within TRAIN_LOSS_REL (relative), grad norm within
# TRAIN_NORM_REL, the whole gradient within TRAIN_GRAD_REL (relative L2),
# and the Adam update with the same sign on all but TRAIN_SIGN_MISS of the
# elements: step 1 of Adam moves each weight by about lr * sign(g), so a
# gradient that differs only in its last digits flips the sign of a
# near-zero element — the key bias's true gradient is 0 (softmax ignores a
# per-query constant), so its L x N x D elements are rounding noise on
# either path (7.4e-5 of gpt2_125m's weights), and a CPU rehearsal of the
# tiny model gave 3.5e-4 for all such elements together. Those elements'
# |g| lies far below eps, so they move by lr g / eps, next to nothing, and
# the update's relative L2 (kernel vs plain) follows the gradient's: within
# TRAIN_UPDATE_REL, ten times TRAIN_GRAD_REL. Every way's update is also
# held against step 1 of Adam from its own gradient, -lr g / (|g| + eps),
# within TRAIN_ADAM_REL (relative L2): the fp32 rounding of p - lr u, about
# 6e-8 |p| against lr = 1e-4 per weight. A 1 % error of the lr or the bias
# correction on the step path reads 1e-2 there. (On an NVIDIA H100 80GB
# HBM3 at 700 W: update 4.5e-5 and 9.0e-5, Adam 8.7e-6 and 8.4e-6, for
# gpt2_125m and llama_750m.) bf16: the kernel path's error against the
# fp32 plain step at most BF16_VS_PLAIN times the plain bf16 path's, metric
# by metric (the gate's inputs come from the seed, and two runs on one card
# gave the same readings to the last digit). For the loss and the aux loss
# (BF16_FLOORED) a plain error below the fp32 gate's own limit counts as
# that limit: such a scalar carries noise of either sign, and the plain
# bf16 moe_350m step once hit the fp32 loss to the last bit (error 0, the
# kernel path's 1.5e-5; on an NVIDIA H100 80GB HBM3 at 700 W).
# MoE: the share of (token, choice) pairs routed to the same expert as on
# the fp32 plain step, over every layer of the gate step's forward, at
# least ROUTE_AGREE_MIN in fp32 (the two paths' router inputs differ in
# their last fp32 digits, so only a near-tie of the k-th and (k+1)-th
# scores can flip); the aux loss within TRAIN_LOSS_REL. A flip sends one
# token's row through another expert: the loss and grad norm move by about
# one token's share (1/4096 at the gate's 2 x 1024 x top-2), but that
# expert's weight gradient by about 1/sqrt(its rows), ~2e-2, so the
# gradient, update and sign gates would fail with it — the routing metric
# names the cause. bf16 holds route misses and the aux error to
# BF16_VS_PLAIN times the plain bf16 path's, like the other metrics (0.36 %
# of the pairs flip between the plain bf16 step and the fp32 one).
ROUTE_AGREE_MIN = 1 - 1e-4
TRAIN_LOSS_REL = 1e-5
TRAIN_NORM_REL = 1e-4
TRAIN_GRAD_REL = 1e-4
TRAIN_SIGN_MISS = 1e-3
TRAIN_UPDATE_REL = 10 * TRAIN_GRAD_REL
TRAIN_ADAM_REL = 1e-4
HEAD_ATOL = 1e-4
LOGIT_REL_TOL_FP32 = 1e-3
TOP1_MIN = 0.99
BF16_VS_PLAIN = 2.0
BF16_FLOORED = ("loss_rel", "aux_rel")
BF16_TOP1_SLACK = 0.05
# The ZeRO++ phase: bench.py's zero2_qgz_llama_750m_bf16 row (ZeRO-2 +
# qgZ + qwZ + LoCo, micro 4 a rank, seq 2048, gas 4, bf16) at world 2, both
# ranks on the one card over gloo; 1 warm-up + 2 steps. The qwZ publish
# quantizes by JAX's overlap plan: at allgather_bucket_size 5e8 and
# llama_750m's 28,311,552 elements a layer, two layer chunks, so three
# groups (the head group, then each chunk). Per rank and step the design
# launches quantize gas + 3 times (each micro-batch's qgZ send, the
# publish's groups) and dequant-reduce 2 gas + 3 times (each micro-batch's
# receive and LoCo's dequantized send, the publish's groups).
ZEROPP = dict(model="llama_750m", world=2, micro=4, seq=2048, gas=4, steps=2,
              gate_micro=1)
ZEROPP_CHUNKS = [[0, 10], [10, 20]]
ZEROPP_WIRE = {"stage": 2, "zero_quantized_gradients": True,
               "zero_quantized_weights": True, "loco_error_feedback": True}
ZEROPP_EXACT = {"stage": 2}
# exact ZeRO-2 with overlap_comm and overlap_step (the defaults): the
# gradient summed over the micro-batches locally, each layer chunk's sum
# reduced when the last micro-batch's backward is done with it, the other
# leaves by reduce_bucket_size buckets, the update and its publish by
# update_bucket_size buckets; against one reduce after the backward
# (overlap_comm off) by the training rule on one fp32 step
ZEROPP_EXACT_ONCE = {"stage": 2, "overlap_comm": False}
# Gate 2 of the ZeRO++ phase: one fp32 step (gas 1), all kernels against
# all plain versions (model kernels and the wire's): the reduced gradient
# and the update no further apart than WIRE_NOISE_SHARE of the distance
# between the plain qgZ step and the plain exact ZeRO-2 step from the same
# state (the int8 wire's own noise; a flipped int8 rounding moves one
# element by one quantization step, so kernel-vs-plain differences of the
# fp32 gradient's last digits may flip a few).
WIRE_NOISE_SHARE = 0.1
# The ZeRO-3 phase: bench.py's zero3_llama_750m_bf16 row (llama_750m,
# stage 3, micro 4 a rank, seq 2048, gas 4, bf16, flash, remat full, Adam)
# at world 2 on the one card over gloo, overlap_comm on with the default
# stage3_prefetch_bucket_size 5e7: JAX's plan of 8 layer chunks
# (even_chunk_bounds(20, 8): 3, 3, 3, 3, 2, 2, 2, 2 layers). Run (a) exact
# ZeRO-3, (b) ZeRO-3 + qgZ + qwZ + LoCo, (c) exact ZeRO-2 (the zeropp
# phase's baseline when it ran in the same call); 1 warm-up + 2 steps
# each. The gate steps Z1-Z2 run the model cut to ZERO3["gate_layers"]
# layers at full width (gas 1, micro 1 a rank).
ZERO3 = dict(ZEROPP, gate_layers=4)
ZERO3_EXACT = {"stage": 3}
ZERO3_WIRE = dict(ZEROPP_WIRE, stage=3)
ZERO3_CHUNKS = 8
# the phase's main path runs this many of llama_750m's 20 layers (width
# unchanged; JAX's plan still cuts them into 8 chunks): the cut that keeps
# the whole script within its time beside the expert-parallel phase. Its
# exact ZeRO-2 baseline then runs in this phase at the same depth, and the
# gates keep their own depth.
ZERO3_LAYERS = 10
# Z4: run (a)'s peak a rank at least this far below exact ZeRO-2's at the
# preset's 20 layers, and the same share of it at fewer (what ZeRO-3 saves
# is the compute copy's and the gradient's shard of every layer)
ZERO3_MEMORY_SAVED = 3e9
# ZeRO-3 for a spec other than causal_lm_spec's: a 4-layer MLP at width
# 4096 with a regression loss (built here, random from the seed), fp32, at
# world 2 against the same spec at world 1 without ZeRO, by the training
# rule: 2 steps, micro 64 rows a rank, gas 2
ZERO3_MLP = dict(width=4096, layers=4, micro=64, gas=2, steps=2)
ZERO3_SPANS = ("zero3_gather_issue", "zero3_gather_wait",
               "zero3_gather_unpack", "zero3_reduce_issue",
               "zero3_reduce_wait")
# The hpZ / MiCS phase: bench.py's zero3_llama_750m_bf16 row at world 4 on
# the mesh data 2 x zshard 2 (rank r at data r // 2, zshard r % 2), the
# four ranks on the one card over gloo; 1 warm-up + 2 steps a run. Run (a)
# the ZeRO++ trio: ZeRO-3 + hpZ + qwZ + qgZ, without LoCo, whose step-long
# fp32 residual (2.66 GB a rank) is left out to keep the four ranks' peaks
# well inside the card (LoCo under hpZ is held against JAX on the CPU,
# tests/test_torch_hpz.py).
# Run (b) MiCS at stage 3: exact ZeRO-3 + mics_shard_size 2. Gates H1-H2
# run HPZ["gate_layers"] layers at full width (gas 1, micro 1 a rank), each
# hpZ step against the same step at data = 4 (hpZ off).
HPZ = dict(ZERO3, world=4)
# the phase's main path runs this many of llama_750m's 20 layers (width
# unchanged): the cut that keeps the whole script within its time; the
# gates keep their own depth
HPZ_LAYERS = 8
HPZ_Z = 2
HPZ_TRIO = {"stage": 3, "zero_hpz_partition_size": HPZ_Z,
            "zero_quantized_gradients": True, "zero_quantized_weights": True}
HPZ_MICS = {"stage": 3, "mics_shard_size": HPZ_Z}
HPZ_GATES = (("fp32_d4_zero3", {"stage": 3}, "fp32"),
             ("fp32_hpz_zero3", {"stage": 3,
                                 "zero_hpz_partition_size": HPZ_Z}, "fp32"),
             ("bf16_d4_zero3", {"stage": 3}, "bf16"),
             ("bf16_hpz_zero3", {"stage": 3,
                                 "zero_hpz_partition_size": HPZ_Z}, "bf16"),
             ("fp32_d4_zero2", {"stage": 2}, "fp32"),
             ("fp32_hpz_zero2", {"stage": 2,
                                 "zero_hpz_partition_size": HPZ_Z}, "fp32"))
# each gate step's reference: the same step at data = 4 (bf16: fp32's)
HPZ_GATE_REF = {"fp32_hpz_zero3": "fp32_d4_zero3",
                "bf16_d4_zero3": "fp32_d4_zero3",
                "bf16_hpz_zero3": "fp32_d4_zero3",
                "fp32_hpz_zero2": "fp32_d4_zero2"}
PG_TIMEOUT_S = 900               # the ranks' process group
RANKS_TIMEOUT_S = 900            # a spawned phase's ranks, all together
QRS = dict(n=2 ** 26, worlds=(2, 4))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def active_params(cfg) -> int:
    """Parameters whose matmuls run for each token, a copy of ``bench.py``
    ``_active_params`` (MoE: top_k of n_experts; a dense model's count is
    ``num_params``)."""
    n_params = cfg.num_params()
    if cfg.n_experts > cfg.moe_top_k:
        ffn_mats = 3 if cfg.activation == "swiglu" else 2
        per_expert = ffn_mats * cfg.hidden_size * cfg.ffn_size
        n_params = n_params - cfg.num_layers * \
            (cfg.n_experts - cfg.moe_top_k) * per_expert
    return n_params


def flops_per_token(cfg, seq_len: int) -> float:
    """Model FLOPs per token of a training step, a copy of ``bench.py``
    ``_flops_per_token``: 6 N_active for the forward and backward matmuls
    plus causal attention 6 L H S; remat recompute not counted."""
    attn = 6 * cfg.num_layers * cfg.hidden_size * seq_len
    if not cfg.causal:
        attn *= 2
    return float(6 * active_params(cfg) + attn)


@contextlib.contextmanager
def recorded_routes():
    """Yields a list that receives every routed MoE layer's (experts [T, k],
    aux loss), detached, while the block runs: the layer's gate is wrapped
    for its duration and restored after."""
    from deepspeed_tpu_torch.moe import layer as MoE

    gate, routes = MoE._gate_indices, []

    def recording_gate(*args, **kwargs):
        out = gate(*args, **kwargs)
        routes.append((out.experts.detach(), out.aux_loss.detach()))
        return out

    MoE._gate_indices = recording_gate
    try:
        yield routes
    finally:
        MoE._gate_indices = gate


@contextlib.contextmanager
def recorded_aux():
    """Yields a list that receives every MoE layer's aux loss as the layer
    returns it (over processes: the global one), detached, while the block
    runs; ``moe_ffn`` is wrapped for its duration and restored after."""
    from deepspeed_tpu_torch.moe import layer as MoE

    fn, auxes = MoE.moe_ffn, []

    def recording(*args, **kwargs):
        y, aux = fn(*args, **kwargs)
        auxes.append(aux.detach())
        return y, aux

    MoE.moe_ffn = recording
    try:
        yield auxes
    finally:
        MoE.moe_ffn = fn


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def counter_dicts():
    """Every kernel wrapper's launch counts (and the host library's
    calls)."""
    from deepspeed_tpu_torch.ops import block_sparse as BS
    from deepspeed_tpu_torch.ops import cpu_adam
    from deepspeed_tpu_torch.ops import evoformer as EV
    from deepspeed_tpu_torch.ops import flash_attention as PF
    from deepspeed_tpu_torch.ops import fused_adam as FA
    from deepspeed_tpu_torch.ops import grouped_gemm as GG
    from deepspeed_tpu_torch.ops import norms
    from deepspeed_tpu_torch.ops import paged_attention as PA
    from deepspeed_tpu_torch.ops import quant_kernels as QK

    return (PA.launches, norms.launches, PF.launches, FA.launches,
            GG.launches, BS.launches, EV.launches, QK.launches,
            cpu_adam.calls)


def reset_counts():
    from deepspeed_tpu_torch.ops import norms

    for d in counter_dicts() + (norms.backward_calls,):
        for k in d:
            d[k] = 0


def read_counts():
    out = {}
    for d in counter_dicts():
        out.update(d)
    return out


def engine_addresses(eng):
    """Where an engine's parameters and KV pool live on the device: a
    captured graph holds these addresses, so they must never move."""
    out = {f"param/{n}": p.data_ptr() for n, p in eng.model.named_parameters()}
    out.update({f"pool/{k}": v.data_ptr() for k, v in eng.pool.items()})
    return out


def same_bits(a, b) -> bool:
    """Equal element for element, NaN where the other is NaN."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@contextlib.contextmanager
def plain_wire():
    """The int8 wire's plain versions in place of its kernels while the
    block runs (the wire modules' names are rebound, then restored): the
    plain path of the kernel-vs-plain gates. No product code reads this."""
    from deepspeed_tpu_torch.ops import quant_kernels as QK
    from deepspeed_tpu_torch.ops import quantization as PQ
    from deepspeed_tpu_torch.parallel import compressed as C

    def dequantize_ref(q, s, block=QK.DEFAULT_BLOCK):
        return QK.dequant_reduce_ref(q.reshape(1, -1), s.reshape(1, -1), block)

    names = {C: ("quantize_int8", "dequant_reduce", "dequantize_int8"),
             PQ: ("quantize_int8", "dequant_reduce")}
    plain = {"quantize_int8": QK.quantize_int8_blocks_ref,
             "dequant_reduce": QK.dequant_reduce_ref,
             "dequantize_int8": dequantize_ref}
    saved = {(m, n): getattr(m, n) for m, ns in names.items() for n in ns}
    for (m, n) in saved:
        setattr(m, n, plain[n])
    try:
        yield
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)


def rank_entry(fn_name, rank, world, init_method, out, args):
    """A spawned rank: join the gloo group on the one card, run
    ``fn_name(rank, world, *args)``, send its result (or its traceback)
    to the parent. Ranks print no result lines themselves.

    Without a card (the CPU rehearsals) a rank computes with one intra-op
    thread. With the default pool, the first forward of a process
    sometimes gave other bits than every later one on the same inputs: the
    plain attention's fp32 batched matmuls (MKL's), while the rank's
    communication thread ran its first gathers. In the ZeRO-3 rehearsal
    under 6 runs at once that was 2 of 72 runs with the default pool, 1 of
    24 with two threads, none of 72 with one: one thread leaves the
    library no split of the work to choose."""
    try:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import torch

        if not torch.cuda.is_available():
            torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if torch.cuda.is_available():
            torch.cuda.set_device(0)
        import deepspeed_tpu_torch as dtt

        dtt.init_distributed(dist_backend="gloo", init_method=init_method,
                             rank=rank, world_size=world,
                             timeout=PG_TIMEOUT_S, verbose=False)
        result = globals()[fn_name](rank, world, *args)
        dtt.comm.destroy_process_group()
        out.put((rank, "ok", result))
    except Exception:                                   # noqa: BLE001
        out.put((rank, "error", traceback.format_exc()))


def spawn_ranks(fn_name, world, *args):
    """``fn_name`` in ``world`` spawned ranks; their results by rank. Any
    rank's failure, or no result in ``RANKS_TIMEOUT_S``, raises; every
    process is stopped before it returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    procs = [ctx.Process(target=rank_entry, args=(
        fn_name, r, world, f"file://{os.path.join(tmp, 'pg')}", out, args))
        for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.time() + RANKS_TIMEOUT_S
    try:
        while len(results) < world and not errors:
            try:
                rank, status, value = out.get(
                    timeout=max(1.0, deadline - time.time()))
            except queue.Empty:
                errors.append(f"no result from ranks "
                              f"{sorted(set(range(world)) - set(results))} "
                              f"in {RANKS_TIMEOUT_S} s")
                break
            if status == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank} failed:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("; ".join(errors))
    return [results[r] for r in range(world)]


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def dev_sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dev_peak(dev, reset=False):
    """Peak bytes allocated on ``dev`` since the last reset (0 on the CPU,
    where a rehearsal runs)."""
    import torch

    if dev.type != "cuda":
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev)


def dev_allocated(dev):
    """Bytes allocated on ``dev`` now (0 on the CPU)."""
    import torch

    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def dev_free(dev):
    """Return what dropped engines held (after a collection: a reference
    cycle would keep a whole engine) to the card."""
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def zeropp_config(micro, gas, precision, zero):
    cfg = Smoke.train_config(micro, gas, precision)
    cfg["zero_optimization"] = dict(zero)
    return cfg


def gathered_sq(n_sh, t):
    """Σ t² over the whole model from a rank's local buffer: the sharded
    region (its first ``n_sh`` elements) all-reduced, the replicated one
    once."""
    import torch
    from deepspeed_tpu_torch.comm import comm

    sq = torch.stack([t[:n_sh].double().square().sum(),
                      t[n_sh:].double().square().sum()])
    comm.all_reduce(sq[:1])
    return float(sq.sum())


def zeropp_run(t, dev, zero, batch, precision="bf16"):
    """The main path of one data-parallel config on this rank: initialize,
    a warm-up step, then ``t["steps"]`` timed steps with the counters (and
    the collectives' traffic by group) set to 0 just before and read just
    after."""
    import itertools

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import comm

    steps = t["steps"]
    dev_peak(dev, reset=True)
    t0 = time.perf_counter()
    depth = {"num_layers": t["layers"]} if t.get("layers") else {}
    spec = dtt.causal_lm_spec(t["model"], attention="flash", remat="full",
                              **depth)
    config = zeropp_config(t["micro"], t["gas"], precision, zero)
    if t.get("mesh"):
        config["mesh"] = dict(t["mesh"])
    engine, *_ = dtt.initialize(model=spec, config=config, device=dev)
    dev_sync(dev)
    init_s = time.perf_counter() - t0
    data = itertools.repeat(batch)
    t0 = time.perf_counter()
    first = float(engine.train_batch(data))
    warm_s = time.perf_counter() - t0
    comm.barrier()
    reset_counts()
    comm.reset_traffic()
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = engine.train_batch(data)
        dev_sync(dev)
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = read_counts()
    traffic = {k: list(v) for k, v in comm.traffic.items()}
    return engine, data, {
        "wire": engine._wire_format(), "init_seconds": init_s,
        "warmup_step_seconds": warm_s, "losses": [first] + losses,
        "step_walls_s": walls, "step_ms": float(np.median(walls)) * 1e3,
        "launches": counts, "traffic": traffic,
        "adam_per_step": adam_launches_per_step(engine),
        "peak_memory_bytes": dev_peak(dev),
        "n_sharded": engine._n_sh, "n_replicated": engine._n_rep,
        "plan_chunks": [list(b) for b in
                        engine.overlap_plan()["chunk_bounds"]]}


def zeropp_profile(engine, data, dev, profiled):
    """One more step; on rank 0 under torch.profiler: device time by kind
    (compute kernels, the two int8 kernels, the annotated wire spans'
    device time), the host time of the wire stages (telemetry spans: gloo
    through host memory), and the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch import telemetry

    telemetry.reset()
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    with ctx as prof:
        dev_sync(dev)
        t0 = time.perf_counter()
        engine.train_batch(data)
        dev_sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = ("zero_pack", "zero_publish", "qgz_quantize", "qgz_sent",
             "qgz_all_to_all", "qgz_dequant_reduce", "qwz_publish",
             "zero_reduce_issue", "zero_reduce_wait") + ZERO3_SPANS
    hist = telemetry.get_registry().histogram("span_seconds")
    host_ms = {sp: hist.summary(span=sp).get("sum", 0.0) * 1e3
               for sp in spans}
    if not profiled:
        return {"profiled_step_ms": wall_ms, "host_span_ms": host_ms}
    kinds, dev_spans = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0)
                   or getattr(e, "self_cuda_time_total", 0))
        if e.key in spans:
            dev_spans[e.key] = dev_spans.get(e.key, 0.0) + us / 1e3
            continue
        if getattr(e, "is_user_annotation", False) or not us:
            continue
        low = e.key.lower()
        kind = ("quant_int8" if "quant_kernel" in low
                else "dequant_reduce" if "dequant_reduce_kernel" in low
                else "flash" if "flash_" in low
                else "fused_adam" if "fused_adam_kernel" in low
                else "norm" if "norm" in low
                else "gemm" if any(w in low for w in (
                    "gemm", "nvjet", "cutlass", "matmul", "sm90_xmma"))
                else "copy" if any(w in low for w in (
                    "copy", "memcpy", "elementwise", "vectorized"))
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
    device_ms = sum(kinds.values())
    return {"profiled_step_ms": wall_ms,
            "device_ms_per_step": device_ms or "not measured",
            "device_ms_by_kind": kinds or "not measured",
            "wire_span_device_ms": dev_spans or "not measured",
            "host_span_ms": host_ms,
            "wire_host_ms_gloo": sum(host_ms[k] for k in (
                "qgz_all_to_all", "qwz_publish", "zero_reduce_issue",
                "zero_reduce_wait")),
            "device_idle_share": (1 - device_ms / wall_ms if device_ms
                                  else "not measured")}


def wire_gates(engine, batch, dev):
    """Gates 1 and 4 on the step's real packed gradient: one more
    micro-batch's gradient packed as the wire sends it (with the LoCo
    residual); kernel q, scales and reduced chunk against the plain
    versions, bit for bit; |reduced − exact mean| within Σ_w (scale_w / 2)
    / W plus fp32 rounding, per element."""
    import torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops import quant_kernels as QK
    from deepspeed_tpu_torch.runtime.dataloader import stack_micros

    W, B = engine.world, QK.DEFAULT_BLOCK
    mb = engine._to_device(engine._local_rows(stack_micros([batch])))
    mb = {k: v[0] for k, v in mb.items()}
    with engine._step_buffers():        # ZeRO-3: the step's full gradient
        engine._loss_and_grads(mb, None)
        engine._pack()
        x = engine._packed
        engine.flat_grad.zero_()
    if engine.loco_err is not None:
        x.add_(engine.loco_err)
    q, sc = QK.quantize_int8_blocks(x.view(-1))
    # the plain versions chunk by chunk (blocks are independent): their
    # whole-buffer temporaries would not fit beside two ranks' engines
    step = 2 ** 26
    q_equal = s_equal = red_equal = True
    for i in range(0, q.numel(), step):
        rq, rsc = QK.quantize_int8_blocks_ref(x.view(-1)[i:i + step])
        q_equal &= same_bits(q[i:i + step], rq)
        s_equal &= same_bits(sc[i // B:(i + step) // B], rsc)
    del rq, rsc
    qa = comm.all_to_all_single(q.view(W, -1))
    sa = comm.all_to_all_single(sc.view(W, -1))
    del q, sc
    red = QK.dequant_reduce(qa, sa, mean=True)
    for i in range(0, red.numel(), step):
        red_equal &= same_bits(red[i:i + step], QK.dequant_reduce_ref(
            qa[:, i:i + step].contiguous(),
            sa[:, i // B:(i + step) // B].contiguous(), mean=True))
    xa = comm.all_to_all_single(x)
    exact = xa[0].clone()
    for w in range(1, W):
        exact.add_(xa[w])
    exact.div_(torch.tensor(float(W), device=dev))
    del xa
    bound = (sa.sum(0) / (2 * W)).repeat_interleave(B)
    err = (red - exact).abs()
    over = err > bound * (1 + 1e-6) + 1e-6 * exact.abs()
    ratio = float((err / bound.clamp_min(1e-30)).max())
    out = {"q_bitwise_equal": q_equal, "scales_bitwise_equal": s_equal,
           "reduced_bitwise_equal": red_equal, "elements": x.numel(),
           "quant_err_max_over_bound": ratio,
           "quant_err_out_of_bound": int(over.sum()),
           "quant_err_max_abs": float(err.max())}
    return out


def zeropp_gate_step(t, dev, master, batch, zero, precision, kernels):
    """One step (the gate's micro; ``batch`` one micro-batch, or a list of
    them: gas their number) from ``master`` on this rank: (sharded
    elements, loss, reduced gradient, update) — the gradient's and
    update's local buffers stay on the device."""
    batches = batch if isinstance(batch, list) else [batch]
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import load_master

    spec = dtt.causal_lm_spec(
        t["model"], attention="flash", remat="full", use_kernels=kernels,
        dtype="float32" if precision == "fp32" else "bfloat16")
    with (contextlib.nullcontext() if kernels else plain_wire()):
        engine, *_ = dtt.initialize(model=spec, config=zeropp_config(
            t["gate_micro"], len(batches), precision, zero), device=dev)
        load_master(engine, master)
        before = engine.flat_master.clone()
        loss = float(engine.train_batch(iter(batches)))
    grad = engine.flat_grad_acc.float()
    update = engine.flat_master - before
    n_sh = engine._n_sh
    del before, engine
    return n_sh, loss, grad, update


def zeropp_gates(t, dev, master, batch):
    """Gates 2 and 3: fp32 all kernels vs all plain within WIRE_NOISE_SHARE
    of the plain qgZ-vs-exact distance; bf16 kernels no further from the
    fp32 plain step than BF16_VS_PLAIN times the plain bf16 path."""
    res = {}
    ref = None
    for way, zero, prec, kern in (
            ("fp32_plain", ZEROPP_WIRE, "fp32", False),
            ("fp32_plain_exact", ZEROPP_EXACT, "fp32", False),
            ("fp32_kernels", ZEROPP_WIRE, "fp32", True),
            ("bf16_plain", ZEROPP_WIRE, "bf16", False),
            ("bf16_kernels", ZEROPP_WIRE, "bf16", True)):
        n_sh, loss, grad, upd = zeropp_gate_step(t, dev, master, batch,
                                                 zero, prec, kern)
        row = {"loss": loss}
        if ref is None:
            ref = {"loss": loss, "grad": grad, "upd": upd,
                   "g2": gathered_sq(n_sh, grad), "u2": gathered_sq(n_sh, upd)}
        else:
            row.update(
                loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                grad_dist=gathered_sq(n_sh, grad - ref["grad"]) ** 0.5,
                update_dist=gathered_sq(n_sh, upd - ref["upd"]) ** 0.5)
            row["grad_rel"] = row["grad_dist"] / ref["g2"] ** 0.5
            row["update_rel"] = row["update_dist"] / ref["u2"] ** 0.5
        res[way] = row
        del grad, upd
        dev_free(dev)
    del ref
    dev_free(dev)
    k, noise = res["fp32_kernels"], res["fp32_plain_exact"]
    problems = []
    if not k["loss_rel"] <= TRAIN_LOSS_REL:
        problems.append(f"fp32 loss rel {k['loss_rel']:.3g}")
    for m in ("grad_dist", "update_dist"):
        if not k[m] <= WIRE_NOISE_SHARE * noise[m]:
            problems.append(f"fp32 {m} {k[m]:.3g} > {WIRE_NOISE_SHARE} x "
                            f"the wire's noise {noise[m]:.3g}")
    kb, pb = res["bf16_kernels"], res["bf16_plain"]
    for m in ("loss_rel", "grad_rel", "update_rel"):
        floor = TRAIN_LOSS_REL if m == "loss_rel" else 0.0
        if not kb[m] <= BF16_VS_PLAIN * max(pb[m], floor):
            problems.append(f"bf16 {m}: kernels {kb[m]:.3g}, plain "
                            f"{pb[m]:.3g}")
    return res, problems


def overlap_counts_want(engine):
    """The exact stage 1-2 wire's reduces and publishes a step by formula,
    from the config's sizes and the model's leaves (not from the engine's
    plan): under ``overlap_comm`` a reduce a layer chunk (``chunk_layers``
    over ``allgather_bucket_size``) and a reduce a ``reduce_bucket_size``
    bucket of the other leaves, each issued by the last micro-batch's
    gradient hooks, and a publish an ``update_bucket_size`` bucket holding
    a sharded leaf; off, one reduce after the backward and the publish in
    one pass."""
    from deepspeed_tpu_torch.parallel import stage3 as S3
    from deepspeed_tpu_torch.parallel.overlap import (
        chunk_layers,
        leaf_count,
        plan_buckets,
    )

    zcfg, shards = engine.config.zero_optimization, engine._shards
    if not zcfg.overlap_comm:
        return {"chunk": 0, "bucket": 1, "late": 1, "publish": 0}
    sizes = [leaf_count(sh.slot.shape) for sh in shards]
    L = engine.model_spec.config.num_layers
    per_layer = sum(n for n, sh in zip(sizes, shards)
                    if sh.slot.path[0] == "blocks") // L
    chunked = S3.chunked_shards(shards)
    head = [n for n, sh in zip(sizes, shards)
            if all(sh is not c for c in chunked)]
    upd = plan_buckets(sizes, update_bucket_elems(zcfg))
    return {"chunk": len(chunk_layers(L, per_layer,
                                      int(zcfg.allgather_bucket_size))),
            "bucket": len(plan_buckets(head, int(zcfg.reduce_bucket_size))),
            "late": 0,
            "publish": sum(any(shards[i].dim is not None for i in b)
                           for b in upd)}


def update_bucket_elems(zcfg):
    ub = zcfg.update_bucket_size
    return int(zcfg.reduce_bucket_size if ub == "auto" else ub)


def overlap_gate(t, dev, master, batches):
    """One fp32 step over two different micro-batches (so the
    micro-batches' reduces sum in another order than the once-a-step
    reduce's) of exact ZeRO-2 with the chunk and bucket reduces and the
    bucketed update against the once-a-step reduce, from ``master``, by
    the training rule."""
    ref = None
    res = {}
    for way, zero in (("once", ZEROPP_EXACT_ONCE), ("overlap", ZEROPP_EXACT)):
        n_sh, loss, grad, upd = zeropp_gate_step(t, dev, master, batches,
                                                 zero, "fp32", True)
        if ref is None:
            ref = {"loss": loss, "grad": grad, "upd": upd,
                   "g2": gathered_sq(n_sh, grad), "u2": gathered_sq(n_sh, upd)}
            res[way] = {"loss": loss}
        else:
            res[way] = {
                "loss": loss,
                "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
                "grad_rel": (gathered_sq(n_sh, grad - ref["grad"])
                             / ref["g2"]) ** 0.5,
                "update_rel": (gathered_sq(n_sh, upd - ref["upd"])
                               / ref["u2"]) ** 0.5}
        del grad, upd
        dev_free(dev)
    del ref
    g = res["overlap"]
    problems = [f"overlap gate {m} {g[m]:.3g} > {lim}" for m, lim in (
        ("loss_rel", TRAIN_LOSS_REL), ("grad_rel", TRAIN_GRAD_REL),
        ("update_rel", TRAIN_UPDATE_REL)) if not g[m] <= lim]
    return res, problems


def train_llama_750m_zeropp_dp2_rank(rank, world, seed, t):
    """One rank of the ZeRO++ phase (``t``: ZEROPP and the device): the
    main path, its profile, the four gates, then exact ZeRO-2 as the
    baseline."""
    import torch
    from deepspeed_tpu_torch.models import transformer as T

    dev = torch.device(t["device"])
    vocab = T.get_model_config(t["model"]).vocab_size
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (t["micro"] * world, t["seq"]),
                                    dtype=np.int32)}
    out = {"rank": rank}
    engine, data, out["main"] = zeropp_run(t, dev, ZEROPP_WIRE, batch)
    out["profile"] = zeropp_profile(engine, data, dev,
                                    profiled=rank == 0 and dev.type == "cuda")
    out["wire_gate"] = wire_gates(engine, batch, dev)
    master = engine.full_master()
    del engine, data
    dev_free(dev)
    gate_batch = {"tokens": batch["tokens"][:t["gate_micro"] * world]}
    out["gates"], out["gate_problems"] = zeropp_gates(t, dev, master,
                                                      gate_batch)
    # exact ZeRO-2: overlap_comm and overlap_step on (the defaults), then
    # the once-a-step reduce, then one fp32 step of each by the rule
    engine, data, out["baseline"] = zeropp_run(t, dev, ZEROPP_EXACT, batch)
    out["baseline"].update(reduce_counts=dict(engine.reduce_counts),
                           reduce_counts_want=overlap_counts_want(engine),
                           hooked=engine._grad_hooks,
                           plan=engine.overlap_plan())
    out["baseline_profile"] = zeropp_profile(engine, data, dev,
                                             profiled=False)
    engine.close()
    del engine, data
    dev_free(dev)
    engine, data, out["once"] = zeropp_run(t, dev, ZEROPP_EXACT_ONCE, batch)
    out["once"].update(reduce_counts=dict(engine.reduce_counts),
                       reduce_counts_want=overlap_counts_want(engine),
                       hooked=engine._grad_hooks)
    engine.close()
    del engine, data
    dev_free(dev)
    rows = t["gate_micro"] * world
    out["overlap_gate"], problems = overlap_gate(t, dev, master, [
        {"tokens": batch["tokens"][i * rows:(i + 1) * rows]}
        for i in range(2)])
    out["gate_problems"] += problems
    del master
    return out


def quantized_reduce_scatter_rank(rank, world, seed, p):
    """One rank of the entry-point phase: every rank's input regenerated
    from the seed; the kernels' result, the plain versions' (bit-equal),
    the whole plain reduction computed here (the parent checks that the
    ranks' chunks concatenate to it), the error against the exact mean."""
    import torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops import quant_kernels as QK
    from deepspeed_tpu_torch.ops import quantization as PQ

    dev = torch.device(p["device"])
    N, B = p["n"], QK.DEFAULT_BLOCK
    xs = [torch.randn(N, generator=torch.Generator(dev).manual_seed(
        seed * 100 + w), device=dev) * 10.0 ** (w % 3 - 1)
        for w in range(world)]
    comm.barrier()
    reset_counts()
    dev_sync(dev)
    t0 = time.perf_counter()
    got = PQ.quantized_reduce_scatter(xs[rank])
    dev_sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v for k, v in read_counts().items()
              if k in ("quant_int8", "dequant_reduce")}
    with plain_wire():
        plain = PQ.quantized_reduce_scatter(xs[rank])
    chunk = N // world
    q = [QK.quantize_int8_blocks_ref(x) for x in xs]
    whole = [QK.dequant_reduce_ref(
        torch.stack([qw[r * chunk:(r + 1) * chunk] for qw, _ in q]),
        torch.stack([sw[r * chunk // B:(r + 1) * chunk // B]
                     for _, sw in q]), mean=True) for r in range(world)]
    exact = sum(x[rank * chunk:(rank + 1) * chunk] for x in xs) / world
    bound = (sum(sw[rank * chunk // B:(rank + 1) * chunk // B]
                 for _, sw in q) / (2 * world)).repeat_interleave(B)
    err = (got - exact).abs()
    bound = bound.clamp_min(1e-30)
    return {"rank": rank, "world": world, "n": N, "wall_ms": wall_ms,
            "launches": counts, "kernel_equals_plain": same_bits(got, plain),
            "chunk": digest(got), "whole": [digest(c) for c in whole],
            "finite": bool(torch.isfinite(got).all()),
            "err_max_over_bound": float((err / bound).max()),
            "err_out_of_bound": int((err > bound * (1 + 1e-6)
                                     + 1e-6 * exact.abs()).sum())}


def adam_launches_per_step(engine):
    """Fused-Adam launches a step of a data-parallel engine, from the
    config's sizes and the local buffers' layout (not from the engine's
    plan): under ``overlap_step`` on the exact stage 1-2 wire one a
    contiguous run of each ``update_bucket_size`` bucket's leaves; else
    one."""
    from deepspeed_tpu_torch.ops.quant_kernels import DEFAULT_BLOCK
    from deepspeed_tpu_torch.parallel.overlap import leaf_count, plan_buckets

    zcfg = engine.config.zero_optimization
    if not (zcfg.overlap_step and zcfg.overlap_comm and engine.world > 1
            and zcfg.stage < 3 and not zcfg.zero_quantized_weights):
        return 1
    shards = engine._shards
    runs = 0
    for b in plan_buckets([leaf_count(sh.slot.shape) for sh in shards],
                          update_bucket_elems(zcfg)):
        spans = sorted(
            (sh.offset, sh.offset + -(-sh.n_loc // DEFAULT_BLOCK)
             * DEFAULT_BLOCK) if sh.dim is not None
            else (engine._n_sh + sh.offset,
                  engine._n_sh + sh.offset + -(-sh.n_loc // 64) * 64)
            for sh in (shards[i] for i in b))
        runs += 1 + sum(a[1] != c[0] for a, c in zip(spans, spans[1:]))
    return runs


def zero3_launches_want(L, gas, steps, chunks, wire, loco=True,
                        replica=False, adam_per_step=1):
    """Kernel launches a rank of a ZeRO-3 phase makes in ``steps`` steps:
    flash forward twice a layer (the forward and remat's recompute), dq
    and dkv once; the norms 4 a layer and the final one; Adam once a step.
    On the int8 wire, per micro-batch: one quantize and one dequant-reduce
    a qwZ gather (the head group, each chunk in the forward and again in
    the recompute: 1 + 2 chunks), plus qgZ's quantize and its receive's
    dequant-reduce; LoCo's dequantized send (``loco``); hpZ's replica hop
    (``replica``): one quantize and one dequant-reduce over the replicas'
    rows."""
    micros = gas * steps
    gathers = 1 + 2 * chunks
    quant = gathers + 1 + replica
    dequant = gathers + 1 + loco + replica
    return {"quant_int8": quant * micros if wire else 0,
            "dequant_reduce": dequant * micros if wire else 0,
            "flash_fwd": 2 * L * micros, "flash_bwd_dq": L * micros,
            "flash_bwd_dkv": L * micros, "fused_adam": adam_per_step * steps,
            "rms_norm": (4 * L + 1) * micros, "block_sparse_fwd": 0,
            "gmm": 0, "tgmm": 0, "evoformer_fwd": 0, "paged_attention": 0}


def zero3_count_problems(counts, gas, chunks, wire):
    """Z5's gathers and reduces of one step against the plan: a gather of
    the head group and of each chunk in the forward, each chunk again in
    the recompute; on the exact wire one reduce a group (chunks and the
    head group), none on the int8 wire (qgZ reduces the step's full
    gradient once a micro-batch)."""
    want = {"gather_fwd": gas * (1 + chunks), "gather_bwd": gas * chunks,
            "reduce": 0 if wire else gas * (1 + chunks)}
    return [f"{k}: {counts.get(k)} a step, want {v}"
            for k, v in want.items() if counts.get(k) != v]


def zero3_gate_problems(g):
    """Z1: the fp32 ZeRO-3 step against the fp32 ZeRO-2 step by the
    training parity rule; Z2: the bf16 ZeRO-3 loss within 1e-5 of the bf16
    ZeRO-2 loss and its update no further from the fp32 step than
    BF16_VS_PLAIN times ZeRO-2's bf16 update."""
    out = []
    z = g["fp32_zero3"]
    for m, lim in (("loss_rel", TRAIN_LOSS_REL), ("grad_rel", TRAIN_GRAD_REL),
                   ("update_rel", TRAIN_UPDATE_REL),
                   ("sign_miss", TRAIN_SIGN_MISS)):
        if not z[m] <= lim:
            out.append(f"Z1 fp32 {m} {z[m]:.3g} > {lim}")
    b2, b3 = g["bf16_zero2"], g["bf16_zero3"]
    if not abs(b3["loss"] - b2["loss"]) <= TRAIN_LOSS_REL * abs(b2["loss"]):
        out.append(f"Z2 bf16 loss {b3['loss']!r} against ZeRO-2's "
                   f"{b2['loss']!r}")
    if not b3["update_rel"] <= BF16_VS_PLAIN * b2["update_rel"]:
        out.append(f"Z2 bf16 update_rel {b3['update_rel']:.3g} > "
                   f"{BF16_VS_PLAIN} x ZeRO-2's {b2['update_rel']:.3g}")
    return out


def zero3_memory_problems(peak_zero3, peak_zero2, layers=20):
    """Z4: exact ZeRO-3's peak a rank at least ZERO3_MEMORY_SAVED below
    exact ZeRO-2's at 20 layers, ``layers`` / 20 of it at ``layers``."""
    saved = ZERO3_MEMORY_SAVED * layers / 20
    if peak_zero3 <= peak_zero2 - saved:
        return []
    return [f"Z4 peak {peak_zero3 / 1e9:.3f} GB, not {saved / 1e9:g}"
            f" GB below exact ZeRO-2's {peak_zero2 / 1e9:.3f} GB"]


def qwz_chunk_gate(engine, groups=None):
    """Z3: each group's qwZ gather (the head group, every chunk) against
    the exact fp32 gather of the same master: |q − exact| ≤ scale / 2 per
    element (scale = amax / 127 of its block of its rank's row), plus
    fp32 rounding."""
    import torch
    from deepspeed_tpu_torch.ops.quant_kernels import DEFAULT_BLOCK as B
    from deepspeed_tpu_torch.parallel import stage3 as S3

    out = []
    W = engine.shard_world
    with torch.no_grad():
        for i, grp in enumerate(groups or engine._zero3.groups):
            q = S3.gather_group(grp, engine, engine.flat_master, True)
            ex = S3.gather_group(grp, engine, engine.flat_master, False)
            step = ex.abs().view(W, -1, B).amax(-1) / 127.0
            bound = (step / 2).repeat_interleave(B, dim=1)
            err = (q - ex).abs()
            over = err > bound * (1 + 1e-6) + 1e-6 * ex.abs()
            out.append({"group": i, "layers": grp.layers,
                        "elements": ex.numel(),
                        "max_over_bound": float(
                            (err / bound.clamp_min(1e-30)).max()),
                        "out_of_bound": int(over.sum())})
            del q, ex, err, over, bound
    return out


def zero3_stats(engine):
    z = engine._zero3
    return {"zero3_counts": dict(z.counts),
            "gathers_per_micro": z.gathers_per_micro(),
            "chunk_bounds": [list(b) for b in
                             engine.overlap_plan()["chunk_bounds"]],
            "groups": len(z.groups)}


def zero3_exposed(engine, data, dev):
    """One step with the next chunk's gather in flight (overlap_comm on),
    one with every gather issued where it is used (what overlap_comm off
    builds on the exact wire: the same chunks, no prefetch), on the same
    engine: the step's wall and the host ms it waited on the wire (the
    gathers' and the reduces' waits: the wire time left exposed)."""
    from deepspeed_tpu_torch import telemetry

    out = {}
    for label, on in (("overlap_on", True), ("overlap_off", False)):
        engine._zero3.prefetch = on
        telemetry.reset()
        dev_sync(dev)
        t0 = time.perf_counter()
        engine.train_batch(data)
        dev_sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        hist = telemetry.get_registry().histogram("span_seconds")
        spans = {sp: hist.summary(span=sp).get("sum", 0.0) * 1e3
                 for sp in ZERO3_SPANS}
        out[label] = {"step_ms": wall, "host_span_ms": spans,
                      "exposed_wire_ms": spans["zero3_gather_wait"]
                      + spans["zero3_reduce_wait"]}
    engine._zero3.prefetch = True
    return out


def zero3_gate_step(t, dev, master, batch, zero, precision):
    """One step (gas 1, the gate's micro, ``t["gate_layers"]`` layers at
    full width) from ``master`` (None: this engine's own initial master,
    returned) → (master, sharded elements, loss, reduced gradient,
    update)."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import load_master

    spec = dtt.causal_lm_spec(
        t["model"], attention="flash", remat="full",
        num_layers=t["gate_layers"],
        dtype="float32" if precision == "fp32" else "bfloat16")
    engine, *_ = dtt.initialize(model=spec, config=zeropp_config(
        t["gate_micro"], 1, precision, zero), device=dev)
    if master is None:
        master = engine.full_master()
    else:
        load_master(engine, master)
    before = engine.flat_master.clone()
    loss = float(engine.train_batch(iter([batch])))
    grad = engine.flat_grad_acc.float()
    update = engine.flat_master - before
    n_sh = engine._n_sh
    if hasattr(engine, "close"):
        engine.close()
    del before, engine
    return master, n_sh, loss, grad, update


def zero3_gates(t, dev, batch):
    """Z1 and Z2's numbers: fp32 and bf16 steps of exact ZeRO-2 and exact
    ZeRO-3 from one master and one batch, each against the fp32 ZeRO-2
    step (the local buffers share ZeRO-2's layout)."""
    import torch
    from deepspeed_tpu_torch.comm import comm

    res, ref, master = {}, None, None
    for way, zero, prec in (("fp32_zero2", ZEROPP_EXACT, "fp32"),
                            ("fp32_zero3", ZERO3_EXACT, "fp32"),
                            ("bf16_zero2", ZEROPP_EXACT, "bf16"),
                            ("bf16_zero3", ZERO3_EXACT, "bf16")):
        master, n_sh, loss, grad, upd = zero3_gate_step(
            t, dev, master, batch, zero, prec)
        row = {"loss": loss}
        if ref is None:
            ref = {"loss": loss, "grad": grad, "upd": upd,
                   "g2": gathered_sq(n_sh, grad), "u2": gathered_sq(n_sh, upd)}
        else:
            miss = ((upd > 0) != (ref["upd"] > 0)) & (
                (upd != 0) | (ref["upd"] != 0))
            nz = ((upd != 0) | (ref["upd"] != 0))
            counts = torch.stack([miss[:n_sh].sum(), nz[:n_sh].sum(),
                                  miss[n_sh:].sum(), nz[n_sh:].sum()]).double()
            comm.all_reduce(counts[:2])
            row.update(
                loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                grad_rel=gathered_sq(n_sh, grad - ref["grad"]) ** 0.5
                / ref["g2"] ** 0.5,
                update_rel=gathered_sq(n_sh, upd - ref["upd"]) ** 0.5
                / ref["u2"] ** 0.5,
                sign_miss=float((counts[0] + counts[2])
                                / (counts[1] + counts[3]).clamp(min=1)))
        res[way] = row
        del grad, upd
        dev_free(dev)
    res["bf16_loss_bit_equal"] = res["bf16_zero3"]["loss"] == \
        res["bf16_zero2"]["loss"]
    res["gate_layers"] = t["gate_layers"]
    return res


def mlp_spec(width, layers):
    """A spec without the parameter hook: ``layers`` dense layers of
    ``width`` (GELU between them) with a mean-squared regression loss; the
    ZeRO layout shards each leaf's largest dim."""
    import torch

    import deepspeed_tpu_torch as dtt

    names = [f"layer{i}" for i in range(layers)]

    def init_fn(gen, device):
        return {n: {"w": torch.randn(width, width, generator=gen,
                                     device=device) / width ** 0.5,
                    "b": torch.zeros(width, device=device)} for n in names}

    def loss_fn(p, batch):
        h = batch["x"]
        for i, n in enumerate(names):
            h = h @ p[n]["w"] + p[n]["b"]
            if i < layers - 1:
                h = torch.nn.functional.gelu(h)
        return torch.mean(torch.square(h - batch["y"]))

    return dtt.ModelSpec(
        init_fn=init_fn, loss_fn=loss_fn, name=f"mlp_{layers}x{width}",
        num_params=layers * (width * width + width),
        axes_fn=lambda: {n: {"w": (None, None), "b": (None,)}
                         for n in names})


def mlp_batches(seed, m, rows):
    """``m["gas"]`` micro-batches of ``rows`` global rows, from ``seed``."""
    rng = np.random.default_rng(seed)
    return [{k: rng.standard_normal((rows, m["width"]), dtype=np.float32)
             for k in ("x", "y")} for _ in range(m["gas"])]


def mlp_run(dev, zero, micro, seed, m, path=None):
    """The MLP spec through ``initialize`` + ``train_batch`` in fp32: the
    initial master, the losses and grad norms of ``m["steps"]`` steps and
    the master after step 1 (whole trees on the CPU, flattened); saved to
    ``path`` when given. Collective on a data-parallel engine."""
    import torch

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master

    def flat():
        return torch.cat([torch.as_tensor(v).reshape(-1) for _, v in sorted(
            _flat_items(gather_master(engine)))])

    world = dtt.comm.get_world_size()
    engine, *_ = dtt.initialize(model=mlp_spec(m["width"], m["layers"]),
                                config=zeropp_config(micro, m["gas"], "fp32",
                                                     zero), device=dev)
    batches = mlp_batches(seed, m, micro * world)
    out = {"type": type(engine).__name__, "m0": flat(), "losses": [],
           "norms": [], "counts": []}
    t0 = time.perf_counter()
    for step in range(m["steps"]):
        out["losses"].append(float(engine.train_batch(iter(batches))))
        out["norms"].append(engine.get_global_grad_norm())
        if hasattr(engine, "_zero3"):
            out["counts"].append(dict(engine._zero3.counts))
        if step == 0:
            out["m1"] = flat()
    dev_sync(dev)
    out["seconds"] = time.perf_counter() - t0
    if hasattr(engine, "close"):
        engine.close()
    del engine
    dev_free(dev)
    if path is not None:
        torch.save(out, path)
    return out


def _flat_items(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat_items(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def mlp_gate(got, ref):
    """ZeRO-3 at world 2 against world 1 without ZeRO by the training
    rule: the same initial master, every step's loss and grad norm, the
    update of step 1."""
    update = ((got["m1"] - got["m0"]) - (ref["m1"] - ref["m0"])).norm() \
        / (ref["m1"] - ref["m0"]).norm()
    res = {"init_bit_equal": bool(same_bits(got["m0"], ref["m0"])),
           "loss_rel": [abs(a - b) / abs(b) for a, b in
                        zip(got["losses"], ref["losses"])],
           "norm_rel": [abs(a - b) / abs(b) for a, b in
                        zip(got["norms"], ref["norms"])],
           "update_rel": float(update)}
    problems = []
    if not res["init_bit_equal"]:
        problems.append("MLP: initial master differs from world 1's")
    if not max(res["loss_rel"]) <= TRAIN_LOSS_REL:
        problems.append(f"MLP loss rel {res['loss_rel']}")
    if not max(res["norm_rel"]) <= TRAIN_NORM_REL:
        problems.append(f"MLP grad norm rel {res['norm_rel']}")
    if not res["update_rel"] <= TRAIN_UPDATE_REL:
        problems.append(f"MLP update rel {res['update_rel']:.3g}")
    return res, problems


def train_llama_750m_zero3_dp2_rank(rank, world, seed, t):
    """One rank of the ZeRO-3 phase (``t``: ZERO3, the device, whether to
    run the ZeRO-2 baseline): run (a) exact ZeRO-3 — the main path, the
    overlap on/off steps, its profile; run (b) ZeRO-3 + qgZ + qwZ + LoCo —
    the main path, the wire gate, the qwZ chunk gate; the Z1-Z2 gate
    steps; run (c) exact ZeRO-2 when asked."""
    import torch
    from deepspeed_tpu_torch.models import transformer as T

    dev = torch.device(t["device"])
    vocab = T.get_model_config(t["model"]).vocab_size
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (t["micro"] * world, t["seq"]),
                                    dtype=np.int32)}
    out = {"rank": rank}
    engine, data, out["exact"] = zeropp_run(t, dev, ZERO3_EXACT, batch)
    out["exact"].update(zero3_stats(engine))
    out["exposed"] = zero3_exposed(engine, data, dev)
    out["exact_profile"] = zeropp_profile(
        engine, data, dev, profiled=rank == 0 and dev.type == "cuda")
    engine.close()
    del engine, data
    dev_free(dev)
    engine, data, out["wire"] = zeropp_run(t, dev, ZERO3_WIRE, batch)
    out["wire"].update(zero3_stats(engine))
    out["wire_profile"] = zeropp_profile(engine, data, dev, profiled=False)
    out["wire_gate"] = wire_gates(engine, batch, dev)
    out["qwz_gate"] = qwz_chunk_gate(engine)
    engine.close()
    del engine, data
    dev_free(dev)
    gate_batch = {"tokens": batch["tokens"][:t["gate_micro"] * world]}
    out["gates"] = zero3_gates(t, dev, gate_batch)
    if t["baseline"]:
        engine, data, out["baseline"] = zeropp_run(t, dev, ZEROPP_EXACT,
                                                   batch)
        engine.close()
        del engine, data
        dev_free(dev)
    if t.get("mlp_ref"):
        import torch

        m = t["mlp"]
        got = mlp_run(dev, {"stage": 3}, m["micro"], seed, m)
        out["mlp"], out["mlp_problems"] = mlp_gate(
            got, torch.load(t["mlp_ref"]))
        out["mlp"].update(type=got["type"], counts=got["counts"],
                          losses=got["losses"], seconds=got["seconds"])
    return out


def hpz_traffic_want(n_rows, n_sh, n_rep, gas, steps, wire, Z=HPZ_Z,
                     block=2048):
    """H4: the collectives a rank of the hpZ phase issues in ``steps``
    steps, by group and kind → [calls, elements it sends in]. ``n_rows``:
    the ZeRO-3 groups' packed rows (the head group first), ``n_sh`` /
    ``n_rep``: the rank's sharded / replicated elements. Per micro-batch,
    on ``zshard``: each group gathered in the forward and each chunk again
    in the recompute (int8: q and its scales, two calls a gather); the
    exact wire's reduce of each group, a reduce-scatter of Z rows. On
    ``data``, only the gradient's replica hop: the exact wire's all-reduce
    of the rank's row of each group, or the int8 wire's gathers of q and
    scales of the rank's reduced shard [n_sh]; the int8 wire's first hop
    is qgZ's all-to-all of q and scales [Z x n_sh] on ``zshard``. On
    ``world``: the replicated leaves' all-reduce (int8: a micro-batch,
    exact: a step). Per step: the loss mean (``world``, 1 element) and the
    norm's sum of squares (``zshard``, 1 element: each shard is held once
    a zshard group). No parameter gather runs on ``data``."""
    gathers = [n_rows[0]] + 2 * list(n_rows[1:])
    micros = gas * steps
    want = {}

    def add(key, calls, elements):
        c = want.setdefault(key, [0, 0])
        c[0] += calls
        c[1] += elements

    if wire:
        add("zshard/all_gather", 2 * len(gathers) * micros,
            sum(n + n // block for n in gathers) * micros)
        add("zshard/all_to_all", 2 * micros,
            (Z * n_sh + Z * n_sh // block) * micros)
        add("data/all_gather", 2 * micros, (n_sh + n_sh // block) * micros)
        if n_rep:
            add("world/all_reduce", micros, n_rep * micros)
    else:
        add("zshard/all_gather", len(gathers) * micros, sum(gathers) * micros)
        add("zshard/reduce_scatter", len(n_rows) * micros,
            Z * sum(n_rows) * micros)
        add("data/all_reduce", len(n_rows) * micros, sum(n_rows) * micros)
        if n_rep:
            add("world/all_reduce", steps, n_rep * steps)
    add("world/all_reduce", steps, steps)
    add("zshard/all_reduce", steps, steps)
    return want


def hpz_traffic_problems(traffic, want):
    """H4: each group's calls and elements against ``hpz_traffic_want``
    (the seconds are reported, not held)."""
    got = {k: [int(v[0]), int(v[1])] for k, v in traffic.items()}
    out = [f"{k}: {got.get(k)}, want {v}" for k, v in want.items()
           if got.get(k) != v]
    out += [f"{k}: {v}, want none" for k, v in got.items() if k not in want]
    return out


def hpz_wire_seconds(traffic):
    """Host seconds in each group's collectives (the queue's worker thread
    included)."""
    out = {}
    for k, v in traffic.items():
        group = k.split("/")[0]
        out[group] = out.get(group, 0.0) + v[2]
    return out


def hpz_run(t, dev, zero, batch):
    """The main path of one hpZ config on this rank, with ZeRO-3's gather
    and reduce counts, its groups' packed rows and the rank's mesh
    coordinates."""
    import torch

    engine, data, run = zeropp_run(t, dev, zero, batch)
    run.update(zero3_stats(engine))
    mm = engine.mesh_manager
    run.update(n_rows=[g.n_row for g in engine._zero3.groups],
               shard_world=engine.shard_world, shard_rank=engine.shard_rank,
               coords={a: mm.coords[a] for a in ("data", "zshard")},
               zshard_ranks=list(mm.group_ranks(("zshard",))),
               data_ranks=list(mm.group_ranks(("data",))),
               card_bytes=(torch.cuda.get_device_properties(dev).total_memory
                           if dev.type == "cuda" else 0))
    return engine, data, run


def replica_gate(engine, batch, dev):
    """H3 on the step's real reduced shard: one more micro-batch's
    gradient packed as the wire sends it, through qgZ's first hop (the
    sum over ``zshard``); then the replica hop's quantize and dequant-
    reduce kernels on that shard against their plain versions, bit for
    bit; and the int8 two-hop mean against the exact two-hop mean within
    half a quantization step a hop: Σ over the replicas of each one's
    first-hop bound Σ_z s_z / 2, plus Σ_d s_d / 2 of the replica hop, ÷
    the world, per element (scales of its block), plus fp32 rounding."""
    import torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops import quant_kernels as QK
    from deepspeed_tpu_torch.runtime.dataloader import stack_micros

    W, Z, D, B = (engine.world, engine.shard_world, engine.replica_world,
                  QK.DEFAULT_BLOCK)
    zg, dg = engine.shard_group, engine.replica_group
    mb = engine._to_device(engine._local_rows(stack_micros([batch])))
    mb = {k: v[0] for k, v in mb.items()}
    with engine._step_buffers():        # the step's full gradient
        engine._loss_and_grads(mb, None)
        engine._pack()
        x = engine._packed
    n = x.shape[1]
    with torch.no_grad():
        exact = torch.empty(n, dtype=torch.float32, device=dev)
        comm.reduce_scatter_tensor(exact, x, group=zg)
        comm.all_reduce(exact, group=dg)
        q, sc = QK.quantize_int8_blocks(x.view(-1))
        del x
        qa = comm.all_to_all_single(q.view(Z, -1), zg)
        sa = comm.all_to_all_single(sc.view(Z, -1), zg)
        del q, sc
        mine = QK.dequant_reduce(qa, sa)             # the first hop's sum
        hop1 = sa.sum(0) / 2                          # [n / B]
        del qa, sa
        q2, s2 = QK.quantize_int8_blocks(mine)
        step = 2 ** 26
        q_equal = s_equal = red_equal = True
        for i in range(0, n, step):
            rq, rs = QK.quantize_int8_blocks_ref(mine[i:i + step])
            q_equal &= same_bits(q2[i:i + step], rq)
            s_equal &= same_bits(s2[i // B:(i + step) // B], rs)
        del rq, rs, mine
        qg = torch.empty((D, n), dtype=q2.dtype, device=dev)
        sg = torch.empty((D, n // B), dtype=s2.dtype, device=dev)
        comm.all_gather_into_tensor(qg, q2, dg)
        comm.all_gather_into_tensor(sg, s2, dg)
        del q2, s2
        red = QK.dequant_reduce(qg, sg)               # the replica hop's sum
        for i in range(0, n, step):
            red_equal &= same_bits(red[i:i + step], QK.dequant_reduce_ref(
                qg[:, i:i + step].contiguous(),
                sg[:, i // B:(i + step) // B].contiguous()))
        del qg
        bound = (comm.all_reduce(hop1, group=dg) + sg.sum(0) / 2) / W
        ratio, over = 0.0, 0
        for i in range(0, n, step):
            got = red[i:i + step].view(-1, B) / W
            ex = exact[i:i + step].view(-1, B) / W
            b = bound[i // B:(i + step) // B, None]
            err = (got - ex).abs()
            over += int((err > b * (1 + 1e-6) + 1e-6 * ex.abs()).sum())
            ratio = max(ratio, float((err / b.clamp_min(1e-30)).max()))
    return {"elements": n, "replicas": D, "q_bitwise_equal": q_equal,
            "scales_bitwise_equal": s_equal,
            "reduced_bitwise_equal": red_equal,
            "two_hop_err_max_over_bound": ratio,
            "two_hop_err_out_of_bound": over}


def hpz_gate_step(t, dev, master, batch, zero, precision):
    """One step (gas 1, the gate's micro, ``t["gate_layers"]`` layers at
    full width) from ``master`` (None: this engine's own initial master,
    returned) → (master, loss, reduced gradient, update), the last two as
    whole flat fp32 vectors on the device (the layouts at data = 4 and
    under hpZ differ)."""
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import load_master
    from deepspeed_tpu_torch.runtime.engine import _flatten

    def flat(tree):
        return torch.cat([v.reshape(-1) for _, v in _flatten(tree)])

    spec = dtt.causal_lm_spec(
        t["model"], attention="flash", remat="full",
        num_layers=t["gate_layers"],
        dtype="float32" if precision == "fp32" else "bfloat16")
    engine, *_ = dtt.initialize(model=spec, config=zeropp_config(
        t["gate_micro"], 1, precision, zero), device=dev)
    if master is None:
        master = engine.full_master()
    else:
        load_master(engine, master)
    before = engine.flat_master.clone()
    loss = float(engine.train_batch(iter([batch])))
    grad = flat(engine.full_tree(engine.flat_grad_acc, dev))
    update = flat(engine.full_tree(engine.flat_master - before, dev))
    if hasattr(engine, "close"):
        engine.close()
    del before, engine
    return master, loss, grad, update


def hpz_gates(t, dev, batch):
    """H1 and H2's numbers: each HPZ_GATES step from one master and one
    batch against its HPZ_GATE_REF step (whole vectors: every rank
    computes the same numbers)."""
    import torch

    res, kept, master = {}, {}, None
    for way, zero, prec in HPZ_GATES:
        master, loss, grad, upd = hpz_gate_step(t, dev, master, batch, zero,
                                                prec)
        row = {"loss": loss}
        ref = kept.get(HPZ_GATE_REF.get(way))
        if ref is not None:
            miss = ((upd > 0) != (ref["upd"] > 0)) & (
                (upd != 0) | (ref["upd"] != 0))
            nz = (upd != 0) | (ref["upd"] != 0)
            row.update(
                loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                grad_rel=float(torch.linalg.vector_norm(grad - ref["grad"])
                               / torch.linalg.vector_norm(ref["grad"])),
                update_rel=float(torch.linalg.vector_norm(upd - ref["upd"])
                                 / torch.linalg.vector_norm(ref["upd"])),
                sign_miss=float(miss.sum() / nz.sum().clamp(min=1)))
            del miss, nz
        if way in HPZ_GATE_REF.values():
            kept[way] = {"loss": loss, "grad": grad, "upd": upd}
        if way == "bf16_hpz_zero3":
            kept.pop("fp32_d4_zero3")
        res[way] = row
        del grad, upd, ref
        dev_free(dev)
    res["bf16_loss_bit_equal"] = res["bf16_hpz_zero3"]["loss"] == \
        res["bf16_d4_zero3"]["loss"]
    res["gate_layers"] = t["gate_layers"]
    return res


def hpz_gate_problems(g):
    """H1: the fp32 hpZ steps (ZeRO-3 and ZeRO-2) against the same steps at
    data = 4 by the training parity rule; H2: the bf16 hpZ ZeRO-3 loss
    bit-equal to data = 4's, its update no further from the fp32 step than
    BF16_VS_PLAIN times data = 4's bf16 update."""
    out = []
    for way in ("fp32_hpz_zero3", "fp32_hpz_zero2"):
        z = g[way]
        for m, lim in (("loss_rel", TRAIN_LOSS_REL),
                       ("grad_rel", TRAIN_GRAD_REL),
                       ("update_rel", TRAIN_UPDATE_REL),
                       ("sign_miss", TRAIN_SIGN_MISS)):
            if not z[m] <= lim:
                out.append(f"H1 {way} {m} {z[m]:.3g} > {lim}")
    b, d = g["bf16_hpz_zero3"], g["bf16_d4_zero3"]
    if b["loss"] != d["loss"]:
        out.append(f"H2 bf16 loss {b['loss']!r}, data = 4's {d['loss']!r}")
    if not b["update_rel"] <= BF16_VS_PLAIN * d["update_rel"]:
        out.append(f"H2 bf16 update_rel {b['update_rel']:.3g} > "
                   f"{BF16_VS_PLAIN} x data = 4's {d['update_rel']:.3g}")
    return out


def train_llama_750m_hpz_dp4_rank(rank, world, seed, t):
    """One rank of the hpZ phase (``t``: HPZ and the device): run (a) the
    ZeRO++ trio — the main path and the replica-hop gate H3; run (b) MiCS
    at stage 3 — the main path; then the H1-H2 gate steps."""
    import torch
    from deepspeed_tpu_torch.models import transformer as T

    dev = torch.device(t["device"])
    vocab = T.get_model_config(t["model"]).vocab_size
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (t["micro"] * world, t["seq"]),
                                    dtype=np.int32)}
    out = {"rank": rank}
    for run, zero in (("trio", HPZ_TRIO), ("mics", HPZ_MICS)):
        engine, data, out[run] = hpz_run(t, dev, zero, batch)
        if run == "trio":
            out["replica_gate"] = replica_gate(engine, batch, dev)
        engine.close()
        del engine, data
        dev_free(dev)
    gate_batch = {"tokens": batch["tokens"][:t["gate_micro"] * world]}
    out["gates"] = hpz_gates(t, dev, gate_batch)
    return out


# --------------------------------------------------------------------------- #
# The expert-parallel phase (train_moe_350m_ep)
# --------------------------------------------------------------------------- #
# moe_350m at full width (hidden 768, 4 experts top-2, LayerNorm), bf16 with
# an fp32 master, ZeRO-2 on the exact wire, flash, remat full, Adam lr 1e-4,
# one fixed batch from the seed; the ranks share the one card over gloo.
# (a) mesh {expert: 2} at world 2, all 12 layers: micro 8 a rank (the
# one-process cell's micro 16 in all), seq 1024, gas 2, 1 warm-up + 2
# steps; each rank holds 2 of the 4 experts, the choices travel by
# all-to-all (at ep 2 the per-destination buffer holds every local choice:
# dropless). (b) mesh {data: 2, expert: 2} at world 4, MOE_EP_B["layers"]
# layers at full width, micro 4 a rank, gas 1: the expert leaves' gradient
# reduced over the data group. Gates:
# E1 one fp32 step of (a) (the gate's micro a rank, gas 1) by the training
#    rule (loss, grad norm, gradient, update, sign misses, routing
#    agreement, aux loss) against the same step of the same ranks without
#    the expert axis (mesh {data: world}: each rank's rows through the same
#    dense GEMM shapes), and against the one-process engine on the same
#    global micro-batch and weights by the loss, the grad norm and the
#    routing agreement. The one-process engine runs the dense GEMMs over
#    twice the rows, which cuBLAS sums in another order; at full depth two
#    of 49,152 (token, choice) pairs flipped at near-ties (chip call 1 of
#    the PR that added this phase: route miss 4.1e-5, the flipped experts'
#    weight gradients moved by a token's share: gradient 1.1e-4, update
#    3.4e-3, aux 1.3e-5 relative), which the gradient, update and aux
#    limits, set for identical routing, cannot hold across;
# E2 the bf16 step of (a) no further from E1's fp32 step than BF16_VS_PLAIN
#    times the one-process plain bf16 step from the one-process fp32 one;
# E3 the grouped GEMM kernel (gmm, and tgmm of a seeded gradient) on a
#    rank's real received buffer against its plain version on the routed
#    rows, the buffer's empty tail written as zeros;
# E4 the expert group's all-to-alls and the batch group's all-reduces a
#    step by formula (moe_ep_traffic_want), the dropped share 0;
# E5 one fp32 step of (b), the same two comparisons at its depth.
MOE_EP = dict(model="moe_350m", world=2, mesh={"expert": 2}, micro=8,
              seq=1024, gas=2, steps=2, gate_micro=1)
MOE_EP_B = dict(MOE_EP, world=4, mesh={"data": 2, "expert": 2}, micro=4,
                gas=1, layers=4)
MOE_EP_ZERO = {"stage": 2}


def moe_ep_traffic_want(L, gas, steps, micro, seq, k, ep, H, E):
    """E4: a rank's MoE collectives in ``steps`` steps → {group/kind:
    [calls, elements it sends in]}. Per layer and micro-batch, on the
    expert group: the forward's rows, expert ids and rows back (a buffer
    of ep · Cs rows, Cs = ep_shard_capacity(micro · seq · k, ep)), again
    in remat's recompute, and the backward's two row exchanges. On the
    batch group: the aux loss's mean of [me, ce] (2 E elements) in the
    forward, the recompute and the backward, and the drop monitor's count
    (2 elements) in the forward and the recompute."""
    from deepspeed_tpu_torch.moe.layer import ep_shard_capacity

    rows = ep * ep_shard_capacity(micro * seq * k, ep)
    n = L * gas * steps
    return {"expert/all_to_all": [8 * n, n * (6 * rows * H + 2 * rows)],
            "batch/all_reduce": [5 * n, n * (3 * 2 * E + 2 * 2)]}


def moe_ep_launches_want(L, gas, steps, n_w, adam_per_step):
    """The kernel launches of an MoE rank in ``steps`` steps (remat full):
    flash forward twice a layer, dq and dkv once; the LayerNorm 4 a layer
    and the final one; each expert weight's gmm in the forward, the
    recompute and the input gradient, its tgmm once; Adam by the plan."""
    micros = gas * steps
    return {"flash_fwd": 2 * L * micros, "flash_bwd_dq": L * micros,
            "flash_bwd_dkv": L * micros, "layer_norm": (4 * L + 1) * micros,
            "gmm": 3 * n_w * L * micros, "tgmm": n_w * L * micros,
            "fused_adam": adam_per_step * steps, "quant_int8": 0,
            "dequant_reduce": 0, "block_sparse_fwd": 0, "paged_attention": 0}


def _flat_tree(tree):
    import torch
    from deepspeed_tpu_torch.runtime.engine import _flatten

    return torch.cat([v.reshape(-1).float() for _, v in _flatten(tree)])


def moe_ep_batch(t, seed):
    from deepspeed_tpu_torch.models import transformer as T

    vocab = T.get_model_config(t["model"]).vocab_size
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (t["micro"] * t["world"],
                                              t["seq"]), dtype=np.int32)}


def moe_ep_spec(t, precision, use_kernels=True):
    import deepspeed_tpu_torch as dtt

    depth = {"num_layers": t["layers"]} if t.get("layers") else {}
    return dtt.causal_lm_spec(
        t["model"], attention="flash", remat="full", use_kernels=use_kernels,
        dtype="float32" if precision == "fp32" else "bfloat16", **depth)


def moe_ep_step(engine, tokens, L, dev):
    """One step of ``engine`` on ``tokens`` → loss, grad norm, the whole
    gradient and update as flat fp32 vectors (every leaf, sorted keys),
    the routes [L, rows, k] of this process's rows and the summed aux."""
    import torch

    before = engine.flat_master.clone()
    with recorded_routes() as routes, recorded_aux() as auxes:
        loss = float(engine.train_batch(iter([{"tokens": tokens}])))
    norm = engine.get_global_grad_norm()
    if hasattr(engine, "full_tree"):
        grad = _flat_tree(engine.full_tree(engine.flat_grad_acc, dev))
        upd = _flat_tree(engine.full_tree(engine.flat_master - before, dev))
    else:
        grad = _flat_tree(engine._views(engine.flat_grad_acc))
        upd = _flat_tree(engine._views(engine.flat_master - before))
    del before
    idx = torch.stack([r[0] for r in routes[:L]])
    aux = float(sum(float(a) for a in auxes[:L]))
    return loss, norm, grad, upd, idx, aux


def step_metrics(loss, norm, grad, upd, idx, aux, ref):
    """The training rule's metrics of one step against ``ref`` (the same
    keys; ``idx`` may be a slice of the reference's rows: ``ref_idx``)."""
    import torch

    miss = ((upd > 0) != (ref["upd"] > 0)) & ((upd != 0) | (ref["upd"] != 0))
    nz = (upd != 0) | (ref["upd"] != 0)
    out = {"loss": loss, "grad_norm": norm,
           "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
           "norm_rel": abs(norm - ref["norm"]) / ref["norm"],
           "grad_rel": float(torch.linalg.vector_norm(grad - ref["grad"])
                             / torch.linalg.vector_norm(ref["grad"])),
           "update_rel": float(torch.linalg.vector_norm(upd - ref["upd"])
                               / torch.linalg.vector_norm(ref["upd"])),
           "sign_miss": float(miss.sum() / nz.sum().clamp(min=1)),
           "aux_rel": abs(aux - ref["aux"]) / abs(ref["aux"])}
    ref_idx = ref["idx"] if ref.get("ref_idx") is None else ref["ref_idx"]
    out["route_miss"] = float((idx != ref_idx.to(idx.device)).float().mean())
    return out


MOE_EP_LIMITS = {"loss_rel": TRAIN_LOSS_REL, "norm_rel": TRAIN_NORM_REL,
                 "grad_rel": TRAIN_GRAD_REL, "update_rel": TRAIN_UPDATE_REL,
                 "sign_miss": TRAIN_SIGN_MISS,
                 "route_miss": 1 - ROUTE_AGREE_MIN, "aux_rel": TRAIN_LOSS_REL}
# what E1 / E5 hold against the one-process engine (see E1 above)
MOE_EP_ONE_PROCESS = ("loss_rel", "norm_rel", "route_miss")


def moe_ep_reference(t, dev, seed, path, plain_bf16=True):
    """The one-process engine's fp32 step on the gate's global micro-batch
    (``gate_micro`` rows a rank of the phase, gas 1), from the seed's
    weights; its whole gradient and update saved beside ``path`` (numpy
    files the ranks map), and with ``plain_bf16`` the one-process plain
    bf16 step's metrics against it (E2's yardstick). Returns what the
    ranks read."""
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import transformer as T

    L = T.get_model_config(t["model"], **({"num_layers": t["layers"]}
                                          if t.get("layers") else {})
                           ).num_layers
    tokens = moe_ep_batch(t, seed)["tokens"][:t["gate_micro"] * t["world"]]
    out = {"tokens_rows": len(tokens), "layers": L}
    ref = None
    for prec, use_kernels in (("fp32", True),) + (
            (("bf16", False),) if plain_bf16 else ()):
        config = Smoke.train_config(len(tokens), 1, prec)
        config["zero_optimization"] = dict(MOE_EP_ZERO)
        engine, *_ = dtt.initialize(model=moe_ep_spec(t, prec, use_kernels),
                                    config=config, device=dev)
        loss, norm, grad, upd, idx, aux = moe_ep_step(engine, tokens, L, dev)
        del engine
        dev_free(dev)
        if ref is None:
            ref = {"loss": loss, "norm": norm, "grad": grad, "upd": upd,
                   "idx": idx, "aux": aux}
            np.save(path + ".grad.npy", grad.cpu().numpy())
            np.save(path + ".upd.npy", upd.cpu().numpy())
            out.update(loss=loss, norm=norm, aux=aux, idx=idx.cpu(),
                       grad_path=path + ".grad.npy",
                       upd_path=path + ".upd.npy")
        else:
            out["plain_bf16"] = step_metrics(loss, norm, grad, upd, idx, aux,
                                             ref)
        del grad, upd
    del ref
    dev_free(dev)
    return out


def moe_ep_load_ref(ref, dev):
    import torch

    return dict(ref, grad=torch.from_numpy(np.load(ref["grad_path"])).to(dev),
                upd=torch.from_numpy(np.load(ref["upd_path"])).to(dev),
                idx=ref["idx"].to(dev))


def moe_ep_gates(t, dev, ref, bf16=True):
    """E1 (E5 at (b)): one fp32 EP step from the seed's weights on the
    gate's rows against the same step at mesh {data: world} (the same
    ranks without the expert axis) and against the one-process reference
    ``ref``; with ``bf16``, E2's bf16 EP step against the fp32 EP step.
    Every rank computes the same numbers (whole vectors; the routing
    agreement over every rank's rows)."""
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import comm

    rank, world = comm.get_rank(), comm.get_world_size()
    rows = t["gate_micro"] * world
    tokens = moe_ep_batch(t, 0 if t.get("seed") is None else t["seed"])[
        "tokens"][:rows]
    n, seq = rows // world, tokens.shape[1]
    L = ref["layers"]
    one = moe_ep_load_ref(ref, dev)
    # this rank's token rows of the reference's routes [L, T, k]
    one["ref_idx"] = one["idx"][:, rank * n * seq:(rank + 1) * n * seq]
    ways = [("ep32", "fp32", t["mesh"]), ("dp32", "fp32", {"data": world})]
    if bf16:
        ways.append(("ep16", "bf16", t["mesh"]))
    kept, res = {}, {}

    def metrics(step, against):
        row = step_metrics(*step, against)
        # the routing agreement over every rank's rows
        miss = torch.tensor([row["route_miss"]], dtype=torch.float64,
                            device=dev)
        comm.all_reduce(miss, op=comm.ReduceOp.AVG)
        row["route_miss"] = float(miss)
        return row

    for way, prec, mesh in ways:
        config = zeropp_config(t["gate_micro"], 1, prec, MOE_EP_ZERO)
        config["mesh"] = dict(mesh)
        engine, *_ = dtt.initialize(model=moe_ep_spec(t, prec), config=config,
                                    device=dev)
        # every rank's iterator yields the global micro-batch; the engine
        # takes its rows
        step = moe_ep_step(engine, tokens, L, dev)
        engine.close()
        del engine
        kept[way] = dict(zip(("loss", "norm", "grad", "upd", "idx", "aux"),
                             step), ref_idx=None)
        del step
        dev_free(dev)
    ep32 = kept["ep32"]
    args = tuple(ep32[k] for k in ("loss", "norm", "grad", "upd", "idx",
                                   "aux"))
    res["fp32"] = metrics(args, kept.pop("dp32"))
    res["fp32_one_process"] = metrics(args, one)
    if bf16:
        e16 = kept.pop("ep16")
        res["bf16"] = metrics(tuple(e16[k] for k in (
            "loss", "norm", "grad", "upd", "idx", "aux")), ep32)
        res["plain_bf16"] = ref["plain_bf16"]
    del kept, one, ep32, args
    dev_free(dev)
    return res


def moe_ep_gate_problems(g, label):
    """E1 / E5: the fp32 EP step by the training rule against the step
    without the expert axis, and by MOE_EP_ONE_PROCESS against the
    one-process engine; E2: the bf16 EP step's distance from the fp32 EP
    step at most BF16_VS_PLAIN times the plain bf16 path's (the aux and
    loss floored at the fp32 limit)."""
    out = [f"{label} fp32 {m} {g['fp32'][m]:.3g} > {lim}"
           for m, lim in MOE_EP_LIMITS.items() if not g["fp32"][m] <= lim]
    one = g["fp32_one_process"]
    out += [f"{label} fp32 against one process {m} {one[m]:.3g} > "
            f"{MOE_EP_LIMITS[m]}" for m in MOE_EP_ONE_PROCESS
            if not one[m] <= MOE_EP_LIMITS[m]]
    if "bf16" in g:
        kb, pb = g["bf16"], g["plain_bf16"]
        floor = {m: MOE_EP_LIMITS[m] if m in BF16_FLOORED else 0.0
                 for m in MOE_EP_LIMITS}
        out += [f"E2 bf16 {m}: EP {kb[m]:.3g}, plain {pb[m]:.3g}"
                for m in MOE_EP_LIMITS
                if not kb[m] <= BF16_VS_PLAIN * max(pb[m], floor[m])]
    return out


@contextlib.contextmanager
def ep_buffer_capture():
    """Yields a dict that receives the first expert-parallel received
    buffer the grouped GEMMs run on (the sorted rows, their group sizes,
    the local w_up) while the block runs; the layer's function is
    restored after."""
    from deepspeed_tpu_torch.moe import layer as MoE

    fn, cap = MoE.ragged_expert_ffn, {}

    def capturing(x, group_sizes, experts, *args, **kwargs):
        if not cap:
            cap.update(x=x.detach().clone(), sizes=group_sizes.clone(),
                       w_up=experts["w_up"].detach().to(x.dtype).clone())
        return fn(x, group_sizes, experts, *args, **kwargs)

    MoE.ragged_expert_ffn = capturing
    try:
        yield cap
    finally:
        MoE.ragged_expert_ffn = fn


def ep_buffer_gate(cap, dev):
    """E3 on the captured buffer: gmm (the up projection) and tgmm (of a
    seeded gradient) kernel vs plain on the routed rows (GMM_TOL), the
    empty tail's output rows zero; the kernel's and the plain version's
    time there (CUDA events, median of 5)."""
    import torch
    from deepspeed_tpu_torch.ops import grouped_gemm as GG

    x, sizes, w = cap["x"], cap["sizes"], cap["w_up"]
    routed = int(sizes.sum())
    out = GG.gmm(x, w, sizes)
    plain = GG.gmm_ref(x, w, sizes)
    g = torch.randn(out.shape, generator=torch.Generator(dev).manual_seed(3),
                    device=dev).to(x.dtype)
    g[routed:] = 0
    tg, tg_plain = GG.tgmm(x, g, sizes), GG.tgmm_ref(x, g, sizes)
    dt = "bfloat16" if x.dtype == torch.bfloat16 else "float32"
    atol, rtol = GMM_TOL[dt]
    res = {"rows": x.shape[0], "routed_rows": routed,
           "group_sizes": sizes.tolist(), "K": x.shape[1], "N": w.shape[2]}
    for name, a, b in (("gmm", out[:routed], plain[:routed]),
                       ("tgmm", tg, tg_plain)):
        err = (a.float() - b.float()).abs()
        res[f"{name}_max_abs_err"] = float(err.max()) if err.numel() else 0.0
        res[f"{name}_close"] = bool(torch.allclose(a.float(), b.float(),
                                                   atol=atol, rtol=rtol))
    res["tail_zero"] = bool((out[routed:] == 0).all())
    if dev.type == "cuda":
        def ms(fn):
            walls = []
            for _ in range(5):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                fn()
                b.record()
                b.synchronize()
                walls.append(a.elapsed_time(b))
            return float(np.median(walls))

        res["gmm_ms"] = ms(lambda: GG.gmm(x, w, sizes))
        res["gmm_plain_ms"] = ms(lambda: GG.gmm_ref(x, w, sizes))
    return res


def train_moe_350m_ep_rank(rank, world, seed, t):
    """One rank of the expert-parallel phase (``t``: MOE_EP or MOE_EP_B,
    the device and the reference): the main path (the counters and the
    traffic to 0 just before the timed steps, read just after; the first
    received buffer captured in the warm-up step for E3), one more step
    profiled on rank 0, then the gate steps."""
    import torch

    dev = torch.device(t["device"])
    batch = moe_ep_batch(t, seed)
    out = {"rank": rank}
    with ep_buffer_capture() as cap:
        engine, data, run = zeropp_run(t, dev, MOE_EP_ZERO, batch)
    cfg = engine.model_spec.config
    mm = engine.mesh_manager
    run.update(drop_frac_max=float(engine._moe_drop_max),
               coords={a: mm.coords[a] for a in ("data", "expert")},
               local_experts=next(sl.shape[1] for sl in engine._slots
                                  if sl.path == ("blocks", "w_up")),
               expert_ranks=list(mm.group_ranks(("expert",))),
               card_bytes=(torch.cuda.get_device_properties(dev).total_memory
                           if dev.type == "cuda" else 0))
    run["traffic_want"] = moe_ep_traffic_want(
        cfg.num_layers, t["gas"], t["steps"], t["micro"], t["seq"],
        cfg.moe_top_k, mm.ep_world_size, cfg.hidden_size, cfg.n_experts)
    out["main"] = run
    out["e3"] = ep_buffer_gate(cap, dev)
    del cap
    out["profile"] = zeropp_profile(engine, data, dev, profiled=rank == 0)
    engine.close()
    del engine, data
    dev_free(dev)
    out["gates"] = moe_ep_gates(dict(t, seed=seed), dev, t["ref"],
                                bf16=t.get("layers") is None)
    return out


def moe_ep_problems(ranks, t, label):
    """The parent's checks of one run's ranks: the launches, E3, E4 (the
    traffic by formula, the dropped share 0), the losses, and E1/E2 (or
    E5)."""
    out = []
    r0 = ranks[0]["main"]
    for r in ranks:
        tag = f"{label} rank {r['rank']}"
        m = r["main"]
        for k, v in m["traffic_want"].items():
            got = [int(x) for x in m["traffic"].get(k, [0, 0])[:2]]
            if got != v:
                out.append(f"{tag}: E4 {k} {got}, want {v}")
        if m["drop_frac_max"] != 0:
            out.append(f"{tag}: E4 dropped share {m['drop_frac_max']}")
        e3 = r["e3"]
        for k in ("gmm_close", "tgmm_close", "tail_zero"):
            if not e3[k]:
                out.append(f"{tag}: E3 {k} false ({e3})")
        ls = m["losses"]
        if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
            out.append(f"{tag}: loss did not fall: {ls}")
        if ls != r0["losses"]:
            out.append(f"{tag}: the ranks' losses differ")
        out += [f"{tag}: {p}" for p in moe_ep_gate_problems(
            r["gates"], "E5" if t.get("layers") else "E1")]
    return out


# The kernel instantiations the launches reach, as sass_kernel_label names
# them: (family, "dtype rest").
# --------------------------------------------------------------------------- #
# The offload phases (ZeRO-Offload, the NVMe tier, SuperOffload, ZenFlow)
# --------------------------------------------------------------------------- #
# train_llama2_7b_super_offload: llama2_7b at full width under
# SuperOffload (zero_optimization {stage 1, super_offload}: the fp32 master
# and Adam's moments in host memory, the update on the host's cores, the
# card holding the bf16 compute copy, the bf16 gradient and the fp32
# accumulator), bf16, flash, remat full, Adam lr 1e-4, micro 2, seq 2048,
# gas 4, one fixed batch from the seed; 1 warm-up step, then 3 steps with
# overlap_step on and 2 with it off. The host holds 18 B a parameter
# (master, m, v, the fp32 landing buffer, the bf16 staging buffer): the
# depth is the most layers, up to the preset's 32, whose host bytes times
# SUPER_HOST_MARGIN fit the MemAvailable read at the phase's start.
# Gates S1-S3 run SUPER["gate_layers"] layers at full width (micro 1,
# gas 1): S1 one fp32 step with the host step (overlap off) against the
# device path without offload, the loss bit-equal and the master within
# SUPER_MASTER_REL (both run the same rounded fp32 operations, so
# bit-equal is expected); S2 the bf16 host step's update no further from
# S1's fp32 update than BF16_VS_PLAIN times the device bf16 step's; S3 the
# overlap schedule: its step 2 loss bit-equal to its step 1 loss (both on
# the initial parameters), its step 3 loss bit-equal to the sync run's
# step 2 loss.
SUPER = dict(model="llama2_7b", micro=2, seq=2048, gas=4, overlap_steps=3,
             sync_steps=2, gate_layers=4, gate_micro=1, max_layers=None)
SUPER_ZERO = {"stage": 1, "super_offload": True}
SUPER_HOST_SYNC = {"stage": 1, "offload_optimizer": {
    "device": "cpu", "host_step": True, "overlap_step": False}}
SUPER_HOST_BYTES = 18
SUPER_HOST_MARGIN = 1.25
SUPER_MASTER_REL = 1e-6
# the host Adam's bytes a parameter: p, g, m, v read (16), p, m, v and the
# bf16 copy written (14); its prep pass reads and writes g (8)
HOST_ADAM_BYTES = 30
HOST_PREP_BYTES = 8
# S0: the compiled host Adam (ops/csrc/cpu_adam.cpp) on a 64 M-element
# slice of the step's real gradient, master and moments, against the CUDA
# fused-Adam kernel (both IEEE division and sqrt with no contraction: p,
# m, v and the bf16 copy bit-equal expected; else p within S0_P_ULPS ulp on
# at most S0_P_SHARE of the elements) and against fused_adam_ref (m and v
# bit-equal, p different only where PyTorch's CPU sqrt is not correctly
# rounded); the prep pass's norm bit-equal at 1 thread and at all
S0_ELEMS = 1 << 26
S0_P_ULPS = 1
S0_P_SHARE = 1e-4
# train_llama_750m_offload: llama_750m at its training shape (micro 4, seq
# 2048, gas 4, bf16, ZeRO-1, flash, remat full), 1 warm-up + 2 steps a run:
# (a) offload_optimizer cpu, (b) offload_optimizer nvme, each bit-equal to
# the run without offload (losses and master: the same fused Adam kernel
# runs after the swap-in); (c) ZenFlow on the card (top 1 % a leaf, a
# boundary every 2 steps, so one falls inside the run), with the training
# rule's kernels-vs-plain step at OFFLOAD["gate_layers"] layers; (d)
# ZeRO-3 at world 1 (one spawned rank) with offload_param cpu and nvme at
# OFFLOAD["param_layers"] layers, bit-equal to the run without it.
OFFLOAD = dict(model="llama_750m", micro=4, seq=2048, gas=4, steps=2,
               gate_layers=4, gate_micro=1, param_layers=8)
# (d) at world 1 runs JAX's in-step streaming mode (the master in pinned
# host memory through the step, streamed a chunk at a time); the int8
# wire, which needs two ranks, keeps the boundary swap: ZeRO-3 + qgZ + qwZ
# with and without offload_param cpu at world 2, bit-equal
OFFLOAD_INT8 = {"stage": 3, "zero_quantized_gradients": True,
                "zero_quantized_weights": True}
ZENFLOW = {"enabled": True, "topk_ratio": 0.01, "update_interval": 2}
# ZenFlow's kernels-vs-plain step (the training rule): the whole gradient
# (the applied hot part plus cold_acc) by TRAIN_GRAD_REL; coordinates hot
# on one path and cold on the other at most ZENFLOW_HOT_MISS of all (a
# mask flips only where |g| lies within the paths' last-digit difference
# of its leaf's threshold: 40 of 1.07e9, 3.8e-8, in the first card run),
# the update held where the masks agree.
ZENFLOW_HOT_MISS = 1e-6
NVME_MIN_FREE = 6e9


def meminfo():
    """/proc/meminfo's fields in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, rest = line.split(":", 1)
            parts = rest.split()
            out[key] = int(parts[0]) * (1024 if parts[1:] == ["kB"] else 1)
    return out


def process_memory():
    """This process's resident set now and at its peak (bytes)."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(("VmRSS:", "VmHWM:")):
                key, rest = line.split(":", 1)
                out[key] = int(rest.split()[0]) * 1024
    return {"rss_bytes": out.get("VmRSS"), "rss_peak_bytes": out.get("VmHWM")}


def cgroup_memory():
    """This cgroup's (v2) memory limit and use in bytes, or Nones."""
    out = {}
    for key, name in (("limit", "memory.max"), ("current", "memory.current")):
        try:
            with open(os.path.join("/sys/fs/cgroup", name)) as f:
                v = f.read().strip()
            out[key] = None if v == "max" else int(v)
        except (OSError, ValueError):
            out[key] = None
    return out


def host_available(facts):
    """The host bytes a phase may take: MemAvailable, and below this
    cgroup's limit less its use where one is set."""
    avail = facts["mem_available_bytes"]
    if facts["cgroup_limit_bytes"] is not None:
        avail = min(avail, facts["cgroup_limit_bytes"]
                    - (facts["cgroup_current_bytes"] or 0))
    return avail


def nvme_dir():
    """The NVMe tier's directory: ``DSTPU_NVME_PATH``, else
    ``build/nvme_swap`` in the checkout (the machine's local disk)."""
    return os.environ.get("DSTPU_NVME_PATH") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "nvme_swap")


def host_facts(path):
    """MemAvailable, cores, the intra-op threads and the disk under
    ``path``."""
    import torch

    os.makedirs(path, exist_ok=True)
    mi = meminfo()
    du = shutil.disk_usage(path)
    df = subprocess.run(["df", "-h", path], capture_output=True, text=True,
                        timeout=60)
    cg = cgroup_memory()
    return {"mem_total_bytes": mi.get("MemTotal"),
            "mem_available_bytes": mi.get("MemAvailable"),
            "cgroup_limit_bytes": cg["limit"],
            "cgroup_current_bytes": cg["current"],
            "nproc": len(os.sched_getaffinity(0)), "cpu_count": os.cpu_count(),
            "torch_threads": torch.get_num_threads(), "nvme_path": path,
            "disk_free_bytes": du.free, "disk_total_bytes": du.total,
            "df": df.stdout.strip()}


def super_layers(model, mem_available, max_layers=None):
    """The most layers (up to the preset's) whose host bytes under
    SuperOffload, SUPER_HOST_BYTES a parameter, times SUPER_HOST_MARGIN fit
    ``mem_available``."""
    from deepspeed_tpu_torch.models import transformer as T

    full = T.get_model_config(model).num_layers
    fixed = T.get_model_config(model, num_layers=0).num_params()
    per = T.get_model_config(model, num_layers=1).num_params() - fixed
    fit = int((mem_available / SUPER_HOST_MARGIN / SUPER_HOST_BYTES - fixed)
              // per)
    return max(0, min(full, fit, max_layers or full))


def host_copy_gbs(n=2 ** 28, reps=3):
    """The host's copy rate: bytes moved (read + written) a second by one
    ``copy_`` of ``n`` fp32 elements, the median of ``reps``."""
    import torch

    src = torch.rand(n)
    dst = torch.empty_like(src)
    dst.copy_(src)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        dst.copy_(src)
        walls.append(time.perf_counter() - t0)
    return 2 * 4 * n / float(np.median(walls)) / 1e9


def offload_engine(t, dev, zero, precision, layers=None, use_kernels=True):
    import deepspeed_tpu_torch as dtt

    kw = {} if layers is None else {"num_layers": layers}
    spec = dtt.causal_lm_spec(
        t["model"], attention="flash", remat="full", use_kernels=use_kernels,
        dtype="float32" if precision == "fp32" else "bfloat16", **kw)
    engine, *_ = dtt.initialize(model=spec, config=zeropp_config(
        t["micro"], t["gas"], precision, zero), device=dev)
    return engine


def master_on(engine, dev):
    """A copy of the engine's fp32 master on ``dev`` (the update in flight
    of a host step done)."""
    engine._materialize_master()
    return engine.flat_master.detach().to(dev, copy=True)


def rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def super_gates(t, dev, seed):
    """S1-S3 at ``t["gate_layers"]`` layers, full width, micro
    ``t["gate_micro"]``, gas 1, on one batch from ``seed``: each way's
    losses, its initial master against the first way's, and its master
    after step 1 against the fp32 device step's."""
    from deepspeed_tpu_torch.models import transformer as T

    g = dict(t, micro=t["gate_micro"], gas=1)
    vocab = T.get_model_config(t["model"]).vocab_size
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (g["micro"], g["seq"]),
                                    dtype=np.int32)}
    res, master0, ref = {}, None, None
    for way, prec, zero, steps in (
            ("fp32_device", "fp32", {"stage": 1}, 1),
            ("fp32_host", "fp32", SUPER_HOST_SYNC, 1),
            ("bf16_device", "bf16", {"stage": 1}, 1),
            ("bf16_host", "bf16", SUPER_HOST_SYNC, 2),
            ("bf16_overlap", "bf16", SUPER_ZERO, 3)):
        t0 = time.perf_counter()
        engine = offload_engine(g, dev, zero, prec, layers=g["gate_layers"])
        dev_sync(dev)
        row = {"init_s": time.perf_counter() - t0, "losses": [],
               "step_s": []}
        m = master_on(engine, dev)
        if master0 is None:
            master0 = m
        row["init_bit_equal"] = same_bits(m, master0)
        for step in range(steps):
            t0 = time.perf_counter()
            row["losses"].append(float(engine.train_batch(iter([batch]))))
            if engine._host_runner is not None:
                engine._host_runner.wait()
            dev_sync(dev)
            row["step_s"].append(time.perf_counter() - t0)
            if step == 0 and way != "bf16_overlap":
                m = master_on(engine, dev)
                if ref is None:
                    ref = m
                    grad = engine.flat_grad_acc.detach().clone()
                elif prec == "fp32":
                    row["master_rel_l2"] = rel_l2(m, ref)
                    row["master_bit_equal"] = same_bits(m, ref)
                    # the step's unscaled gradient as the host took it
                    # (gas 1): a difference there is the backward's, not
                    # the host Adam's
                    land = engine._host_runner.landing.to(dev)
                    row["grad_bit_equal"] = same_bits(land, grad)
                    row["grad_rel_l2"] = rel_l2(land, grad)
                    del grad, land
                else:
                    row["update_rel_vs_fp32"] = rel_l2(m - master0,
                                                       ref - master0)
                del m
        if engine._host_runner is not None:
            row["updates"] = engine._host_runner.stats()
        engine.close()
        del engine
        dev_free(dev)
        res[way] = row
    res["layers"] = g["gate_layers"]
    return res


def super_gate_problems(g):
    out = [f"{w}: initial master differs from fp32_device's"
           for w in ("fp32_host", "bf16_device", "bf16_host", "bf16_overlap")
           if not g[w]["init_bit_equal"]]
    if g["fp32_host"]["losses"][0] != g["fp32_device"]["losses"][0]:
        out.append(f"S1 loss {g['fp32_host']['losses'][0]!r} != "
                   f"{g['fp32_device']['losses'][0]!r}")
    if not g["fp32_host"]["master_rel_l2"] <= SUPER_MASTER_REL:
        out.append(f"S1 master rel L2 {g['fp32_host']['master_rel_l2']:.3g}"
                   f" > {SUPER_MASTER_REL}")
    dev_err = g["bf16_device"]["update_rel_vs_fp32"]
    host_err = g["bf16_host"]["update_rel_vs_fp32"]
    if not host_err <= BF16_VS_PLAIN * dev_err:
        out.append(f"S2 bf16 host update {host_err:.3g} from fp32, device "
                   f"{dev_err:.3g}")
    ov, sy = g["bf16_overlap"]["losses"], g["bf16_host"]["losses"]
    if ov[1] != ov[0]:
        out.append(f"S3 overlap step 2 loss {ov[1]!r} != step 1 {ov[0]!r}")
    if ov[2] != sy[1]:
        out.append(f"S3 overlap step 3 loss {ov[2]!r} != sync step 2 "
                   f"{sy[1]!r}")
    return out


def offload_run(t, dev, zero, batch, precision="bf16", layers=None,
                after_step=None, ref=None, probe=None):
    """One config's main path in this process: initialize, a warm-up step,
    then ``t["steps"]`` timed steps with the counters set to 0 just before
    and read just after; ``after_step(engine)`` after every step (its
    results listed); the losses, and the final master: bit for bit against
    ``ref`` when given (a master on ``dev``), else a copy of it on ``dev``
    under ``"_master"`` (for the caller, not for the emitted line)."""
    import itertools

    held = dev_allocated(dev)
    t0 = time.perf_counter()
    engine = offload_engine(t, dev, zero, precision, layers=layers)
    dev_sync(dev)
    init_s = time.perf_counter() - t0
    if probe is not None:
        probe(engine)
    data = itertools.repeat(batch)
    checks = []
    t0 = time.perf_counter()
    first = float(engine.train_batch(data))
    warm_s = time.perf_counter() - t0
    if after_step:
        checks.append(after_step(engine))
    reset_counts()
    dev_peak(dev, reset=True)       # the timed steps' peak
    losses, walls = [], []
    for _ in range(t["steps"]):
        t0 = time.perf_counter()
        loss = engine.train_batch(data)
        dev_sync(dev)
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if after_step:
            checks.append(after_step(engine))
    counts = read_counts()
    peak = dev_peak(dev) - held
    res = {"losses": [first] + losses, "init_seconds": init_s,
           "held_bytes": held,
           "warmup_step_seconds": warm_s, "step_walls_s": walls,
           "step_ms": float(np.median(walls)) * 1e3, "launches": counts,
           "peak_memory_bytes": peak,
           "peak_note": "the timed steps' peak less what the process held "
                        "before the engine",
           "checks": checks}
    master = master_on(engine, dev)
    if ref is None:
        res["_master"] = master
    else:
        res["master_bit_equal"] = same_bits(master, ref)
    return engine, res


def moments_on_host(engine):
    """Where the optimizer state lies between steps: every tensor a CPU
    tensor, pinned when the engine is on the card."""
    import torch

    opt = [v for v in engine.state["opt"].values()
           if isinstance(v, torch.Tensor)]
    cuda = engine.device.type == "cuda"
    return {"n": len(opt),
            "all_host": all(v.device.type == "cpu" for v in opt),
            "all_pinned": all(v.is_pinned() for v in opt) if cuda else None}


def opt_swap_rate(engine, dev):
    """One timed swap of the optimizer state in and out (host tier ↔ the
    card), synchronised: seconds and GB/s each way."""
    import torch

    nbytes = sum(v.numel() * v.element_size()
                 for v in engine.state["opt"].values()
                 if isinstance(v, torch.Tensor))
    out = {"bytes": nbytes}
    for way in ("in", "out"):
        dev_sync(dev)
        t0 = time.perf_counter()
        engine._opt_swap(way)
        dev_sync(dev)
        s = time.perf_counter() - t0
        out[f"{way}_s"], out[f"{way}_gbs"] = s, nbytes / s / 1e9
    return out


def nvme_swap_times(engine):
    sw = engine._opt_swapper
    if sw is None:
        return None
    last = dict(sw.swapper.last)
    last["swapped"] = sw.swapped
    for k in ("in", "out"):
        if last.get(f"{k}_s"):
            last[f"{k}_gbs"] = last["bytes"] / last[f"{k}_s"] / 1e9
    return last


def host_adam_gate(engine, dev, n=S0_ELEMS):
    """S0 on the SuperOffload engine after its steps: a slice of the last
    step's gradient (as the host took it), master and moments through the
    host library, the CUDA kernel and the plain version on the same inputs;
    each way's host seconds; the prep pass at 1 thread and at all."""
    import torch
    from deepspeed_tpu_torch.ops import cpu_adam
    from deepspeed_tpu_torch.ops import fused_adam as FA

    runner = engine._host_runner
    runner.wait()
    n = min(n, engine._numel)
    opt, st = engine.optimizer, engine.state["opt"]
    g = runner.landing[:n].float().clone()
    p0, m0, v0 = (x[:n].clone() for x in (engine.flat_master,
                                          st["exp_avg"], st["exp_avg_sq"]))
    lr, bc1, bc2 = opt.begin_step(st, engine._lr_at(engine.state["step"]))
    hyper = (lr, tuple(opt.betas), opt.eps, opt.weight_decay, bc1, bc2,
             opt.adam_w_mode)
    out = {"elements": n, "threads": torch.get_num_threads()}

    def host_run(fn):
        p, m, v = p0.clone(), m0.clone(), v0.clone()
        o = torch.empty(n, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        fn(p, m, v, o)
        return (p, m, v, o), time.perf_counter() - t0

    cpp, out["host_adam_s"] = host_run(
        lambda p, m, v, o: cpu_adam.adam(p, g, m, v, *hyper, out=o))

    def plain(p, m, v, o):
        for i in range(0, n, FA.CHUNK):
            c = slice(i, i + FA.CHUNK)
            FA.fused_adam_ref(p[c], g[c], m[c], v[c], *hyper, out=o[c])

    ref, out["plain_s"] = host_run(plain)
    names = ("p", "m", "v", "bf16")
    out["vs_plain_bit_equal"] = {k: bool(torch.equal(a, b))
                                 for k, a, b in zip(names, cpp, ref)}
    q = ref[2] / torch.tensor(bc2, dtype=torch.float32)
    off = torch.sqrt(q) != torch.sqrt(q.double()).float()
    differ = cpp[0] != ref[0]
    out["vs_plain_p_max_abs"] = float((cpp[0] - ref[0]).abs().max())
    out["vs_plain_p_differ"] = int(differ.sum())
    out["vs_plain_p_differ_outside_sqrt"] = int((differ & ~off).sum())
    del q, off, differ, ref
    try:
        # the library call: PyTorch's fused AdamW on the CPU, one step
        param = torch.nn.Parameter(p0.clone())
        param.grad = g.clone()
        adamw = torch.optim.AdamW([param], lr=lr, betas=hyper[1],
                                  eps=hyper[2], weight_decay=hyper[3],
                                  fused=True)
        t0 = time.perf_counter()
        adamw.step()
        out["library_s"] = time.perf_counter() - t0
        del param, adamw
    except (RuntimeError, TypeError) as e:
        out["library_s"] = None
        out["library_error"] = f"{type(e).__name__}: {e}"
    if dev.type == "cuda":
        d = [x.to(dev) for x in (p0, g, m0, v0)]
        do = torch.empty(n, dtype=torch.bfloat16, device=dev)
        FA.fused_adam(d[0], d[1], d[2], d[3], *hyper, out=do)
        kern = [x.cpu() for x in (d[0], d[2], d[3], do)]
        del d, do
        out["vs_cuda_bit_equal"] = {k: bool(torch.equal(a, b))
                                    for k, a, b in zip(names, cpp, kern)}
        ulps = (cpp[0].view(torch.int32).long()
                - kern[0].view(torch.int32).long()).abs()
        out["vs_cuda_p_max_ulps"] = int(ulps.max())
        out["vs_cuda_p_differ"] = int((ulps > 0).sum())
        out["vs_cuda_differ"] = {k: int((a != b).sum()) for k, a, b in
                                 zip(names, cpp, kern)}
        del kern, ulps
    else:
        out["vs_cuda_bit_equal"] = "not measured"
    sums = {}
    for threads in (1, os.cpu_count() or 1):
        gg = g.clone()
        t0 = time.perf_counter()
        sums[threads] = cpu_adam.grad_prep(
            gg, float(engine.gradient_accumulation_steps()),
            threads=threads)[0]
        out[f"prep_s_threads_{threads}"] = time.perf_counter() - t0
    out["norm_sums"] = sums
    out["norm_bit_equal"] = len(set(sums.values())) == 1
    return out


def host_adam_gate_problems(g):
    out = []
    if g["vs_cuda_bit_equal"] != "not measured" and not all(
            g["vs_cuda_bit_equal"].values()):
        bad = {k: v for k, v in g["vs_cuda_differ"].items()
               if k != "p" and v}
        if bad:
            out.append(f"S0 host vs CUDA kernel differ in {bad}")
        if not (g["vs_cuda_p_max_ulps"] <= S0_P_ULPS and g["vs_cuda_p_differ"]
                <= S0_P_SHARE * g["elements"]):
            out.append(f"S0 host vs CUDA p: {g['vs_cuda_p_differ']} elements"
                       f" differ, up to {g['vs_cuda_p_max_ulps']} ulp")
    for k in ("m", "v"):
        if not g["vs_plain_bit_equal"][k]:
            out.append(f"S0 host vs plain: {k} differs")
    if g["vs_plain_p_differ_outside_sqrt"]:
        out.append(f"S0 host vs plain: p differs at "
                   f"{g['vs_plain_p_differ_outside_sqrt']} elements where "
                   "PyTorch's sqrt is correctly rounded")
    if not g["norm_bit_equal"]:
        out.append(f"S0 the norm's sum differs by threads: {g['norm_sums']}")
    return out


def stream_probe(engine, dev):
    """Per step of a streaming ``offload_param`` engine: the device peak of
    the forward and backward (before the update) and of the whole step
    (each less nothing: raw bytes), and each streamed update pass's
    seconds (CUDA events around it)."""
    import torch

    rec = {"fb_peak": [], "step_peak": [], "pass_ms": []}
    tiers, update, stream = (engine._tiers_before_step,
                             engine._tiered_update, engine._stream_pass)

    def before():
        dev_peak(dev, reset=True)
        return tiers()

    def tiered(scale):
        rec["fb_peak"].append(dev_peak(dev))
        res = update(scale)
        rec["step_peak"].append(dev_peak(dev))
        return res

    def timed(g=None, lr=None, out=None):
        if g is None or dev.type != "cuda":
            return stream(g, lr, out)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = stream(g, lr, out)
        ev[1].record()
        ev[1].synchronize()
        rec["pass_ms"].append(ev[0].elapsed_time(ev[1]))
        return res

    engine._tiers_before_step, engine._tiered_update = before, tiered
    engine._stream_pass = timed
    return rec


def train_llama_750m_offload_param_rank(rank, world, seed, t):
    """(d) of the 750m offload phase on one rank: ZeRO-3 at ``world``
    (world 1: one process shards nothing) without offload, with
    ``offload_param`` cpu and with nvme, at ``t["param_layers"]`` layers;
    the losses, the master's digest and where the master lies between
    steps."""
    import torch
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.runtime.swap_tensor import Swapped

    dev = torch.device(t["device"])
    vocab = T.get_model_config(t["model"]).vocab_size
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (t["micro"] * world, t["seq"]),
                                    dtype=np.int32)}

    def tier(engine):
        m = engine.flat_master
        if isinstance(m, Swapped):
            return {"master": "file"}
        return {"master": m.device.type,
                "pinned": m.is_pinned() if m.device.type == "cpu"
                and dev.type == "cuda" else None}

    out, ref = {}, None
    wire = t.get("wire") or {"stage": 3}
    for run, off in (("none", None), ("cpu", {"device": "cpu"}),
                     ("nvme", {"device": "nvme",
                               "nvme_path": t["nvme_path"]})):
        if run not in t.get("runs", ("none", "cpu", "nvme")):
            continue
        zero = dict(wire)
        if off:
            zero["offload_param"] = off
        probe = {}
        engine, res = offload_run(t, dev, zero, batch,
                                  layers=t["param_layers"], after_step=tier,
                                  ref=ref, probe=lambda e: probe.update(
                                      stream_probe(e, dev)
                                      if e._param_stream else {}))
        if ref is None:
            ref = res.pop("_master")
        res.update(engine=type(engine).__name__, stream=engine._param_stream,
                   wire=engine._wire_format(), stream_counts=dict(
                       engine.stream_counts))
        if probe:
            held = res["held_bytes"]
            nbytes = 4 * engine.flat_master.numel()
            res.update(
                fb_peak_bytes=[b - held for b in probe["fb_peak"]],
                step_peak_bytes=[b - held for b in probe["step_peak"]],
                stream_pass_ms=probe["pass_ms"],
                stream_chunks=len(engine._stream_ranges()),
                stream_staging_bytes=sum(b.numel() * 4
                                         for b in engine._stream_bufs),
                stream_gbs_each_way=[nbytes / (ms / 1e3) / 1e9
                                     for ms in probe["pass_ms"]])
        out[run] = res
        engine.close()
        del engine
        dev_free(dev)
    return out


DESIGN_INSTANTIATIONS = tuple(
    [(fam, f"{dt} {fam}_{kind}_kernel{sfx} D{d}")
     for fam in ("flash", "block_sparse")
     for kind in ("fwd", "bwd_dq", "bwd_dkv")
     for dt, sfx in (("bf16", "_mma"), ("fp32", ""))
     for d in (64, 128)]
    + [("gmm", f"{dt} {mode}") for dt in ("bf16", "fp32")
       for mode in ("gmm", "gmm_transpose_rhs", "tgmm")]
    + [("evoformer", f"{dt} bias {bt} D{d}") for dt in ("bf16", "fp32")
       for bt in ("bf16", "fp32") for d in (8, 16, 32, 64, 128)]
    + [("paged", f"{dt} decode D{d} R{r}") for dt in ("bf16", "fp32")
       for d in (64, 128) for r in (1, 2, 4, 8)]
    + [("paged", f"bf16 prefill D{d}") for d in (64, 128)]
    + [("paged", "int32 plan")])
_GMM_MODES = ("gmm", "gmm_transpose_rhs", "tgmm")


def sass_kernel_label(mangled):
    """(family, dtype, rest) of a mangled kernel name of the flash /
    block-sparse, grouped-GEMM, Evoformer or paged-attention library, or
    None for another function: ("flash", "bf16", "flash_fwd_kernel_mma D128
    tiles 64x64"), ("gmm", "bf16", "tgmm"), ("evoformer", "bf16", "bias
    fp32 D32"), ("paged", "bf16", "prefill D128")."""
    import re

    if re.search(r"\d+paged_attention_plan_kernelE", mangled):
        return ("paged", "int32", "plan")
    m = re.search(r"\d+paged_attention_(decode_kernel|prefill_kernel_mma)I"
                  r"(.*?)EEv", mangled)
    if m is not None:
        args = re.findall(r"Li(\d+)E", m.group(2))
        kind = m.group(1).split("_")[0]
        if kind == "prefill":
            return ("paged", "bf16", f"prefill D{args[0]}")
        dtype = "bf16" if "bfloat16" in m.group(2) else "fp32"
        return ("paged", dtype, f"decode D{args[0]} R{args[1]}")

    m = re.search(r"\d+((?:flash|block_sparse)_\w*?kernel(?:_mma)?)I(.*?)EEv",
                  mangled)
    if m is not None:
        args = [int(a) for a in re.findall(r"Li(\d+)E", m.group(2))]
        dtype = "bf16" if m.group(1).endswith("_mma") else (
            "fp32" if m.group(2).startswith("f") else "?")
        family = "flash" if m.group(1).startswith("flash") else "block_sparse"
        return (family, dtype, f"{m.group(1)} D{args[0]} tiles "
                               f"{'x'.join(map(str, args[1:]))}")
    m = re.search(r"\d+(gmm_wgmma_kernel|gmm_kernel)I(.*?)EEv", mangled)
    if m is not None:
        mode = int(re.findall(r"Li(\d+)E", m.group(2))[-1])
        dtype = "bf16" if m.group(1) == "gmm_wgmma_kernel" else (
            "fp32" if m.group(2).startswith("f") else "?")
        return ("gmm", dtype, _GMM_MODES[mode])
    m = re.search(r"\d+(evoformer_fwd_kernel(?:_mma)?)I(.*?)EEv", mangled)
    if m is not None:
        d = int(re.findall(r"Li(\d+)E", m.group(2))[-1])
        dtype = "bf16" if m.group(1).endswith("_mma") else "fp32"
        bias = "bf16" if "bfloat16" in m.group(2) else "fp32"
        return ("evoformer", dtype, f"bias {bias} D{d}")
    return None


def ptxas_resources(report):
    """{mangled kernel: {registers, spill_bytes, static_smem_bytes}} from
    nvcc's ptxas -v report."""
    import re

    ptx, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            fn = m.group(1)
            ptx.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            ptx[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            ptx[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            ptx[fn]["static_smem_bytes"] = int(m.group(1)) if m else 0
    return ptx


def sass_op_counts(sass):
    """{mangled kernel: counts of the ops the design check reads} from
    cuobjdump --dump-sass: bf16 HMMA with fp32 sums, any HMMA, bf16 HGMMA
    (wgmma) with fp32 sums, any HGMMA, LDGSTS (cp.async), LDSM
    (ldmatrix)."""
    import re

    ops, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            ops[fn] = {"HMMA.16816.F32.BF16": 0, "HMMA": 0,
                       "HGMMA.F32.BF16": 0, "HGMMA": 0, "LDGSTS": 0,
                       "LDSM": 0}
        elif fn is not None:
            counts = ops[fn]
            for op in ("HMMA.16816.F32.BF16", "HMMA", "HGMMA", "LDGSTS",
                       "LDSM"):
                if op in line:
                    counts[op] += 1
            if re.search(r"HGMMA\.\d+x\d+x\d+\.F32\.BF16", line):
                counts["HGMMA.F32.BF16"] += 1
    return ops


def kernel_kind(name):
    """The kind a train step's profiler split books a kernel under, from
    its name as torch.profiler reports it (demangled) or mangled: the
    grouped GEMM by mode (its wgmma body and its fp32 body; tgmm is mode
    2), the flash and block-sparse kernels, the Evoformer forward, fused
    Adam, the norms, cuBLAS GEMMs, else "other"."""
    import re

    m = (re.search(r"gmm_(?:wgmma_)?kernel<(?:[^<>]*?,\s*)?"
                   r"(?:\([\w:]+\))?(\d+)>", name)
         or re.search(r"\d+gmm_(?:wgmma_)?kernelI\w*?Li(\d+)EE", name))
    if m is not None:
        return "moe_tgmm" if int(m.group(1)) == 2 else "moe_gmm"
    low = name.lower()
    for sub, kind in (("block_sparse_fwd_kernel", "block_sparse_fwd"),
                      ("block_sparse_bwd_dq_kernel", "block_sparse_bwd_dq"),
                      ("block_sparse_bwd_dkv_kernel", "block_sparse_bwd_dkv"),
                      ("flash_fwd_kernel", "flash_fwd"),
                      ("flash_bwd_dq_kernel", "flash_bwd_dq"),
                      ("flash_bwd_dkv_kernel", "flash_bwd_dkv"),
                      ("evoformer_fwd_kernel", "evoformer_fwd"),
                      ("paged_attention_decode_kernel",
                       "paged_attention_decode"),
                      ("paged_attention_prefill_kernel",
                       "paged_attention_prefill"),
                      ("paged_attention_plan_kernel", "paged_attention_plan"),
                      ("fused_adam_kernel", "fused_adam"),
                      ("norm_fwd", "norm_fwd")):
        if sub in low:
            return kind
    if any(w in low for w in ("gemm", "nvjet", "cutlass", "matmul",
                              "sm90_xmma")):
        return "gemm"
    return "other"


class Smoke:
    def __init__(self, torch, seed: int):
        self.torch = torch
        self.seed = seed
        self.dev = torch.device("cuda:0")
        self.card = ""
        self.launches = {}       # kernel → {model: launches on its run}
        self.host_rows = {}      # the host library's row of the kernels line
        self.ticks = {}          # model → ticks of its main-path run
        self.steps = {}          # train_<model> → steps of its main-path run
        self.errs = {}           # kernel → max abs err at the main-path shape
        self.state = {}          # engine, prompts of each model's run

    # ------------------------------------------------------------------ #
    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def close(self, name, got, want, dtype):
        return self.close_tol(name, got, want, TOL[dtype])

    # ------------------------------------------------------------------ #
    def phase_card(self):
        torch = self.torch
        self.card = nvidia_smi()
        emit("card", nvidia_smi=self.card,
             torch_device=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), torch=torch.__version__,
             cuda=torch.version.cuda,
             capability=list(torch.cuda.get_device_capability(0)))
        if torch.cuda.get_device_capability(0) < (9, 0):
            raise RuntimeError("the kernels are built for sm_90a (Hopper)")

    def phase_build(self):
        torch = self.torch
        from deepspeed_tpu_torch.ops import build, norms

        from deepspeed_tpu_torch.ops import cpu_adam

        t0 = time.perf_counter()
        build.build_all()
        nvcc_s = time.perf_counter() - t0
        cpu_adam.norm_block()           # the host library, with g++
        host = build.build_log["host:cpu_adam"]
        emit("build/host_library", name="cpu_adam",
             seconds=host["seconds"], cached=host["cached"],
             flags=host["flags"], path=host["path"])
        ptxas = {name: [ln.strip() for ln in str(log["ptxas"]).splitlines()
                        if "Used" in ln or "spill" in ln
                        or "entry function" in ln]
                 for name, log in build.build_log.items()
                 if not name.startswith("host:")}
        t0 = time.perf_counter()
        x = torch.randn(4, 4096, device=self.dev, dtype=torch.bfloat16)
        norms.rms_norm(x, torch.ones(4096, device=self.dev,
                                     dtype=torch.bfloat16))
        x = torch.randn(4, 768, device=self.dev, dtype=torch.bfloat16)
        one = torch.ones(768, device=self.dev, dtype=torch.bfloat16)
        norms.layer_norm(x, one, one)
        self.sync()
        emit("build", nvcc_seconds=nvcc_s,
             per_source={n: {"seconds": v["seconds"], "cached": v["cached"]}
                         for n, v in build.build_log.items()},
             triton_first_use_seconds=time.perf_counter() - t0, ptxas=ptxas)
        self.design_check()

    def design_check(self):
        """The designs on the path, from the built libraries: each
        instantiation of the flash / block-sparse, grouped-GEMM, Evoformer
        and paged-attention kernels with its registers, spills and shared
        memory (ptxas; the dynamic shared memory its launch takes), one line
        each, and its SASS ops (cuobjdump). Every bf16 flash, block-sparse,
        Evoformer and paged-prefill kernel holds bf16 HMMA with fp32 sums
        and LDGSTS (cp.async); every paged-decode kernel LDGSTS (its ring);
        every bf16 grouped-GEMM mode holds HGMMA (wgmma) with fp32 sums; no
        fp32 kernel holds HMMA or HGMMA. Every instantiation the launches
        can reach must be in the library."""
        import ctypes

        from deepspeed_tpu_torch.ops import build

        nvcc = build.find_nvcc()
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        smem = {}
        for lib, fn, n_args in (("flash_attention", "dstpu_flash_smem_bytes",
                                 3),
                                ("grouped_gemm", "dstpu_gmm_smem_bytes", 1),
                                ("evoformer", "dstpu_evoformer_smem_bytes",
                                 3),
                                ("paged_attention", "dstpu_paged_smem_bytes",
                                 3)):
            f = getattr(build.load(lib), fn)
            f.argtypes = [ctypes.c_int] * n_args
            f.restype = ctypes.c_int
            smem[lib] = f
        problems, seen = [], set()
        for lib in ("flash_attention", "grouped_gemm", "evoformer",
                    "paged_attention"):
            log = build.build_log[lib]
            ptx = ptxas_resources(str(log["ptxas"]))
            if not ptx:
                raise AssertionError(f"no ptxas report for {lib} (a cached "
                                     "build: clear build/torch_kernels)")
            sass = subprocess.run([cuobjdump, "--dump-sass", log["path"]],
                                  capture_output=True, text=True, check=True,
                                  timeout=300).stdout
            for mangled, counts in sass_op_counts(sass).items():
                label = sass_kernel_label(mangled)
                if label is None:
                    continue
                family, dtype, rest = label
                if family in ("flash", "block_sparse"):
                    name, dim = rest.split()[:2]
                    kernel = (0 if "_fwd_" in name
                              else 1 if "_dq_" in name else 2)
                    dyn = smem[lib](kernel, dtype == "bf16", int(dim[1:]))
                elif family == "gmm":
                    dyn = smem[lib](dtype == "bf16")
                elif family == "paged" and rest == "plan":
                    dyn = 0
                elif family == "paged":
                    kind, dim = rest.split()[:2]
                    dyn = smem[lib](int(kind == "prefill"), dtype == "bf16",
                                    int(dim[1:]))
                else:
                    words = rest.split()
                    dyn = smem[lib](dtype == "bf16", words[1] == "bf16",
                                    int(words[2][1:]))
                text = f"{dtype} {rest}"
                emit(f"build/{family}_kernel", kernel=text,
                     **dict(ptx.get(mangled, {}), sass=counts,
                            dynamic_smem_bytes=dyn))
                seen.add((family, text))
                if dtype == "fp32" and (counts["HMMA"] or counts["HGMMA"]):
                    problems.append(f"{text}: tensor-core ops in an fp32 "
                                    "kernel")
                elif dtype == "bf16" and family == "gmm" \
                        and not counts["HGMMA.F32.BF16"]:
                    problems.append(f"{text}: no bf16 HGMMA with fp32 sums")
                elif family == "paged" and "decode" in rest:
                    if not counts["LDGSTS"]:
                        problems.append(f"{text}: no LDGSTS")
                elif dtype == "bf16" and family != "gmm" \
                        and not (counts["HMMA.16816.F32.BF16"]
                                 and counts["LDGSTS"]):
                    problems.append(f"{text}: no bf16 HMMA or no LDGSTS")
        for family, text in DESIGN_INSTANTIATIONS:
            if not any(f == family and (t == text or t.startswith(text + " "))
                       for f, t in seen):
                problems.append(f"{family} {text} not in the library")
        if problems:
            raise AssertionError("design check: " + "; ".join(problems))

    # ------------------------------------------------------------------ #
    def pa_inputs(self, N, K, D, bs, MB, dtype, lengths, pad_rows=2,
                  NB=None, seed=0):
        """Random q/pools and ragged tables: each real row gets distinct
        blocks; ``pad_rows`` extra rows carry all-zero tables (the trash
        block) with lengths 1 and 0."""
        torch = self.torch
        g = torch.Generator(self.dev).manual_seed(seed)
        Tn = len(lengths) + pad_rows
        NB = NB or (len(lengths) * MB + 1)
        dt = getattr(torch, dtype)
        q = torch.randn(Tn, N, D, generator=g, device=self.dev).to(dt)
        kp = torch.randn(NB, bs, K, D, generator=g, device=self.dev).to(dt)
        vp = torch.randn(NB, bs, K, D, generator=g, device=self.dev).to(dt)
        rng = np.random.default_rng(seed)
        tables = np.zeros((Tn, MB), np.int32)
        free = rng.permutation(np.arange(1, NB)).astype(np.int32)
        for t in range(len(lengths)):
            tables[t] = free[t * MB:(t + 1) * MB]
        lens = np.array(list(lengths) + [1, 0][:pad_rows], np.int32)
        return (q, kp, vp, torch.from_numpy(tables).to(self.dev),
                torch.from_numpy(lens).to(self.dev))

    def paged_checks(self):
        """PA_TICKS through the wrapper (the plan built on the card) against
        the plain version: fp32 and the bf16 decode rows at TOL, the bf16
        prefill rows by FLASH_BF16_RULE against the plain version of the
        fp32 upcast; the plan kernel bit-equal to build_plan_reference, and
        its regimes against the host's runs."""
        torch = self.torch
        from deepspeed_tpu_torch.ops import paged_attention as PA

        rows = []
        for label, kind, N, K, D, bs, MB in PA_TICKS:
            tb, ln, NB = paged_tick(kind, bs, MB, seed=len(rows))
            pre = prefill_rows(tb, PA.MIN_RUN)
            tables = torch.from_numpy(tb).to(self.dev)
            lengths = torch.from_numpy(ln).to(self.dev)
            plan = PA.build_plan(tables)
            ref = PA.build_plan_reference(tables)
            if not all(torch.equal(a, b)
                       for a, b in zip(plan.fields(), ref.fields())):
                raise AssertionError(f"paged plan[{label}]: the plan kernel "
                                     "differs from build_plan_reference")
            got_dec = sorted(plan.dec_rows[:int(plan.n_dec)].tolist())
            if got_dec != np.flatnonzero(~pre).tolist():
                raise AssertionError(f"paged plan[{label}]: decode rows "
                                     f"{got_dec}, want those outside runs "
                                     f"of {PA.MIN_RUN}")
            g = torch.Generator(self.dev).manual_seed(len(rows))
            q32 = torch.randn(len(ln), N, D, generator=g, device=self.dev)
            kp32 = torch.randn(NB, bs, K, D, generator=g, device=self.dev)
            vp32 = torch.randn(NB, bs, K, D, generator=g, device=self.dev)
            for dtype in ("bfloat16", "float32"):
                dt = getattr(torch, dtype)
                q, kp, vp = (x.to(dt) for x in (q32, kp32, vp32))
                got = PA.paged_attention(q, kp, vp, tables, lengths)
                want = PA.paged_attention_reference(q, kp, vp, tables,
                                                    lengths)
                self.sync()
                name = f"paged_attention[{label},{dtype}]"
                row = {"kernel": "paged_attention", "shape": label, "N": N,
                       "K": K, "D": D, "bs": bs, "MB": MB, "dtype": dtype,
                       "rows": len(ln), "prefill_rows": int(pre.sum()),
                       "tol": TOL[dtype]}
                dec = torch.from_numpy(~pre).to(self.dev) \
                    if dtype == "bfloat16" else torch.ones(
                        len(ln), dtype=torch.bool, device=self.dev)
                err = self.close(name, got[dec], want[dec], dtype) \
                    if bool(dec.any()) else 0.0
                if not bool(dec.all()):
                    want32 = PA.paged_attention_reference(
                        q.float(), kp.float(), vp.float(), tables, lengths)
                    err_p, rule = self.close_flash(
                        name + "/prefill", got[~dec], want[~dec],
                        want32[~dec], dtype, "o")
                    row.update(prefill_max_abs_err=err_p, bf16_rule=rule)
                    err = max(err, err_p)
                rows.append(dict(row, max_abs_err=err))
        return rows

    def phase_kernels(self):
        torch = self.torch
        from deepspeed_tpu_torch.ops import norms
        from deepspeed_tpu_torch.ops import paged_attention as PA

        rows = []
        for label, N, K, D, bs, MB in (("llama2_7b", 32, 32, 128, 32, 16),
                                       ("gqa", 32, 8, 128, 32, 16),
                                       ("gpt2_125m", 12, 12, 64, 64, 16)):
            lengths = [1, 2, bs - 1, bs, bs + 1, 2 * bs, 3 * bs + 7,
                       MB * bs - 1, MB * bs]
            for dtype in ("bfloat16", "float32"):
                args = self.pa_inputs(N, K, D, bs, MB, dtype, lengths)
                got = PA.paged_attention(*args)
                want = PA.paged_attention_reference(*args)
                self.sync()
                err = self.close(f"paged_attention[{label},{dtype}]", got,
                                 want, dtype)
                rows.append({"kernel": "paged_attention", "shape": label,
                             "N": N, "K": K, "D": D, "bs": bs, "MB": MB,
                             "dtype": dtype, "max_abs_err": err,
                             "tol": TOL[dtype]})
        rows += self.paged_checks()
        g = torch.Generator(self.dev).manual_seed(1)
        for kind, H, Rs in NORM_CASES:
            for dtype in ("bfloat16", "float32"):
                dt = getattr(torch, dtype)
                for R in Rs:
                    x = torch.randn(R, H, generator=g, device=self.dev).to(dt)
                    s = (1 + 0.1 * torch.randn(H, generator=g,
                                               device=self.dev)).to(dt)
                    b = (0.1 * torch.randn(H, generator=g,
                                           device=self.dev)).to(dt)
                    if kind == "rms_norm":
                        got = norms.rms_norm(x, s, 1e-5)
                        want = norms.rms_norm_ref(x, s, 1e-5)
                    else:
                        got = norms.layer_norm(x, s, b, 1e-5)
                        want = norms.layer_norm_ref(x, s, b, 1e-5)
                    self.sync()
                    err = self.close(f"{kind}[R={R},H={H},{dtype}]", got,
                                     want, dtype)
                    rows.append({"kernel": kind, "R": R, "H": H,
                                 "dtype": dtype, "max_abs_err": err,
                                 "tol": TOL[dtype]})
        # the LM head's fp32 logits from bf16 operands (one cuBLAS product
        # with an fp32 output) against the upcast fp32 product: the same
        # exact products, summed in another order (a few fp32 ulp of the
        # O(1) logits; HEAD_ATOL); llama2_7b's head and gpt2's tied one
        from deepspeed_tpu_torch.models import transformer as T
        for label, H, V, tied in (("llama2_7b", 4096, 32000, False),
                                  ("gpt2_125m", 768, 50304, True)):
            x = torch.randn(8, H, generator=g, device=self.dev).bfloat16()
            w = (0.02 * torch.randn(V, H, generator=g, device=self.dev)
                 ).bfloat16()
            w = w.t() if tied else w.t().contiguous()
            got = T.head_matmul(x, w)
            want = x.float() @ w.float()
            err = float((got - want).abs().max())
            if got.dtype != torch.float32 or not err <= HEAD_ATOL:
                raise AssertionError(f"head_matmul[{label}]: {got.dtype}, "
                                     f"max abs err {err:.3g} > {HEAD_ATOL}")
            rows.append({"kernel": "head_matmul (cuBLAS, fp32 out)",
                         "shape": label, "tied": tied, "max_abs_err": err,
                         "tol": HEAD_ATOL})
        rows += self.flash_checks()
        rows += self.adam_checks()
        rows += self.gmm_checks()
        rows += self.sparse_checks()
        rows += self.evo_checks()
        rows += self.quant_checks()
        emit("kernels", checks=rows)

    def packed_width(self, model, world):
        """The elements of one rank's row of the ZeRO++ wire's packed
        gradient: every sharded leaf's shard padded to the 2048 block
        (``runtime/engine.zero_layout``), from the model's shapes."""
        torch = self.torch
        import deepspeed_tpu_torch as dtt
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.runtime import engine as E

        spec = dtt.causal_lm_spec(model)
        tree = T.init_params(spec.config, torch.Generator(self.dev)
                             .manual_seed(0), self.dev, dtype=torch.bfloat16)
        slots = [E._Slot(path, tuple(t.shape), 0)
                 for path, t in E._flatten(tree)]
        del tree
        torch.cuda.empty_cache()
        _, n_sh, n_rep = E.zero_layout(spec, slots, world, 2,
                                       {"data": world})
        return n_sh, n_rep

    def quant_check(self, label, x, block=2048):
        """Quantize ``x`` with the kernel and the plain version: q and the
        scales equal bit for bit (a NaN scale where the other has one)."""
        from deepspeed_tpu_torch.ops import quant_kernels as QK

        q, sc = QK.quantize_int8_blocks(x, block)
        rq, rsc = QK.quantize_int8_blocks_ref(x, block)
        self.sync()
        ok = same_bits(q, rq) and same_bits(sc, rsc)
        if not ok:
            bad = int((q != rq).sum())
            raise AssertionError(f"quantize_int8_blocks[{label}]: kernel and "
                                 f"plain version differ ({bad} of q)")
        return q, sc, {"kernel": "quantize_int8_blocks", "shape": label,
                       "n": x.numel(), "block": block,
                       "dtype": str(x.dtype).split(".")[-1],
                       "bitwise_equal": ok, "max_abs_err": 0.0}

    def dequant_check(self, label, q, sc, mean, block=2048):
        from deepspeed_tpu_torch.ops import quant_kernels as QK

        got = QK.dequant_reduce(q, sc, block, mean=mean)
        want = QK.dequant_reduce_ref(q, sc, block, mean=mean)
        self.sync()
        ok = same_bits(got, want)
        if not ok:
            diff = (got - want).abs()
            raise AssertionError(f"dequant_reduce[{label},mean={mean}]: "
                                 f"kernel and plain version differ (max "
                                 f"{float(diff.nan_to_num().max()):.3g})")
        return {"kernel": "dequant_reduce", "shape": label,
                "W": q.shape[0], "C": q.shape[1], "mean": mean,
                "block": block, "bitwise_equal": ok, "max_abs_err": 0.0}

    def quant_checks(self):
        """The int8 wire's kernels against their plain versions, bit for
        bit: llama_750m's packed qgZ gradient at world 2 (fp32 [2, n_sh],
        per-block magnitudes from 1e-6 to 1e2) and its dequant-reduce; W 4
        and 8, mean on and off; exact .5 ties, an all-zero block, blocks
        holding inf and NaN, bf16 input, an unaligned view and a block of 6
        (the scalar variants)."""
        torch = self.torch
        rows = []
        g = torch.Generator(self.dev).manual_seed(21)
        W, B = ZEROPP["world"], 2048
        n_sh, _ = self.packed_width(ZEROPP["model"], W)
        mag = 10.0 ** torch.randint(-6, 3, (W * n_sh // B, 1), generator=g,
                                    device=self.dev).float()
        x = (torch.randn(W * n_sh // B, B, generator=g, device=self.dev)
             * mag).reshape(-1)
        del mag
        q, sc, row = self.quant_check("llama_750m_packed_dp2", x)
        rows.append(dict(row, W=W, n_sh=n_sh))
        # hpZ's replica hop quantizes a rank's reduced shard [n_sh] (a
        # zshard group of 2 shards as data = 2 does); its dequant-reduce is
        # the [2, n_sh] sum below
        rows.append(self.quant_check("llama_750m_replica_hop_dp4",
                                     x[:n_sh])[2])
        del x
        torch.cuda.empty_cache()
        for mean in (True, False):
            rows.append(self.dequant_check("llama_750m_packed_dp2",
                                           q.view(W, -1), sc.view(W, -1),
                                           mean))
        del q, sc
        torch.cuda.empty_cache()
        C = 2 ** 22
        for Wn in (2, 4, 8):
            qn = torch.randint(-127, 128, (Wn, C), generator=g,
                               device=self.dev, dtype=torch.int8)
            sn = torch.rand(Wn, C // B, generator=g, device=self.dev) + 1e-3
            for mean in (True, False):
                rows.append(self.dequant_check(f"W{Wn}", qn, sn, mean))
        x = torch.randn(6 * B, generator=g, device=self.dev)
        k = torch.arange(-127, 127, device=self.dev, dtype=torch.float32)
        x[:k.numel()] = (k + 0.5) * 0.5               # exact ties at scale .5
        x[B - 1] = 63.5
        x[B:2 * B] = 0.0                              # scale 1
        x[2 * B + 5] = float("inf")                   # scale inf, q 0
        x[3 * B + 9] = float("nan")                   # scale NaN (queue C)
        x[4 * B + 1] = -float("inf")
        q, sc, row = self.quant_check("edges", x)
        scl = sc.tolist()
        if not (scl[0] == 0.5 and scl[1] == 1.0 and scl[2] == float("inf")
                and scl[3] != scl[3] and not q[B:4 * B].any()):
            raise AssertionError(f"quantize edge cases: scales {scl[:5]}")
        rows.append(dict(row, scales=[str(v) for v in scl]))
        for mean in (True, False):
            rows.append(self.dequant_check("edges", q.view(2, -1),
                                           sc.view(2, -1), mean))
        rows.append(self.quant_check("bf16", torch.randn(
            8 * B, generator=g, device=self.dev).bfloat16())[2])
        rows.append(self.quant_check("unaligned_view", torch.randn(
            4 * B + 1, generator=g, device=self.dev)[1:])[2])
        xs = torch.randn(60, generator=g, device=self.dev)
        q6, s6, row = self.quant_check("block6", xs, block=6)
        rows.append(row)
        rows.append(self.dequant_check("block6", q6.view(2, -1),
                                       s6.view(2, -1), True, block=6))
        self.errs["quant_int8"] = self.errs["dequant_reduce"] = 0.0
        torch.cuda.empty_cache()
        return rows

    def close_tol(self, name, got, want, tol):
        diff = (got.float() - want.float()).abs()
        atol, rtol = tol
        bad = diff > atol + rtol * want.float().abs()
        err = float(diff.max()) if diff.numel() else 0.0
        if bool(bad.any()) or not bool(self.torch.isfinite(got.float()).all()):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version: max abs err {err:.3g} (atol "
                                 f"{atol}, rtol {rtol:.3g}), "
                                 f"{int(bad.sum())} elements out of bound")
        return err

    def close_flash(self, name, got, want, want32, dtype, out):
        """A flash or block-sparse output against its plain version: at
        FLASH_TOL, or a bf16 output named in FLASH_BF16_RULE by that rule
        against ``want32``, the plain version on the fp32 upcast of the
        same inputs. Returns (max abs err against the plain version, the
        rule's readings or None)."""
        if dtype != "bfloat16" or out not in FLASH_BF16_RULE:
            return self.close_tol(name, got, want, FLASH_TOL[dtype]), None
        g, w, r = got.float(), want.float(), want32.float()
        diff = (g - w).abs()
        atol, rtol = FLASH_TOL[dtype]
        norm = float(r.norm()) or 1.0
        rel = float((g - r).norm()) / norm
        plain = float((w - r).norm()) / norm
        limit = max(BF16_VS_PLAIN * plain, FLASH_TOL["float32"][1])
        rule = {"rel_l2_vs_fp32": rel, "plain_rel_l2_vs_fp32": plain,
                "limit": limit, "ratio": rel / plain if plain else None,
                "outside_flash_tol": int((diff > atol + rtol * w.abs())
                                         .sum())}
        if not bool(self.torch.isfinite(g).all()) or not rel <= limit:
            raise AssertionError(
                f"{name}: relative L2 distance from the fp32 reference "
                f"{rel:.4g} > {limit:.4g} ({BF16_VS_PLAIN} x the plain bf16 "
                f"path's {plain:.4g}), or not finite")
        return float(diff.max()) if diff.numel() else 0.0, rule

    def flash_inputs(self, B, S, N, K, D, dtype, seed):
        torch = self.torch
        g = torch.Generator(self.dev).manual_seed(seed)
        dt = getattr(torch, dtype)
        q = torch.randn(B, S, N, D, generator=g, device=self.dev).to(dt)
        k = torch.randn(B, S, K, D, generator=g, device=self.dev).to(dt)
        v = torch.randn(B, S, K, D, generator=g, device=self.dev).to(dt)
        do = torch.randn(B, S, N, D, generator=g, device=self.dev).to(dt)
        return q, k, v, do

    def flash_checks(self):
        """Flash forward (o, lse), dq and dkv against the plain versions on
        the same inputs (the backward from the kernel's own o and lse)."""
        from deepspeed_tpu_torch.ops import flash_attention as PF

        rows = []
        for label, B, S, N, K, D, causal in FLASH_CASES:
            for dtype in ("bfloat16", "float32"):
                q, k, v, do = self.flash_inputs(B, S, N, K, D, dtype, seed=S)
                up = [x.float() for x in (q, k, v, do)]
                o, lse = PF.flash_fwd(q, k, v, causal)
                ro, rlse = PF.flash_fwd_ref(q, k, v, causal)
                self.sync()
                tag = f"[{label},{dtype}]"
                errs, rule = {}, {}
                errs["o"], rule["o"] = self.close_flash(
                    "flash_fwd.o" + tag, o, ro,
                    PF.flash_fwd_ref(*up[:3], causal)[0], dtype, "o")
                errs["lse"] = self.close_tol("flash_fwd.lse" + tag, lse,
                                             rlse, FLASH_TOL["float32"])
                del ro, rlse
                grads = PF.flash_bwd(q, k, v, o, lse, do, causal)
                refs = PF.flash_bwd_ref(q, k, v, o, lse, do, causal)
                refs32 = PF.flash_bwd_ref(*up[:3], o.float(), lse, up[3],
                                          causal)
                self.sync()
                for name, got, want, w32 in zip(("dq", "dk", "dv"), grads,
                                                refs, refs32):
                    errs[name], rule[name] = self.close_flash(
                        f"flash_bwd.{name}{tag}", got, want, w32, dtype,
                        name)
                del up, refs32
                if label == "gpt2_125m" and dtype == "bfloat16":
                    self.errs.update(flash_fwd=max(errs["o"], errs["lse"]),
                                     flash_bwd_dq=errs["dq"],
                                     flash_bwd_dkv=max(errs["dk"],
                                                       errs["dv"]))
                rows.append({"kernel": "flash_attention", "shape": label,
                             "B": B, "S": S, "N": N, "K": K, "D": D,
                             "causal": causal, "dtype": dtype,
                             "max_abs_err": errs, "tol": FLASH_TOL[dtype],
                             "bf16_rule": {k: v for k, v in rule.items()
                                           if v is not None} or None})
                del q, k, v, do, o, lse, grads, refs
                self.torch.cuda.empty_cache()
        return rows

    def adam_checks(self):
        """Fused Adam on a flat buffer of each trained model's size (+3, a
        ragged tail; llama_750m's 2.66 GB buffers pass 2^31 bytes), Adam and
        AdamW with weight decay, bf16 copy written: the kernel rounds every
        operation as its plain version does, so p, m, v and the copy are
        held to the fp32 tolerance and compared bit for bit as well."""
        torch = self.torch
        from deepspeed_tpu_torch.models import transformer as T

        g = torch.Generator(self.dev).manual_seed(3)
        rows = []
        presets = dict.fromkeys(t.get("model", m) for m, t in TRAIN.items())
        for model in presets:
            n = T.get_model_config(model).num_params() + 3
            for adam_w in (True, False):
                rows.append(self.adam_check(model, n, adam_w, g))
        return rows

    def adam_check(self, model, n, adam_w, g):
        torch = self.torch
        from deepspeed_tpu_torch.ops import fused_adam as FA

        p = torch.randn(n, generator=g, device=self.dev)
        grad = 0.01 * torch.randn(n, generator=g, device=self.dev)
        m = 0.001 * torch.randn(n, generator=g, device=self.dev)
        v = 1e-6 * torch.rand(n, generator=g, device=self.dev)
        ref = [t.clone() for t in (p, m, v)]
        out = torch.empty(n, dtype=torch.bfloat16, device=self.dev)
        rout = torch.empty_like(out)
        bc1, bc2 = FA.bias_corrections(3, (0.9, 0.999))
        args = (1e-4, (0.9, 0.999), 1e-8, 0.1, bc1, bc2)
        FA.fused_adam(p, grad, m, v, *args, adam_w=adam_w, out=out)
        FA.fused_adam_ref(*ref[:1], grad, *ref[1:], *args, adam_w=adam_w,
                          out=rout)
        self.sync()
        tag = f"[{model},adam_w={adam_w}]"
        errs = {name: self.close(f"fused_adam.{name}{tag}", got, want,
                                 "float32")
                for name, got, want in zip(("p", "m", "v"), (p, m, v), ref)}
        errs["bf16_copy"] = self.close(f"fused_adam.copy{tag}", out, rout,
                                       "bfloat16")
        bitwise = all(bool(torch.equal(a, b)) for a, b in
                      zip((p, m, v, out), (*ref, rout)))
        self.errs["fused_adam"] = max(self.errs.get("fused_adam", 0.0),
                                      *errs.values())
        del p, grad, m, v, ref, out, rout
        torch.cuda.empty_cache()
        return {"kernel": "fused_adam", "shape": model, "n": n,
                "adam_w": adam_w, "weight_decay": 0.1, "max_abs_err": errs,
                "bitwise_equal": bitwise, "tol": TOL["float32"]}

    @staticmethod
    def gmm_sizes(M, E, tail=0):
        """A fixed uneven split of M - tail rows over E groups, weights E,
        0, E-2, ..., 1: group 1 empty, group 0 the largest (4 groups of
        32,768 rows: 18,725 / 0 / 9,362 / 4,681), no size a multiple of
        the 128-row tile."""
        w = np.array([E - i for i in range(E)], np.float64)
        w[1] = 0.0
        sizes = np.floor(w / w.sum() * (M - tail)).astype(np.int64)
        sizes[0] += M - tail - sizes.sum()
        return sizes.astype(np.int32)

    def gmm_inputs(self, M, K, N, E, dtype, sizes, seed):
        """lhs [M, K], rhs [E, K, N] / sqrt(K) and dy [M, N]: gmm outputs
        of O(1) (``gmm_checks`` scales dy by 1 / sqrt(the largest group's
        rows) for tgmm)."""
        torch = self.torch
        g = torch.Generator(self.dev).manual_seed(seed)
        dt = getattr(torch, dtype)
        lhs = torch.randn(M, K, generator=g, device=self.dev).to(dt)
        rhs = (torch.randn(E, K, N, generator=g, device=self.dev)
               / K ** 0.5).to(dt)
        dy = torch.randn(M, N, generator=g, device=self.dev).to(dt)
        gs = torch.from_numpy(sizes).to(self.dev)
        return lhs, rhs, dy, gs

    def gmm_checks(self):
        """gmm, gmm with the rhs transposed (the input gradient: dy [M, N]
        against rhs [E, K, N]) and tgmm against their plain versions."""
        from deepspeed_tpu_torch.ops import grouped_gemm as GG

        rows = []
        for label, M, K, N, E, tail in GMM_CASES:
            sizes = self.gmm_sizes(M, E, tail)
            for dtype in ("bfloat16", "float32"):
                lhs, rhs, dy, gs = self.gmm_inputs(M, K, N, E, dtype, sizes,
                                                   seed=M + K)
                tag = f"[{label},{dtype}]"
                tol = GMM_TOL[dtype]
                errs = {}
                got, want = GG.gmm(lhs, rhs, gs), GG.gmm_ref(lhs, rhs, gs)
                self.sync()
                errs["gmm"] = self.close_tol("gmm" + tag, got, want, tol)
                del got, want
                got = GG.gmm(dy, rhs, gs, transpose_rhs=True)
                want = GG.gmm_ref(dy, rhs, gs, transpose_rhs=True)
                self.sync()
                errs["gmm_transpose_rhs"] = self.close_tol(
                    "gmm_transpose_rhs" + tag, got, want, tol)
                del got, want
                dyt = (dy.float() / float(sizes.max()) ** 0.5).to(dy.dtype)
                got, want = GG.tgmm(lhs, dyt, gs), GG.tgmm_ref(lhs, dyt, gs)
                self.sync()
                errs["tgmm"] = self.close_tol("tgmm" + tag, got, want, tol)
                empty = bool((got[1] == 0).all())
                if not empty:
                    raise AssertionError(f"tgmm{tag}: the empty group's "
                                         "gradient is not zero")
                if label == "moe_350m_up" and dtype == "bfloat16":
                    self.errs.update(gmm=max(errs["gmm"],
                                             errs["gmm_transpose_rhs"]),
                                     tgmm=errs["tgmm"])
                rows.append({"kernel": "grouped_gemm", "shape": label,
                             "M": M, "K": K, "N": N, "E": E,
                             "group_sizes": sizes.tolist(), "dtype": dtype,
                             "max_abs_err": errs, "tol": tol})
                del lhs, rhs, dy, dyt, gs, got, want
                self.torch.cuda.empty_cache()
        return rows

    @staticmethod
    def sparse_layout(kind, n_blocks, causal):
        """The model path's layouts (``causal_layout`` when causal), or
        ``inactive_row``: bslongformer with q square 1 attending nothing and
        the last kv square attended by nothing."""
        from deepspeed_tpu_torch.ops import block_sparse as BS

        if kind == "inactive_row":
            lay = BS.bslongformer_layout(n_blocks)
            lay[1] = 0
            lay[:, -1] = 0
            return lay
        if kind == "dense":
            return BS.dense_layout(n_blocks)
        lay = BS.MODEL_LAYOUTS[kind](n_blocks)
        return BS.causal_layout(lay) if causal else lay

    def sparse_checks(self):
        """Block-sparse forward (o, lse), dq and dkv against the plain
        versions on the same inputs (the backward from the kernel's own o
        and lse); the inactive squares' zeros; and a dense layout against
        the flash kernel (JAX's test_matches_dense_flash_semantics)."""
        torch = self.torch
        from deepspeed_tpu_torch.ops import block_sparse as BS
        from deepspeed_tpu_torch.ops import flash_attention as PF

        blk = SPARSE_BLOCK
        rows = []
        for label, B, S, N, K, D, kind, causal in SPARSE_CASES:
            lay = self.sparse_layout(kind, S // blk, causal)
            for dtype in ("bfloat16", "float32"):
                q, k, v, do = self.flash_inputs(B, S, N, K, D, dtype,
                                                seed=S + D)
                tag = f"[{label},{dtype}]"
                tol = FLASH_TOL[dtype]
                up = [x.float() for x in (q, k, v, do)]
                o, lse = BS.block_sparse_fwd(q, k, v, lay, blk, causal)
                ro, rlse = BS.block_sparse_fwd_ref(q, k, v, lay, blk, causal)
                self.sync()
                errs, rule = {}, {}
                errs["o"], rule["o"] = self.close_flash(
                    "block_sparse_fwd.o" + tag, o, ro,
                    BS.block_sparse_fwd_ref(*up[:3], lay, blk, causal)[0],
                    dtype, "o")
                errs["lse"] = self.close_tol("block_sparse_fwd.lse" + tag,
                                             lse, rlse, FLASH_TOL["float32"])
                del ro, rlse
                grads = BS.block_sparse_bwd(q, k, v, o, lse, do, lay, blk,
                                            causal)
                refs = BS.block_sparse_bwd_ref(q, k, v, o, lse, do, lay, blk,
                                               causal)
                refs32 = BS.block_sparse_bwd_ref(*up[:3], o.float(), lse,
                                                 up[3], lay, blk, causal)
                self.sync()
                for name, got, want, w32 in zip(("dq", "dk", "dv"), grads,
                                                refs, refs32):
                    errs[name], rule[name] = self.close_flash(
                        f"block_sparse_bwd.{name}{tag}", got, want, w32,
                        dtype, name)
                del up, refs32
                if kind == "inactive_row":
                    dead_q = slice(blk, 2 * blk)
                    dead_kv = slice(S - blk, S)
                    lse_q = lse.reshape(B, N, S)[:, :, dead_q]
                    zeros = (bool((o[:, dead_q] == 0).all())
                             and bool((lse_q == BS.NEG_INF).all())
                             and bool((grads[0][:, dead_q] == 0).all())
                             and bool((grads[1][:, dead_kv] == 0).all())
                             and bool((grads[2][:, dead_kv] == 0).all()))
                    if not zeros:
                        raise AssertionError(
                            f"block_sparse{tag}: the inactive squares' o, "
                            "lse, dq, dk, dv are not 0 / -1e30")
                if label == "llama_750m_fixed" and dtype == "bfloat16":
                    self.errs.update(
                        block_sparse_fwd=max(errs["o"], errs["lse"]),
                        block_sparse_bwd_dq=errs["dq"],
                        block_sparse_bwd_dkv=max(errs["dk"], errs["dv"]))
                rows.append({"kernel": "block_sparse_attention",
                             "shape": label, "B": B, "S": S, "N": N, "K": K,
                             "D": D, "block": blk, "layout": kind,
                             "causal": causal, "active_squares": int(
                                 (lay != 0).sum()), "squares": lay.size,
                             "dtype": dtype, "max_abs_err": errs,
                             "tol": tol,
                             "bf16_rule": {k: v for k, v in rule.items()
                                           if v is not None} or None})
                del q, k, v, do, o, lse, grads, refs
                torch.cuda.empty_cache()
        # a dense layout runs the flash kernels' arithmetic over the same
        # tiles in the same order: equal to flash attention
        for dtype in ("bfloat16", "float32"):
            B, S, N, K, D = 2, 1024, 12, 4, 128
            q, k, v, do = self.flash_inputs(B, S, N, K, D, dtype, seed=5)
            lay = self.sparse_layout("dense", S // blk, True)
            o, lse = BS.block_sparse_fwd(q, k, v, lay, blk, True)
            fo, flse = PF.flash_fwd(q, k, v, True)
            grads = BS.block_sparse_bwd(q, k, v, o, lse, do, lay, blk, True)
            fgrads = PF.flash_bwd(q, k, v, fo, flse, do, True)
            self.sync()
            tag = f"[dense_layout_vs_flash,{dtype}]"
            errs = {n: self.close_tol(f"block_sparse.{n}{tag}", a, b,
                                      FLASH_TOL[dtype])
                    for n, a, b in zip(("o", "lse", "dq", "dk", "dv"),
                                       (o, lse, *grads), (fo, flse, *fgrads))}
            bitwise = all(bool(torch.equal(a, b)) for a, b in
                          zip((o, lse, *grads), (fo, flse, *fgrads)))
            rows.append({"kernel": "block_sparse_attention",
                         "shape": "dense_layout_vs_flash", "B": B, "S": S,
                         "N": N, "K": K, "D": D, "block": blk,
                         "layout": "dense", "causal": True, "dtype": dtype,
                         "against": "flash kernels", "max_abs_err": errs,
                         "bitwise_equal": bitwise, "tol": FLASH_TOL[dtype]})
            del q, k, v, do, o, lse, fo, flse, grads, fgrads
            torch.cuda.empty_cache()
        return rows

    def evo_inputs(self, G, S, N, D, bias_kind, dtype, seed):
        """q/k/v [G, S, N, D] and the kernel's bias [Gb, N, S, S]:
        ``shared`` a pair bias [1, N, S, S]; ``per_row`` [G, N, S, S];
        ``mask+shared`` a key mask [G, 1, 1, S] (0 or -1e9, row 0 -inf
        everywhere: its output is 0) plus a shared bias, summed as the
        entry point sums them (into [G, N, S, S])."""
        torch = self.torch
        g = torch.Generator(self.dev).manual_seed(seed)
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(G, S, N, D, generator=g, device=self.dev)
                   .to(dt) for _ in range(3))
        if bias_kind == "per_row":
            bias = torch.randn(G, N, S, S, generator=g, device=self.dev)
        else:
            bias = torch.randn(1, N, S, S, generator=g, device=self.dev)
        if bias_kind == "mask+shared":
            keep = torch.rand(G, 1, 1, S, generator=g, device=self.dev) < 0.9
            mask = torch.where(keep, 0.0, -1e9)
            mask[0] = float("-inf")
            bias = (mask + bias).contiguous()
        return q, k, v, bias.to(dt)

    def evo_checks(self):
        """The Evoformer forward kernel against its plain version, bf16 and
        fp32 (the bias in the same dtype), and bf16 q/k/v with an fp32
        bias: fp32 at TOL; bf16, whose P enters the tensor cores in bf16,
        by flash's bf16 rule (``close_flash``: relative L2 from the plain
        version on the fp32 upcast at most BF16_VS_PLAIN times the plain
        bf16 path's); a row masked everywhere exactly 0."""
        torch = self.torch
        from deepspeed_tpu_torch.ops import evoformer as EV

        rows = []
        for label, G, S, N, D, bias_kind in EVO_CASES:
            for dtype in ("bfloat16", "float32", "bfloat16+fp32_bias"):
                if dtype.endswith("bias") and label != "msa_row":
                    continue
                qdt = dtype.split("+")[0]
                q, k, v, bias = self.evo_inputs(G, S, N, D, bias_kind, qdt,
                                                seed=G + S + D)
                if dtype.endswith("bias"):
                    bias = bias.float()
                got = EV.evoformer_fwd(q, k, v, bias)
                want = EV.evoformer_flash_ref(q, k, v, bias)
                self.sync()
                tag = f"[{label},{dtype}]"
                rule = None
                if qdt == "bfloat16":
                    # P enters the tensor cores in bf16: flash's bf16 rule
                    want32 = EV.evoformer_flash_ref(
                        *(x.float() for x in (q, k, v, bias)))
                    err, rule = self.close_flash(f"evoformer_fwd{tag}", got,
                                                 want, want32, qdt, "o")
                    del want32
                else:
                    err = self.close(f"evoformer_fwd{tag}", got, want, qdt)
                if bias_kind == "mask+shared" and not bool((got[0] == 0)
                                                           .all()):
                    raise AssertionError(f"evoformer_fwd{tag}: a row masked "
                                         "everywhere is not 0")
                if label == "msa_row" and dtype == "bfloat16":
                    self.errs["evoformer_fwd"] = err
                rows.append({"kernel": "evoformer_fwd", "shape": label,
                             "G": G, "S": S, "N": N, "D": D,
                             "bias": list(bias.shape), "bias_kind": bias_kind,
                             "dtype": dtype, "max_abs_err": err,
                             "tol": TOL[qdt], "bf16_rule": rule})
                del q, k, v, bias, got, want
                torch.cuda.empty_cache()
        return rows

    # ------------------------------------------------------------------ #
    def reset_counts(self):
        reset_counts()

    def read_counts(self):
        return read_counts()

    def serve(self, model, n_req, lo, hi, max_new, norm_kind, **engine_kw):
        """One model's main-path run + checks, the graph gates (G1-G5) and
        a mixed-tick comparison."""
        torch = self.torch
        from deepspeed_tpu_torch import telemetry
        from deepspeed_tpu_torch.inference.fastgen import FastGenEngine

        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        eng = FastGenEngine(model, device=self.dev, seed=self.seed,
                            temperature=0.0, **engine_kw)
        self.sync()
        init_s = time.perf_counter() - t0
        addresses = engine_addresses(eng)
        cfg = eng.cfg
        vocab = min(cfg.vocab_size, 32000)
        rng = np.random.default_rng(self.seed)
        lens = [int(n) for n in rng.integers(lo, hi + 1, n_req)]
        prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
        uids = list(range(n_req))
        free0 = eng.allocator.free_blocks
        ticks = telemetry.get_registry().counter("fastgen_ticks_total")

        # ---- the main path: counts to 0 just before, read just after ---- #
        ticks0, dev_ticks0 = ticks.total(), eng.device_ticks.copy()
        self.reset_counts()
        t0 = time.perf_counter()
        out = eng.generate_all(uids, prompts, max_new_tokens=max_new)
        self.sync()
        wall = time.perf_counter() - t0
        counts = self.read_counts()
        n_ticks = int(ticks.total() - ticks0)
        # ----------------------------------------------------------------- #
        # every tick the device ran, with its rows, as the engine kept them:
        # the replays, the eager ticks, and each captured key's warm-up
        dev_ticks = eng.device_ticks - dev_ticks0
        tick_rows = [rows for (_, rows), n in sorted(dev_ticks.items())
                     for _ in range(n)]
        served_rows = [rows for (how, rows), n in sorted(dev_ticks.items())
                       if how != "warmup" for _ in range(n)]
        L = cfg.num_layers
        from deepspeed_tpu_torch.ops import paged_attention as PA
        n_w = ((3 if cfg.activation == "swiglu" else 2) if cfg.n_experts
               else 0)
        want = serving_launches_want(L, tick_rows, norm_kind, PA.MIN_RUN,
                                     moe_gmm=n_w)
        problems = []
        if len(served_rows) != n_ticks:
            problems.append(f"{len(served_rows)} device ticks, {n_ticks} "
                            "ticks")
        if self.dev.type == "cuda" and any(
                how == "eager" for how, _ in dev_ticks):
            problems.append(f"eager ticks on the card: {dict(dev_ticks)}")
        for k, v in want.items():
            if counts[k] != v:
                problems.append(f"{k} launched {counts[k]} times, want {v}")
        short = {u: len(t) for u, t in out.items() if len(t) != max_new}
        if short:
            problems.append(f"uids with fewer than {max_new} tokens: {short}")
        if eng.allocator.free_blocks != free0:
            problems.append(f"free blocks {eng.allocator.free_blocks} after "
                            f"flush, {free0} before")
        on_cpu = [n for n, p in eng.model.named_parameters()
                  if p.device != self.dev] + [k for k, v in eng.pool.items()
                                              if v.device != self.dev]
        if on_cpu:
            problems.append(f"tensors on the CPU: {on_cpu}")
        toks = np.array([t for u in uids for t in out[u]])
        if toks.size and (toks.min() < 0 or toks.max() >= cfg.vocab_size):
            problems.append("sampled token ids out of the vocabulary")
        if problems:
            raise AssertionError(f"{model}: " + "; ".join(problems))
        for k in want:
            self.launches.setdefault(k, {})[model] = counts[k]
        self.ticks[model] = n_ticks
        peak = (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else None)
        ttft = list(eng.ttft_log)[-n_req:]      # this run's requests
        emit(model, requests=n_req, prompt_lens=lens, max_new_tokens=max_new,
             ticks=n_ticks, tick_rows=sorted(set(tick_rows)),
             device_ticks={f"{how}[{rows}]": n
                           for (how, rows), n in sorted(dev_ticks.items())},
             ticks_with_a_plan=sum(t >= PA.MIN_RUN for t in tick_rows),
             launches=counts, launches_want=want,
             init_seconds=init_s, generate_all_seconds=wall,
             ttft_p50_s=float(np.median(ttft)), peak_memory_bytes=peak,
             graphs=eng.graph_stats(),
             card=self.card, first_tokens={u: out[u][:4] for u in uids[:2]})

        gates = self.graph_gates(model, eng, prompts)
        self.mixed_tick(model, eng, uids, prompts)
        moved = {k for k, v in engine_addresses(eng).items()
                 if addresses.get(k) != v}
        warmups = sum(n for (how, _), n in eng.device_ticks.items()
                      if how == "warmup")
        emit(f"{model}/graphs_g4", moved=sorted(moved), graphs=len(
            eng._tick_graphs), warmups=warmups, keys=sorted(
                map(str, eng._tick_graphs)))
        if moved or (eng._graphs and warmups != len(eng._tick_graphs)):
            raise AssertionError(
                f"{model}: G4: moved {sorted(moved)}; {warmups} captures for "
                f"{len(eng._tick_graphs)} graph keys")
        self.state[model] = {"engine": eng, "prompts": prompts, "lens": lens,
                             "gates": gates}
        return eng

    # ------------------------------------------------------------------ #
    # CUDA graphs of the ticks
    # ------------------------------------------------------------------ #
    def prefill(self, eng, uids, prompts):
        eng.put(uids, prompts)
        while not all(eng.seqs[u].prefill_remaining == 0
                      and eng.seqs[u].last_tok is not None for u in uids):
            eng.step()

    def saver(self, eng, live):
        """(save, restore, the pool's copy) of an engine's state over the
        sequences in ``live``: their host bookkeeping, the allocator and the
        KV pool (one clone, reused); saved once here. A restore may be
        repeated."""
        saved = {k: v.clone() for k, v in eng.pool.items()}
        host = {}

        def save():
            for k, v in eng.pool.items():
                saved[k].copy_(v)
            host["state"] = eng._snapshot_host(live), eng._decode_rr

        def restore():
            snap, rr = copy.deepcopy(host["state"])
            eng._restore_host(snap)
            eng._decode_rr = rr
            for k, v in eng.pool.items():
                v.copy_(saved[k])

        save()
        return save, restore, saved

    def graph_gates(self, model, eng, prompts):
        """G1-G3 and G5 on the main path's engine (G4 closes the phase):
        each compares graph ticks with eager ticks or with another entry
        point from one state, restored between the two runs."""
        torch = self.torch
        uids = list(range(1000, 1000 + len(prompts)))
        self.prefill(eng, uids, prompts)
        live = [eng.seqs[u] for u in uids]
        save, restore, saved = self.saver(eng, live)
        out = {}
        # G1: a 32-tick decode_steps window, eager then graphs
        out["g1_decode"] = self.graph_vs_eager(
            eng, lambda: eng.decode_steps(32), lambda: len(live), restore)
        # ... and one SplitFuse tick of >= MIN_RUN rows: the decode rows
        # and a chunk of a new prompt (the plan and prefill kernels); its
        # real rows are the decode rows and the chunk
        extra = 1000 + len(prompts)
        eng.put([extra], [prompts[0][:1] + prompts[-1]])
        live.append(eng.seqs[extra])
        save()
        out["g1_splitfuse"] = self.graph_vs_eager(
            eng, eng.step, lambda: len(uids) + live[-1].prefilled, restore)
        eng.flush([extra])
        live.pop()
        # G2: a new key's warm-up and capture touch only trash block 0
        save()
        key = ("dec", 128, eng.max_blocks_per_seq)
        t0 = time.perf_counter()
        if eng._graphs and key not in eng._tick_graphs:
            eng._tick_graph(key, 128, eng.max_blocks_per_seq, decode=True)
        self.sync()
        touched = [k for k, v in eng.pool.items()
                   if not torch.equal(v[:, 1:], saved[k][:, 1:])]
        out["g2"] = {"key": str(key), "seconds": time.perf_counter() - t0,
                     "blocks_other_than_0_changed": touched}
        if touched:
            raise AssertionError(f"{model}: G2: capturing {key} changed KV "
                                 f"blocks other than 0 in {touched}")
        # G3: decode_stream against decode_steps, four windows of 8: the
        # stream yields three and is closed, its window in flight drained
        save()
        steps = [eng.decode_steps(8) for _ in range(4)]
        want = {s.uid: (list(s.generated), s.pos, s.last_tok) for s in live}
        restore()
        served = []
        for emitted in eng.decode_stream(window=8):
            served.append(emitted)
            if len(served) == 3:
                break
        got = {s.uid: (list(s.generated), s.pos, s.last_tok) for s in live}
        out["g3"] = {"windows": len(served), "rows": len(live),
                     "tokens_equal": got == want and served == steps[:3]}
        if not out["g3"]["tokens_equal"]:
            raise AssertionError(f"{model}: G3: decode_stream differs from "
                                 "decode_steps")
        eng.flush(uids)
        del save, restore, saved            # the pool's copy
        out["g5"] = self.sampling_gate(model, eng, prompts)
        emit(f"{model}/graph_gates", **out)
        return out

    def graph_vs_eager(self, eng, run, real_rows, restore):
        """G1: ``run`` eagerly, then (state restored) through the graphs:
        the sampled tokens equal on every row and tick, the last tick's
        logits of its ``real_rows()`` rows bit-equal (else within TOL, with
        the largest difference shown; pad rows read the trash block, which
        a warm-up may have written)."""
        torch = self.torch
        real = eng._run_tick
        kept = {}

        def eager_tick(*a):
            kept["logits"], sampled = real(*a)
            return kept["logits"], sampled

        results = {}
        for mode in ("eager", "graph"):
            if mode == "graph":
                restore()
            eng._graphs = mode == "graph" and self.dev.type == "cuda"
            ticks0 = eng.device_ticks.copy()
            replays0 = {k: g.replays for k, g in eng._tick_graphs.items()}
            if not eng._graphs:
                eng._run_tick = eager_tick
            try:
                got = run()
            finally:
                eng.__dict__.pop("_run_tick", None)
            self.sync()
            ran = [g for k, g in eng._tick_graphs.items()
                   if g.replays > replays0.get(k, 0)]
            if eng._graphs and len(ran) != 1:
                raise AssertionError(f"G1: {len(ran)} graphs replayed")
            logits = ran[0].logits if eng._graphs else kept.pop("logits")
            results[mode] = (got, logits, eng.device_ticks - ticks0)
        eng._graphs = self.dev.type == "cuda"
        (got_e, le, ticks_e), (got_g, lg, ticks_g) = (results["eager"],
                                                      results["graph"])
        n = real_rows()
        bit_equal = bool(torch.equal(le[:n], lg[:n]))
        res = {"tokens_equal": got_e == got_g, "logits_bit_equal": bit_equal,
               "logits_max_abs_diff": float((le[:n] - lg[:n]).abs().max()),
               "rows": n, "ticks": {mode: {f"{how}[{rows}]": c for (how, rows),
                                           c in sorted(t.items())}
                                    for mode, t in (("eager", ticks_e),
                                                    ("graph", ticks_g))}}
        if got_e != got_g:
            raise AssertionError(f"G1: graph tokens differ from eager: {res}")
        if not bit_equal:
            self.close_tol("G1 logits graph vs eager", lg[:n], le[:n],
                           TOL["bfloat16"])
        return res

    def sampling_gate(self, model, eng, prompts):
        """G5: temperature 0.8, top-k 20, top-p 0.9 through the graphs: two
        engines made from one seed (sharing the main engine's weights, each
        with a small pool) give the same tokens, and the default CUDA
        generator is never drawn from; an eager engine of the same seed
        beside them, reported."""
        torch = self.torch
        from deepspeed_tpu_torch.inference.fastgen import FastGenEngine

        kw = dict(params=eng.model, device=self.dev, n_blocks=64,
                  block_size=eng.block_size,
                  max_blocks_per_seq=eng.max_blocks_per_seq,
                  token_budget=eng.token_budget, temperature=0.8, top_k=20,
                  top_p=0.9, seed=self.seed + 11)
        short = [p[:48] for p in prompts[:4]]
        uids = list(range(len(short)))
        cuda = self.dev.type == "cuda"
        rng0 = torch.cuda.get_rng_state(self.dev) if cuda else None
        outs, how = [], []
        for graphs in (True, True, False):
            e = FastGenEngine(eng.cfg, **kw)
            e._graphs = graphs and cuda
            outs.append(e.generate_all(uids, short, max_new_tokens=16))
            how.append(sorted({h for h, _ in e.device_ticks}))
            del e
        drew_default = cuda and not torch.equal(
            rng0, torch.cuda.get_rng_state(self.dev))
        res = {"same_seed_equal": outs[0] == outs[1],
               "graph_equals_eager": outs[0] == outs[2],
               "default_generator_drawn": drew_default, "ticks": how,
               "tokens": {u: outs[0][u][:6] for u in uids[:2]}}
        if not res["same_seed_equal"] or drew_default or (
                cuda and how[:2] != [["replay", "warmup"]] * 2):
            raise AssertionError(f"{model}: G5: {res}")
        return res

    def mixed_tick(self, model, eng, uids, prompts):
        """One mixed (decode + prefill) tick of the main path's requests,
        four ways: {bf16, fp32} x {kernels, plain}. The tick reads a
        compact copy of the blocks it names, so the fp32 pool stays small;
        the host state is rolled back, so the engine never ran the tick."""
        torch = self.torch
        import dataclasses
        from deepspeed_tpu_torch.models import paged as PG

        eng.put(uids, prompts)
        for _ in range(100):
            live = [s for s in eng.seqs.values() if not s.done]
            if any(s.prefill_remaining == 0 and s.last_tok is not None
                   for s in live) and any(s.prefill_remaining > 0
                                          for s in live):
                break
            eng.step()
        else:
            raise AssertionError(f"{model}: no mixed tick in 100 steps")
        snap, rr = eng._snapshot_host(live), eng._decode_rr
        tokens, positions, tables, heads, row = eng._schedule_tick(live)
        eng._restore_host(snap)
        eng._decode_rr = rr
        mb = eng._mb_tier(int(positions[:row].max()) // eng.block_size + 1)
        tables = tables[:, :mb]
        # the plan that forward_paged builds for this tick, on the card,
        # against the host's runs: both regimes have rows
        from deepspeed_tpu_torch.ops import paged_attention as PA
        pre = prefill_rows(tables, PA.MIN_RUN)
        plan = PA.build_plan(eng._to_dev(tables))
        n_dec, n_tiles = int(plan.n_dec), int(plan.n_tiles)
        if n_dec != int((~pre).sum()) or not (n_dec and n_tiles):
            raise AssertionError(
                f"{model}: mixed tick plan: {n_dec} decode rows, {n_tiles} "
                f"prefill tiles; the host's runs give {int((~pre).sum())} "
                "decode rows and both regimes")
        used = np.unique(np.concatenate([[0], tables.ravel()]))
        remap = np.zeros(eng.allocator.n_blocks, np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        tk, ps, tb = (eng._to_dev(a) for a in (tokens, positions,
                                                remap[tables]))
        idx = torch.from_numpy(used).to(self.dev)
        cfg32 = dataclasses.replace(eng.cfg, dtype="float32")

        def upcast(tree):
            return {k: upcast(v) if isinstance(v, dict) else v.float()
                    for k, v in tree.items()}

        logits = {}
        for prec, cfg, params in (("bf16", eng.cfg, eng.params),
                                  ("fp32", cfg32, None)):
            if params is None:
                params = upcast(eng.params)
            for path, kern in (("kernels", True), ("plain", False)):
                pool = {k: v[:, idx].to(cfg.compute_dtype)
                        for k, v in eng.pool.items()}
                lg, _ = PG.forward_paged(params, tk, ps, tb, pool, cfg,
                                         use_kernels=kern)
                logits[(prec, path)] = lg[:row]
                del pool
            del params
        eng.flush(uids)

        def cmp(a, b):
            a, b = logits[a], logits[b]
            return (float((a.argmax(-1) == b.argmax(-1)).float().mean()),
                    float((a - b).abs().max() / b.abs().max()))

        top1_32, rel_32 = cmp(("fp32", "kernels"), ("fp32", "plain"))
        top1_16, rel_16 = cmp(("bf16", "kernels"), ("bf16", "plain"))
        top1_k, rel_k = cmp(("bf16", "kernels"), ("fp32", "plain"))
        top1_p, rel_p = cmp(("bf16", "plain"), ("fp32", "plain"))
        finite = all(bool(torch.isfinite(v).all()) for v in logits.values())
        n_plan_dec, n_dec = n_dec, sum(1 for h in heads if h[2])
        emit(f"{model}/mixed_tick", rows=row, decode_rows=n_dec,
             prefill_rows=row - n_dec, table_width=mb, blocks=len(used),
             plan={"decode_rows": n_plan_dec, "prefill_tiles": n_tiles,
                   "tick_rows": len(tables)},
             fp32_kernels_vs_plain={"top1": top1_32, "rel_err": rel_32},
             bf16_kernels_vs_plain={"top1": top1_16, "rel_err": rel_16},
             bf16_kernels_vs_fp32={"top1": top1_k, "rel_err": rel_k},
             bf16_plain_vs_fp32={"top1": top1_p, "rel_err": rel_p},
             bounds={"fp32_rel": LOGIT_REL_TOL_FP32, "fp32_top1": TOP1_MIN,
                     "bf16_vs_plain": BF16_VS_PLAIN,
                     "bf16_top1_slack": BF16_TOP1_SLACK}, finite=finite)
        problems = []
        if not finite:
            problems.append("non-finite logits")
        if top1_32 < TOP1_MIN or rel_32 > LOGIT_REL_TOL_FP32:
            problems.append(f"fp32 top1 {top1_32}, rel err {rel_32:.3g}")
        if rel_k > BF16_VS_PLAIN * rel_p or top1_k < top1_p - BF16_TOP1_SLACK:
            problems.append(f"bf16 kernels vs fp32: top1 {top1_k}, rel err "
                            f"{rel_k:.3g}; plain: top1 {top1_p}, rel err "
                            f"{rel_p:.3g}")
        if problems:
            raise AssertionError(f"{model}: mixed tick kernel vs plain: "
                                 + "; ".join(problems))

    def phase_llama2_7b(self):
        self.serve("llama2_7b", 8, 16, 1024, 32, "rms_norm", n_blocks=512,
                   block_size=32, max_blocks_per_seq=64, token_budget=256)

    def phase_gpt2_125m(self):
        # the repo's serving-bench settings (bench.py fastgen entry)
        self.serve("gpt2_125m", 8, 16, 480, 32, "layer_norm", n_blocks=512,
                   block_size=64, max_blocks_per_seq=16, token_budget=512,
                   max_seq_len=1024)

    def phase_moe_350m(self):
        """moe_350m at full size (4 experts top-2, the dropless dispatch
        over each tick's rows), bf16, 8 requests of 16-1024 prompt tokens
        and 32 new: the main path on the tick graphs with its launches
        (2 gmm a layer and tick), G1-G5 and the mixed tick, then its decode
        rate and TTFT here, and the engine freed (the later phases' would
        not fit beside it and the two dense serving engines). The learned
        position table has 2048 rows (random, from the seed) so a 1024-token
        prompt and its 32 new tokens fit."""
        self.serve("moe_350m", 8, 16, 1024, 32, "layer_norm", n_blocks=512,
                   block_size=64, max_blocks_per_seq=32, token_budget=512,
                   max_seq_len=2048)
        rate = self.decode_rate("moe_350m")
        emit("moe_350m/decode", **rate)
        self.state["moe_350m_decode"] = rate
        self.state.pop("moe_350m")
        self.torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #
    @staticmethod
    def train_config(micro, gas, precision):
        cfg = {"train_micro_batch_size_per_gpu": micro,
               "gradient_accumulation_steps": gas,
               "optimizer": {"type": "adam", "params": {"lr": TRAIN_LR}},
               "zero_optimization": {"stage": 1},
               "steps_per_print": 10 ** 9}
        if precision == "bf16":
            cfg["bf16"] = {"enabled": True}
        return cfg

    def train(self, model):
        """The main path: ``initialize`` + ``train_batch`` at full width and
        depth on a fixed batch; counters to 0 just before the timed steps,
        read just after; then the kernel-vs-plain step gate."""
        torch = self.torch
        import itertools

        import deepspeed_tpu_torch as dtt
        from deepspeed_tpu_torch.ops import norms

        t = TRAIN[model]
        micro, seq, gas, steps = t["micro"], t["seq"], t["gas"], t["steps"]
        attention = t.get("attention", "flash")
        torch.cuda.reset_peak_memory_stats(self.dev)
        base = torch.cuda.memory_allocated(self.dev)   # earlier phases' engines
        t0 = time.perf_counter()
        spec = dtt.causal_lm_spec(t.get("model", model), attention=attention,
                                  remat="full")
        engine, *_ = dtt.initialize(model=spec, config=self.train_config(
            micro, gas, "bf16"))
        self.sync()
        init_s = time.perf_counter() - t0
        cfg = spec.config
        rng = np.random.default_rng(self.seed)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (micro, seq),
                                        dtype=np.int32)}
        data = itertools.repeat(batch)
        t0 = time.perf_counter()
        with recorded_routes() as routes:
            first = float(engine.train_batch(data))  # warm-up (first compiles)
        warm_s = time.perf_counter() - t0

        # ---- the main path: counts to 0 just before, read just after ---- #
        self.reset_counts()
        losses, walls = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = engine.train_batch(data)
            self.sync()
            walls.append(time.perf_counter() - t0)
            losses.append(float(loss))
        counts = self.read_counts()
        bwd_calls = dict(norms.backward_calls)
        # ----------------------------------------------------------------- #
        L, norm = cfg.num_layers, t["norm"]
        micros = gas * steps
        # each expert weight: one gmm forward, again in the remat recompute,
        # one gmm with the rhs transposed (input gradient) and one tgmm
        # (weight gradient); 0 for a dense model
        n_w = (3 if cfg.activation == "swiglu" else 2) if cfg.n_experts else 0
        # the attention's kernels, and none of the other attention's
        attn, other = (("block_sparse", "flash")
                       if attention.startswith("sparse")
                       else ("flash", "block_sparse"))
        want = {f"{attn}_fwd": 2 * L * micros,   # remat: forward runs twice
                f"{attn}_bwd_dq": L * micros, f"{attn}_bwd_dkv": L * micros,
                f"{other}_fwd": 0, f"{other}_bwd_dq": 0,
                f"{other}_bwd_dkv": 0, "evoformer_fwd": 0,
                "fused_adam": steps,
                norm: (4 * L + 1) * micros,      # 2 per layer, twice, + final
                "gmm": 3 * n_w * L * micros, "tgmm": n_w * L * micros,
                "paged_attention": 0}
        problems = [f"{k} launched {counts[k]} times, want {v}"
                    for k, v in want.items() if counts[k] != v]
        if bwd_calls[norm] != (2 * L + 1) * micros:
            problems.append(f"{norm} backward ran {bwd_calls[norm]} times, "
                            f"want {(2 * L + 1) * micros}")
        if not all(np.isfinite([first] + losses)):
            problems.append(f"non-finite loss {[first] + losses}")
        elif not losses[-1] < first:
            problems.append(f"loss did not fall: {[first] + losses}")
        off = [n for n in ("flat_master", "flat_compute", "flat_grad",
                           "flat_grad_acc")
               if getattr(engine, n).device != self.dev]
        if off:
            problems.append(f"engine buffers off the card: {off}")
        if problems:
            raise AssertionError(f"train {model}: " + "; ".join(problems))
        for k in want:
            if want[k]:
                self.launches.setdefault(k, {})[f"train_{model}"] = counts[k]
        self.steps[f"train_{model}"] = steps
        step_s = float(np.median(walls))
        tokens = micro * seq * gas
        flops = flops_per_token(cfg, seq) * tokens
        peak = torch.cuda.max_memory_allocated(self.dev) - base
        result = {"model": t.get("model", model), "attention": attention,
                  "micro": micro, "seq": seq, "gas": gas, "steps": steps,
                  "params": cfg.num_params(),
                  "active_params": active_params(cfg), "init_seconds": init_s,
                  "warmup_step_seconds": warm_s, "losses": [first] + losses,
                  "step_walls_s": walls, "step_ms": step_s * 1e3,
                  "tokens_per_s": tokens / step_s,
                  "model_tflops_per_s": flops / step_s / 1e12,
                  "mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
                  # bench.py's count: dense causal attention, whatever the
                  # attention computes
                  "mfu_flops": "dense model (bench.py _flops_per_token)",
                  "launches": counts, "launches_want": want,
                  "norm_backward_calls": bwd_calls[norm],
                  "peak_memory_bytes": peak,
                  "memory_held_by_earlier_phases_bytes": base,
                  "card": self.card}
        if cfg.n_experts:
            # the warm-up step's layer-0 routing: the grouped GEMMs' group
            # sizes on the main path (the times phase runs them at these)
            result["group_sizes_layer0"] = torch.bincount(
                routes[0][0].reshape(-1), minlength=cfg.n_experts).tolist()
        result["launches_per_step"] = {k: v / steps for k, v in want.items()
                                       if v}
        emit(f"train_{model}", **result)
        self.state[f"train_{model}"] = dict(result, engine=engine,
                                            data=data, batch=batch)
        self.train_gate(model, engine, batch)
        # the profiled step now, and the engine freed: the later phases'
        # engines would not fit beside every earlier one
        st = self.state[f"train_{model}"]
        st["profile"] = self.train_profile(model)
        st.update(flat_n=engine.flat_master.numel(), config=cfg)
        for k in ("engine", "data", "batch"):
            del st[k]
        del engine, data
        torch.cuda.empty_cache()

    def train_gate(self, model, main, batch, zero=None, layers=None,
                   label=None):
        """One optimizer step, four ways ({fp32, bf16} x {kernels, plain}),
        from the main path's fp32 master on the first ``gate_micro`` rows of
        its batch; each against the fp32 plain step. Every way runs the
        config's Adam (the kernel, held against its plain version in the
        kernels phase), so the paths differ only in the model's kernels;
        each way's update is also held against step 1 of Adam computed here
        from its own gradient. ``zero`` replaces the config's
        ``zero_optimization``; with ``layers`` the model is cut to that
        depth at full width and every way starts from the seed's master
        (``main`` None)."""
        torch = self.torch
        import deepspeed_tpu_torch as dtt
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.models.convert import load_master

        t = TRAIN[model]
        tokens = batch["tokens"][:t["gate_micro"]]
        attention = t.get("attention", "flash")
        mcfg = T.get_model_config(t.get("model", model),
                                  **({} if layers is None
                                     else {"num_layers": layers}))
        moe = mcfg.n_experts > 0
        L = mcfg.num_layers
        ref = None
        res = {}
        for prec, path in (("fp32", "plain"), ("fp32", "kernels"),
                           ("bf16", "plain"), ("bf16", "kernels")):
            spec = dtt.causal_lm_spec(
                t.get("model", model), attention=attention, remat="full",
                use_kernels=path == "kernels",
                dtype="float32" if prec == "fp32" else "bfloat16",
                **({} if layers is None else {"num_layers": layers}))
            config = self.train_config(t["gate_micro"], 1, prec)
            if zero is not None:
                config["zero_optimization"] = dict(zero)
            engine, *_ = dtt.initialize(model=spec, config=config,
                                        device=self.dev)
            if main is not None:
                load_master(engine, main.state["master"])
            before = engine.flat_master.clone()
            # routes: the forward's L layers, then the recompute's
            with recorded_routes() as routes:
                loss = float(engine.train_batch(iter([{"tokens": tokens}])))
            norm = engine.get_global_grad_norm()
            grad = engine.flat_grad_acc.float()     # unscaled, gas 1
            update = engine.flat_master - before
            del before
            hot = None
            if "cold_acc" in engine.state["opt"]:
                # ZenFlow's step 1 (no warm-up, no boundary) left the hot
                # coordinates' gradient in the accumulator and the cold
                # ones' in cold_acc: their sum is the whole gradient, bit
                # for bit; the update is step 1 of Adam from the applied
                # (hot) gradient
                applied = grad
                hot = applied != 0
                grad = applied + engine.state["opt"]["cold_acc"]
            else:
                applied = grad
            # step 1 of Adam, no weight decay: m̂ = g, v̂ = g²
            adam = -TRAIN_LR * applied / (applied.abs() + 1e-8)
            del applied
            row = {"loss": loss, "grad_norm": norm,
                   "adam_rel": float((update - adam).norm() / adam.norm())}
            del adam
            if moe:
                idx = torch.stack([r[0] for r in routes[:L]])
                aux = float(sum(r[1] for r in routes[:L]))
                row["aux_loss"] = aux
            if hot is not None:
                row["hot_share"] = float(hot.float().mean())
            if ref is None:
                ref = {"loss": loss, "norm": norm, "grad": grad.clone(),
                       "update": update.clone(), "hot": hot}
                if moe:
                    ref.update(idx=idx, aux=aux)
                    row["routed_pairs"] = idx.numel()
            else:
                if moe:
                    row.update(
                        route_agree=float((idx == ref["idx"]).float().mean()),
                        aux_rel=abs(aux - ref["aux"]) / abs(ref["aux"]))
                    row["route_miss"] = 1.0 - row["route_agree"]
                ru = ref["update"]
                if hot is not None:
                    # a coordinate whose |g| lies at its leaf's threshold
                    # may be hot on one path and cold on the other (the
                    # gradients differ in their last digits): counted as
                    # hot_miss, and the update held where both agree
                    agree = hot == ref["hot"]
                    row["hot_miss"] = 1.0 - float(agree.float().mean())
                    update, ru = update * agree, ru * agree
                row.update(
                    loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                    norm_rel=abs(norm - ref["norm"]) / ref["norm"],
                    grad_rel=float((grad - ref["grad"]).norm()
                                   / ref["grad"].norm()),
                    update_rel=float((update - ru).norm() / ru.norm()),
                    sign_miss=float((torch.sign(update) != torch.sign(ru))
                                    .float().mean()))
                del ru
            res[(prec, path)] = row
            del engine, grad, update
            torch.cuda.empty_cache()
        del ref
        torch.cuda.empty_cache()
        k32, kb, pb = (res[("fp32", "kernels")], res[("bf16", "kernels")],
                       res[("bf16", "plain")])
        limits = {"loss_rel": TRAIN_LOSS_REL, "norm_rel": TRAIN_NORM_REL,
                  "grad_rel": TRAIN_GRAD_REL, "update_rel": TRAIN_UPDATE_REL,
                  "sign_miss": TRAIN_SIGN_MISS}
        if moe:
            limits.update(route_miss=1 - ROUTE_AGREE_MIN,
                          aux_rel=TRAIN_LOSS_REL)
        if "hot_miss" in k32:
            limits.update(hot_miss=ZENFLOW_HOT_MISS)
        problems = [f"fp32 {m} {k32[m]:.3g} > {lim}"
                    for m, lim in limits.items() if not k32[m] <= lim]
        floor = {m: limits[m] if m in BF16_FLOORED else 0.0 for m in limits}
        problems += [f"bf16 {m}: kernels {kb[m]:.3g}, plain {pb[m]:.3g}"
                     for m in limits
                     if not kb[m] <= BF16_VS_PLAIN * max(pb[m], floor[m])]
        problems += [f"{prec} {path}: Adam update off step 1 by "
                     f"{r['adam_rel']:.3g} (relative L2)"
                     for (prec, path), r in res.items()
                     if not r["adam_rel"] <= TRAIN_ADAM_REL]
        emit(label or f"train_{model}/step_gate", micro=t["gate_micro"],
             layers=L, zero=zero,
             seq=t["seq"], fp32_plain=res[("fp32", "plain")],
             fp32_kernels=k32, bf16_plain=pb, bf16_kernels=kb,
             bounds=dict(limits, bf16_vs_plain=BF16_VS_PLAIN,
                         bf16_floored=BF16_FLOORED, adam_rel=TRAIN_ADAM_REL),
             card=self.card)
        if problems:
            raise AssertionError(f"{label or 'train ' + model}: step kernel "
                                 "vs plain: " + "; ".join(problems))

    def phase_train_gpt2_125m(self):
        self.train("gpt2_125m")

    def phase_train_llama_750m(self):
        self.train("llama_750m")

    def phase_train_moe_350m(self):
        self.train("moe_350m")

    def phase_train_llama_750m_sparse(self):
        self.train("llama_750m_sparse")

    # ------------------------------------------------------------------ #
    # Evoformer
    # ------------------------------------------------------------------ #
    def evo_main_inputs(self):
        """fp32 msa [R, S, C], pair bias [N, S, S], the projections wq, wk,
        wv, w_gate [C, N*D] and wo [N*D, C] (scaled by 1/sqrt(fan-in)) and a
        cotangent of the output, from the seed."""
        torch = self.torch
        m = EVO_MAIN
        R, S, C = m["rows"], m["seq"], m["c_m"]
        H = m["heads"] * m["head_dim"]
        g = torch.Generator(self.dev).manual_seed(self.seed + 17)

        def rand(*shape, scale=1.0):
            return scale * torch.randn(*shape, generator=g, device=self.dev)

        return [rand(R, S, C), rand(m["heads"], S, S),
                *(rand(C, H, scale=C ** -0.5) for _ in range(3)),
                rand(H, C, scale=H ** -0.5), rand(C, H, scale=C ** -0.5),
                rand(R, S, C)]

    def evo_step(self, inputs, use_flash):
        """msa_row_attention_with_pair_bias forward, then backward of the
        output against the fixed cotangent: (output, [grads of msa, pair
        bias, wq, wk, wv, wo, w_gate])."""
        from deepspeed_tpu_torch.ops import evoformer_attn as EA

        *xs, cot = inputs
        leaves = [t.detach().clone().requires_grad_() for t in xs]
        msa, pair, wq, wk, wv, wo, wg = leaves
        out = EA.msa_row_attention_with_pair_bias(
            msa, pair, wq, wk, wv, wo, w_gate=wg,
            num_heads=EVO_MAIN["heads"], use_flash=use_flash)
        out.backward(cot)
        return out.detach(), [t.grad for t in leaves]

    def phase_evoformer(self):
        """The DS4Sci entry point's main path: msa_row_attention_with_pair_
        bias at OpenFold's Evoformer widths, forward and backward, fp32 and
        bf16, through the kernel (use_flash auto on CUDA tensors); then the
        plain path (use_flash=False) on the same inputs. fp32: the output
        within TOL of the plain path, every gradient (input, weights, pair
        bias) within TRAIN_GRAD_REL (relative L2); bf16: output and each
        gradient no further from the fp32 plain path than BF16_VS_PLAIN
        times the plain bf16 path."""
        torch = self.torch
        x32 = self.evo_main_inputs()
        xbf = [t.bfloat16() for t in x32]

        # ---- the main path: counts to 0 just before, read just after ---- #
        self.reset_counts()
        t0 = time.perf_counter()
        k32 = self.evo_step(x32, None)
        kbf = self.evo_step(xbf, None)
        self.sync()
        wall = time.perf_counter() - t0
        counts = self.read_counts()
        # ----------------------------------------------------------------- #
        want = {"evoformer_fwd": 2, "flash_fwd": 0, "block_sparse_fwd": 0}
        problems = [f"{k} launched {counts[k]} times, want {v}"
                    for k, v in want.items() if counts[k] != v]
        p32 = self.evo_step(x32, False)
        pbf = self.evo_step(xbf, False)
        self.sync()
        if self.read_counts()["evoformer_fwd"] != counts["evoformer_fwd"]:
            problems.append("the plain path launched the kernel")

        def rel(a, b):
            return float((a.float() - b.float()).norm() / b.float().norm())

        names = ("out", "msa", "pair_bias", "wq", "wk", "wv", "wo", "w_gate")
        res = {}
        for way, (out, grads) in (("fp32_kernels", k32), ("bf16_kernels", kbf),
                                  ("bf16_plain", pbf)):
            res[way] = {n: rel(a, b) for n, a, b in
                        zip(names, [out, *grads], [p32[0], *p32[1]])}
        finite = all(bool(torch.isfinite(t).all()) for way in (k32, kbf)
                     for t in [way[0], *way[1]])
        if not finite:
            problems.append("non-finite output or gradient")
        try:
            out_err = self.close_tol("evoformer[msa_row,fp32]", k32[0],
                                     p32[0], TOL["float32"])
        except AssertionError as e:
            problems.append(str(e))
            out_err = None
        problems += [f"fp32 {n} grad rel {res['fp32_kernels'][n]:.3g} > "
                     f"{TRAIN_GRAD_REL}" for n in names[1:]
                     if not res["fp32_kernels"][n] <= TRAIN_GRAD_REL]
        problems += [f"bf16 {n}: kernels {res['bf16_kernels'][n]:.3g}, plain "
                     f"{res['bf16_plain'][n]:.3g}" for n in names
                     if not res["bf16_kernels"][n]
                     <= BF16_VS_PLAIN * res["bf16_plain"][n]]
        m = EVO_MAIN
        emit("evoformer", card=self.card, msa=[m["rows"], m["seq"], m["c_m"]],
             heads=m["heads"], head_dim=m["head_dim"],
             pair_bias=[m["heads"], m["seq"], m["seq"]], gated=True,
             launches=counts, launches_want=want, main_path_seconds=wall,
             fp32_out_max_abs_err=out_err, rel_l2_vs_fp32_plain=res,
             bounds={"out_tol": TOL["float32"], "grad_rel": TRAIN_GRAD_REL,
                     "bf16_vs_plain": BF16_VS_PLAIN})
        if problems:
            raise AssertionError("evoformer: " + "; ".join(problems))
        self.launches.setdefault("evoformer_fwd", {})["evoformer"] = \
            counts["evoformer_fwd"]
        self.state["evoformer"] = {"inputs": xbf}
        del x32, k32, kbf, p32, pbf
        torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    # data parallel on the one card
    # ------------------------------------------------------------------ #
    def phase_train_llama_750m_zeropp_dp2(self):
        """Two ranks on the card: the ZeRO++ main path and its gates, then
        the exact ZeRO-2 baseline (``train_llama_750m_zeropp_dp2_rank``).
        The libraries are built before spawning, so the ranks load them
        from the build cache."""
        torch = self.torch
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build

        build.build_all()
        torch.cuda.empty_cache()
        t = ZEROPP
        world, gas, steps = t["world"], t["gas"], t["steps"]
        cfg = T.get_model_config(t["model"])
        t0 = time.perf_counter()
        ranks = spawn_ranks("train_llama_750m_zeropp_dp2_rank", world,
                            self.seed, dict(t, device=str(self.dev)))
        wall = time.perf_counter() - t0
        L = cfg.num_layers
        micros = gas * steps
        groups = 1 + len(ZEROPP_CHUNKS)
        want = {"quant_int8": (gas + groups) * steps,
                "dequant_reduce": (2 * gas + groups) * steps,
                "flash_fwd": 2 * L * micros, "flash_bwd_dq": L * micros,
                "flash_bwd_dkv": L * micros,
                "fused_adam": ranks[0]["main"]["adam_per_step"] * steps,
                "rms_norm": (4 * L + 1) * micros, "block_sparse_fwd": 0,
                "gmm": 0, "tgmm": 0, "evoformer_fwd": 0,
                "paged_attention": 0}
        problems = []
        for r in ranks:
            m, wg = r["main"], r["wire_gate"]
            tag = f"rank {r['rank']}"
            if m["plan_chunks"] != ZEROPP_CHUNKS:
                problems.append(f"{tag}: plan chunks {m['plan_chunks']}, "
                                f"want {ZEROPP_CHUNKS}")
            problems += [f"{tag}: {k} launched {m['launches'][k]} times, "
                         f"want {v}" for k, v in want.items()
                         if m["launches"][k] != v]
            for run in ("main", "baseline"):
                ls = r[run]["losses"]
                if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
                    problems.append(f"{tag}: {run} loss did not fall: {ls}")
            if r["main"]["losses"] != ranks[0]["main"]["losses"]:
                problems.append(f"{tag}: the ranks' losses differ")
            b = r["baseline"]
            if not b["hooked"] or b["reduce_counts"] \
                    != b["reduce_counts_want"]:
                problems.append(f"{tag}: exact ZeRO-2 reduces "
                                f"{b['reduce_counts']}, want "
                                f"{b['reduce_counts_want']}")
            if not b["plan"]["step_overlap"]:
                problems.append(f"{tag}: exact ZeRO-2 without step overlap")
            if r["once"]["hooked"] or r["once"]["reduce_counts"] \
                    != r["once"]["reduce_counts_want"]:
                problems.append(f"{tag}: the unhooked run's reduces "
                                f"{r['once']['reduce_counts']}, want "
                                f"{r['once']['reduce_counts_want']}")
            for k in ("q_bitwise_equal", "scales_bitwise_equal",
                      "reduced_bitwise_equal"):
                if not wg[k]:
                    problems.append(f"{tag}: wire gate {k} false")
            if wg["quant_err_out_of_bound"]:
                problems.append(f"{tag}: {wg['quant_err_out_of_bound']} "
                                "elements past the int8 error bound")
            problems += [f"{tag}: {p}" for p in r["gate_problems"]]
        tokens = t["micro"] * t["seq"] * gas * world
        flops = flops_per_token(cfg, t["seq"]) * tokens

        def rates(run):
            step_s = run["step_ms"] / 1e3
            return {"step_ms": run["step_ms"], "tokens_per_s": tokens / step_s,
                    "model_tflops_per_s": flops / step_s / 1e12,
                    "mfu": flops / step_s / PEAK_FLOPS["bfloat16"]}

        r0 = ranks[0]
        result = {"model": t["model"], "world": world, "micro": t["micro"],
                  "seq": t["seq"], "gas": gas, "steps": steps,
                  "zero": ZEROPP_WIRE, "params": cfg.num_params(),
                  "phase_wall_s": wall, "card": self.card,
                  "wire_note": "gloo through host memory, two ranks "
                               "sharing one card",
                  "launches_want_per_rank": want,
                  "launches_per_step": {k: v / steps for k, v in want.items()
                                        if v},
                  "zeropp": dict(rates(r0["main"]), per_rank=[
                      r["main"] for r in ranks]),
                  "exact_zero2_baseline": dict(rates(r0["baseline"]),
                                               per_rank=[r["baseline"]
                                                         for r in ranks]),
                  "exact_zero2_once_a_step": dict(rates(r0["once"]),
                                                  per_rank=[r["once"]
                                                            for r in ranks]),
                  "profile_rank0": r0["profile"],
                  "baseline_profile_rank0": r0["baseline_profile"]}
        emit("train_llama_750m_zeropp_dp2", **result)
        emit("train_llama_750m_zeropp_dp2/gates", card=self.card,
             wire_gate=[r["wire_gate"] for r in ranks],
             step_gate=r0["gates"],
             overlap_gate=[r["overlap_gate"] for r in ranks],
             bounds={"loss_rel": TRAIN_LOSS_REL,
                     "grad_rel": TRAIN_GRAD_REL,
                     "update_rel": TRAIN_UPDATE_REL,
                     "wire_noise_share": WIRE_NOISE_SHARE,
                     "bf16_vs_plain": BF16_VS_PLAIN,
                     "quant_err": "sum_w scale_w / 2 / W + 1e-6 |exact|"})
        if problems:
            raise AssertionError("train_llama_750m_zeropp_dp2: "
                                 + "; ".join(problems))
        name = "train_llama_750m_zeropp_dp2"
        for k, v in want.items():
            if v:
                self.launches.setdefault(k, {})[name] = \
                    r0["main"]["launches"][k]
        self.steps[name] = steps
        self.state["zeropp"] = {"n_sh": r0["main"]["n_sharded"],
                                "profile": dict(rates(r0["main"]),
                                                **r0["profile"]),
                                "baseline": dict(rates(r0["baseline"]),
                                                 **r0["baseline_profile"])}

    def phase_train_llama_750m_zero3_dp2(self):
        """Two ranks on the card: exact ZeRO-3 and ZeRO-3 + qgZ + qwZ +
        LoCo at the full width of zero3_llama_750m_bf16, ZERO3_LAYERS
        layers, gates Z1-Z5 (``train_llama_750m_zero3_dp2_rank``); exact
        ZeRO-2 at the same depth as the baseline."""
        torch = self.torch
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build
        from deepspeed_tpu_torch.parallel.overlap import even_chunk_bounds

        build.build_all()
        torch.cuda.empty_cache()
        t = dict(ZERO3, layers=ZERO3_LAYERS, baseline=True)
        world, gas, steps = t["world"], t["gas"], t["steps"]
        cfg = T.get_model_config(t["model"], num_layers=t["layers"])
        L = cfg.num_layers
        # the MLP's reference: the same spec at world 1 without ZeRO
        mlp = dict(ZERO3_MLP, **t.get("mlp", {}))
        tmp = tempfile.mkdtemp(prefix="chip_smoke_mlp_")
        ref_path = os.path.join(tmp, "ref.pt")
        mlp_ref = mlp_run(self.dev, {"stage": 0}, mlp["micro"] * world,
                          self.seed, mlp, path=ref_path)
        del mlp_ref["m0"], mlp_ref["m1"]
        t0 = time.perf_counter()
        try:
            ranks = spawn_ranks("train_llama_750m_zero3_dp2_rank", world,
                                self.seed, dict(t, device=str(self.dev),
                                                mlp=mlp, mlp_ref=ref_path))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        wall = time.perf_counter() - t0
        baselines = [r["baseline"] for r in ranks]
        bounds = [list(b) for b in even_chunk_bounds(L, ZERO3_CHUNKS)]
        want = {run: zero3_launches_want(
            L, gas, steps, ZERO3_CHUNKS, wire=run == "wire",
            adam_per_step=ranks[0][run]["adam_per_step"])
            for run in ("exact", "wire")}
        problems = []
        for r, base in zip(ranks, baselines):
            tag = f"rank {r['rank']}"
            for run in ("exact", "wire"):
                m = r[run]
                problems += [f"{tag} {run}: {k} launched {m['launches'][k]}"
                             f" times, want {v}" for k, v in want[run].items()
                             if m["launches"][k] != v]
                problems += [f"{tag} {run}: {p}" for p in zero3_count_problems(
                    m["zero3_counts"], gas, ZERO3_CHUNKS, run == "wire")]
                if m["chunk_bounds"] != bounds:
                    problems.append(f"{tag} {run}: chunks {m['chunk_bounds']}"
                                    f", want {bounds}")
                ls = m["losses"]
                if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
                    problems.append(f"{tag}: {run} loss did not fall: {ls}")
                if ls != ranks[0][run]["losses"]:
                    problems.append(f"{tag}: the ranks' {run} losses differ")
            wg = r["wire_gate"]
            for k in ("q_bitwise_equal", "scales_bitwise_equal",
                      "reduced_bitwise_equal"):
                if not wg[k]:
                    problems.append(f"{tag}: Z3 wire gate {k} false")
            if wg["quant_err_out_of_bound"]:
                problems.append(f"{tag}: Z3 {wg['quant_err_out_of_bound']} "
                                "qgZ elements past the int8 error bound")
            problems += [f"{tag}: Z3 qwZ group {g['group']}: "
                         f"{g['out_of_bound']} elements past half a step"
                         for g in r["qwz_gate"] if g["out_of_bound"]]
            problems += [f"{tag}: {p}" for p in zero3_gate_problems(
                r["gates"])]
            problems += [f"{tag}: {p}" for p in zero3_memory_problems(
                r["exact"]["peak_memory_bytes"], base["peak_memory_bytes"],
                L)]
            problems += [f"{tag}: {p}" for p in r["mlp_problems"]]
            if r["mlp"]["type"] != "Zero3Engine" or mlp_ref["type"] \
                    != "DeepSpeedTPUEngine":
                problems.append(f"{tag}: MLP engines {r['mlp']['type']}, "
                                f"{mlp_ref['type']}")
            if r["mlp"]["counts"] != [{"gather_fwd": mlp["gas"],
                                       "gather_bwd": 0,
                                       "reduce": mlp["gas"]}] * mlp["steps"]:
                problems.append(f"{tag}: MLP gathers and reduces "
                                f"{r['mlp']['counts']}")
        tokens = t["micro"] * t["seq"] * gas * world
        flops = flops_per_token(cfg, t["seq"]) * tokens

        def rates(run):
            step_s = run["step_ms"] / 1e3
            return {"step_ms": run["step_ms"], "tokens_per_s": tokens / step_s,
                    "model_tflops_per_s": flops / step_s / 1e12,
                    "mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
                    "peak_memory_bytes_per_rank": [
                        x["peak_memory_bytes"] for x in run["per_rank"]]}

        r0 = ranks[0]
        runs = {"a_exact_zero3": [r["exact"] for r in ranks],
                "b_zero3_qgz_qwz_loco": [r["wire"] for r in ranks],
                "c_exact_zero2": baselines}
        result = {"model": t["model"], "world": world, "micro": t["micro"],
                  "seq": t["seq"], "gas": gas, "steps": steps,
                  "layers": L, "reduced": f"{L} of "
                  f"{T.get_model_config(t['model']).num_layers} layers, to "
                  "keep the whole script within its time",
                  "zero_a": ZERO3_EXACT, "zero_b": ZERO3_WIRE,
                  "chunks": bounds, "params": cfg.num_params(),
                  "phase_wall_s": wall, "card": self.card,
                  "baseline_from": f"this phase, at {L} layers",
                  "wire_note": "gloo through host memory, two ranks "
                               "sharing one card",
                  "launches_want_per_rank": want,
                  **{k: rates({"step_ms": v[0]["step_ms"], "per_rank": v})
                     for k, v in runs.items()},
                  "per_rank": runs,
                  "exposed_wire_rank0": r0["exposed"],
                  "any_spec_mlp": dict(config=mlp, world1_losses=mlp_ref[
                      "losses"], world1_seconds=mlp_ref["seconds"],
                      per_rank=[r["mlp"] for r in ranks]),
                  "profile_rank0": r0["exact_profile"],
                  "wire_profile_rank0": r0["wire_profile"]}
        emit("train_llama_750m_zero3_dp2", **result)
        emit("train_llama_750m_zero3_dp2/gates", card=self.card,
             gate_depth=f"Z1-Z2 at {t['gate_layers']} layers, full width",
             step_gates=[r["gates"] for r in ranks],
             wire_gate=[r["wire_gate"] for r in ranks],
             qwz_gate=r0["qwz_gate"],
             memory_saved_gb=[(b["peak_memory_bytes"]
                               - r["exact"]["peak_memory_bytes"]) / 1e9
                              for r, b in zip(ranks, baselines)],
             bounds={"loss_rel": TRAIN_LOSS_REL, "grad_rel": TRAIN_GRAD_REL,
                     "update_rel": TRAIN_UPDATE_REL,
                     "sign_miss": TRAIN_SIGN_MISS,
                     "bf16_vs_zero2": BF16_VS_PLAIN,
                     "memory_saved_gb": ZERO3_MEMORY_SAVED * L / 20 / 1e9})
        if problems:
            raise AssertionError("train_llama_750m_zero3_dp2: "
                                 + "; ".join(problems))
        name = "train_llama_750m_zero3_dp2"
        for run in ("exact", "wire"):
            for k, v in want[run].items():
                if v:
                    self.launches.setdefault(k, {})[f"{name}/{run}"] = \
                        r0[run]["launches"][k]
            self.steps[f"{name}/{run}"] = steps
        self.state["zero3"] = {
            "exact": dict(rates({"step_ms": r0["exact"]["step_ms"],
                                 "per_rank": runs["a_exact_zero3"]}),
                          **r0["exact_profile"]),
            "wire": dict(rates({"step_ms": r0["wire"]["step_ms"],
                                "per_rank": runs["b_zero3_qgz_qwz_loco"]}),
                         **r0["wire_profile"])}

    def phase_train_llama_750m_hpz_dp4(self):
        """Four ranks on the card, mesh data 2 x zshard 2: the ZeRO++ trio
        and MiCS at stage 3 at the full width of zero3_llama_750m_bf16 and
        HPZ_LAYERS of its layers, gates H1-H5
        (``train_llama_750m_hpz_dp4_rank``)."""
        torch = self.torch
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build
        from deepspeed_tpu_torch.parallel.overlap import even_chunk_bounds

        build.build_all()
        torch.cuda.empty_cache()
        t = dict(HPZ, layers=HPZ_LAYERS)
        world, gas, steps = t["world"], t["gas"], t["steps"]
        cfg = T.get_model_config(t["model"], num_layers=t["layers"])
        L = cfg.num_layers
        t0 = time.perf_counter()
        ranks = spawn_ranks("train_llama_750m_hpz_dp4_rank", world,
                            self.seed, dict(t, device=str(self.dev)))
        wall = time.perf_counter() - t0
        bounds = [list(b) for b in even_chunk_bounds(L, ZERO3_CHUNKS)]
        want = {"trio": zero3_launches_want(
                    L, gas, steps, ZERO3_CHUNKS, wire=True, loco=False,
                    replica=True,
                    adam_per_step=ranks[0]["trio"]["adam_per_step"]),
                "mics": zero3_launches_want(
                    L, gas, steps, ZERO3_CHUNKS, wire=False,
                    adam_per_step=ranks[0]["mics"]["adam_per_step"])}
        problems, traffic_want = [], {}
        for r in ranks:
            tag = f"rank {r['rank']}"
            for run in ("trio", "mics"):
                m = r[run]
                if (m["coords"], m["shard_world"], m["shard_rank"]) != (
                        {"data": r["rank"] // HPZ_Z,
                         "zshard": r["rank"] % HPZ_Z}, HPZ_Z,
                        r["rank"] % HPZ_Z):
                    problems.append(f"{tag} {run}: mesh {m['coords']}")
                problems += [f"{tag} {run}: {k} launched {m['launches'][k]}"
                             f" times, want {v}" for k, v in want[run].items()
                             if m["launches"][k] != v]
                problems += [f"{tag} {run}: {p}" for p in zero3_count_problems(
                    m["zero3_counts"], gas, ZERO3_CHUNKS, run == "trio")]
                if m["chunk_bounds"] != bounds:
                    problems.append(f"{tag} {run}: chunks {m['chunk_bounds']}"
                                    f", want {bounds}")
                tw = hpz_traffic_want(m["n_rows"], m["n_sharded"],
                                      m["n_replicated"], gas, steps,
                                      wire=run == "trio")
                traffic_want[run] = tw
                problems += [f"{tag} {run}: H4 {p}" for p in
                             hpz_traffic_problems(m["traffic"], tw)]
                ls = m["losses"]
                if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
                    problems.append(f"{tag}: {run} loss did not fall: {ls}")
                if ls != ranks[0][run]["losses"]:
                    problems.append(f"{tag}: the ranks' {run} losses differ")
            rg = r["replica_gate"]
            for k in ("q_bitwise_equal", "scales_bitwise_equal",
                      "reduced_bitwise_equal"):
                if not rg[k]:
                    problems.append(f"{tag}: H3 replica hop {k} false")
            if rg["two_hop_err_out_of_bound"]:
                problems.append(f"{tag}: H3 {rg['two_hop_err_out_of_bound']}"
                                " elements past half a step a hop")
            problems += [f"{tag}: {p}" for p in hpz_gate_problems(
                r["gates"])]
        card_bytes = ranks[0]["trio"]["card_bytes"]
        for run in ("trio", "mics"):
            total = sum(r[run]["peak_memory_bytes"] for r in ranks)
            if total > card_bytes:
                problems.append(f"{run}: the ranks' peaks {total} bytes "
                                f"past the card's {card_bytes}")
        tokens = t["micro"] * t["seq"] * gas * world
        flops = flops_per_token(cfg, t["seq"]) * tokens

        def rates(runs):
            step_s = runs[0]["step_ms"] / 1e3
            peaks = [x["peak_memory_bytes"] for x in runs]
            return {"step_ms": runs[0]["step_ms"],
                    "step_ms_per_rank": [x["step_ms"] for x in runs],
                    "tokens_per_s": tokens / step_s,
                    "model_tflops_per_s": flops / step_s / 1e12,
                    "mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
                    "peak_memory_bytes_per_rank": peaks,
                    "peak_memory_bytes_sum": sum(peaks),
                    "card_memory_bytes": card_bytes,
                    "wire_host_s_by_group_per_step": [
                        {g: v / steps for g, v in
                         hpz_wire_seconds(x["traffic"]).items()}
                        for x in runs]}

        runs = {"a_zero3_hpz_qwz_qgz": [r["trio"] for r in ranks],
                "b_mics_zero3": [r["mics"] for r in ranks]}
        r0 = ranks[0]
        result = {"model": t["model"], "world": world,
                  "mesh": {"data": world // HPZ_Z, "zshard": HPZ_Z},
                  "micro": t["micro"], "seq": t["seq"], "gas": gas,
                  "steps": steps, "zero_a": HPZ_TRIO, "zero_b": HPZ_MICS,
                  "layers": L, "reduced": f"{L} of "
                  f"{T.get_model_config(t['model']).num_layers} layers, to "
                  "keep the whole script within its time",
                  "chunks": bounds, "params": cfg.num_params(),
                  "phase_wall_s": wall, "card": self.card,
                  "wire_note": "gloo through host memory, four ranks "
                               "sharing one card: hpZ's gain, a gather "
                               "that stays on a node's fast links, cannot "
                               "show here",
                  "launches_want_per_rank": want,
                  "traffic_want_rank0": traffic_want,
                  **{k: rates(v) for k, v in runs.items()},
                  "per_rank": runs}
        emit("train_llama_750m_hpz_dp4", **result)
        emit("train_llama_750m_hpz_dp4/gates", card=self.card,
             gate_depth=f"H1-H2 at {t['gate_layers']} layers, full width",
             step_gates=[r["gates"] for r in ranks],
             replica_gate=[r["replica_gate"] for r in ranks],
             bounds={"loss_rel": TRAIN_LOSS_REL, "grad_rel": TRAIN_GRAD_REL,
                     "update_rel": TRAIN_UPDATE_REL,
                     "sign_miss": TRAIN_SIGN_MISS,
                     "bf16_vs_data4": BF16_VS_PLAIN,
                     "two_hop_err": "half a step a hop, / world"})
        if problems:
            raise AssertionError("train_llama_750m_hpz_dp4: "
                                 + "; ".join(problems))
        name = "train_llama_750m_hpz_dp4"
        for run in ("trio", "mics"):
            for k, v in want[run].items():
                if v:
                    self.launches.setdefault(k, {})[f"{name}/{run}"] = \
                        r0[run]["launches"][k]
            self.steps[f"{name}/{run}"] = steps
        self.state["hpz"] = {
            "n_sh": r0["trio"]["n_sharded"],
            "trio": rates(runs["a_zero3_hpz_qwz_qgz"]),
            "mics": rates(runs["b_mics_zero3"])}

    # ------------------------------------------------------------------ #
    # expert parallelism
    # ------------------------------------------------------------------ #
    def phase_train_moe_350m_ep(self):
        """moe_350m over the expert axis on the one card (MOE_EP, MOE_EP_B):
        the one-process references first (their whole fp32 gradient and
        update in files the ranks map), then (a) two ranks and (b) four;
        E1-E5, the launches, step ms, tokens/s, MFU by active parameters,
        peaks a rank, the expert group's host seconds a step and the idle
        share."""
        torch = self.torch
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build

        build.build_all()
        dev_free(self.dev)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ep_")
        try:
            refs = {"a": moe_ep_reference(MOE_EP, self.dev, self.seed,
                                          os.path.join(tmp, "a")),
                    "b": moe_ep_reference(MOE_EP_B, self.dev, self.seed,
                                          os.path.join(tmp, "b"),
                                          plain_bf16=False)}
            runs = {}
            for label, t in (("a", MOE_EP), ("b", MOE_EP_B)):
                t0 = time.perf_counter()
                ranks = spawn_ranks("train_moe_350m_ep_rank", t["world"],
                                    self.seed, dict(t, device=str(self.dev),
                                                    ref=refs[label]))
                runs[label] = (ranks, time.perf_counter() - t0)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        problems, results = [], {}
        for label, t in (("a", MOE_EP), ("b", MOE_EP_B)):
            ranks, wall = runs[label]
            cfg = T.get_model_config(t["model"], **(
                {"num_layers": t["layers"]} if t.get("layers") else {}))
            L, world = cfg.num_layers, t["world"]
            n_w = 3 if cfg.activation == "swiglu" else 2
            want = moe_ep_launches_want(
                L, t["gas"], t["steps"], n_w,
                ranks[0]["main"]["adam_per_step"])
            problems += moe_ep_problems(ranks, t, label)
            for r in ranks:
                m = r["main"]
                problems += [f"{label} rank {r['rank']}: {k} launched "
                             f"{m['launches'][k]} times, want {v}"
                             for k, v in want.items()
                             if m["launches"][k] != v]
                if m["local_experts"] != cfg.n_experts // t["mesh"]["expert"]:
                    problems.append(f"{label} rank {r['rank']}: "
                                    f"{m['local_experts']} local experts")
            card_bytes = ranks[0]["main"]["card_bytes"]
            peaks = [r["main"]["peak_memory_bytes"] for r in ranks]
            if sum(peaks) > card_bytes:
                problems.append(f"{label}: the ranks' peaks {sum(peaks)} past "
                                f"the card's {card_bytes}")
            tokens = t["micro"] * t["seq"] * t["gas"] * world
            flops = flops_per_token(cfg, t["seq"]) * tokens

            def rate(x):
                step_s = x["step_ms"] / 1e3
                return {"step_ms": x["step_ms"],
                        "tokens_per_s": tokens / step_s,
                        "mfu": flops / step_s / PEAK_FLOPS["bfloat16"]}

            prof = ranks[0]["profile"]
            results[label] = {
                "model": t["model"], "mesh": t["mesh"], "world": world,
                "layers": L, "micro": t["micro"], "seq": t["seq"],
                "gas": t["gas"], "steps": t["steps"], "zero": MOE_EP_ZERO,
                "reduced": (f"{L} of {T.get_model_config(t['model']).num_layers}"
                            " layers, for the script's time" if t.get(
                                "layers") else "none"),
                "params": cfg.num_params(),
                "active_params": active_params(cfg),
                "phase_wall_s": wall,
                "per_rank": [dict(rate(r["main"]), rank=r["rank"],
                                  coords=r["main"]["coords"],
                                  peak_memory_bytes=r["main"][
                                      "peak_memory_bytes"],
                                  losses=r["main"]["losses"],
                                  step_walls_s=r["main"]["step_walls_s"],
                                  expert_all_to_all_host_s_per_step=r[
                                      "main"]["traffic"].get(
                                      "expert/all_to_all", [0, 0, 0.0])[2]
                                  / t["steps"],
                                  wire_host_s_by_group_per_step={
                                      g: v / t["steps"] for g, v in
                                      hpz_wire_seconds(
                                          r["main"]["traffic"]).items()})
                             for r in ranks],
                **rate(ranks[0]["main"]),
                "peak_memory_bytes_sum": sum(peaks),
                "card_memory_bytes": card_bytes,
                "device_idle_share_rank0": prof.get("device_idle_share",
                                                    "not measured"),
                "profile_rank0": prof,
                "launches_want_per_rank": want,
                "launches_rank0": ranks[0]["main"]["launches"],
                "traffic_want_per_rank": ranks[0]["main"]["traffic_want"],
                "traffic_rank0": ranks[0]["main"]["traffic"],
                "e3_received_buffer": [r["e3"] for r in ranks],
                "gates": [r["gates"] for r in ranks],
                "card": self.card,
                "wire_note": "gloo through host memory, the ranks sharing "
                             "one card: the all-to-alls' time, not NVLink's"}
            emit(f"train_moe_350m_ep/{label}", **results[label])
            name = f"train_moe_350m_ep/{label}"
            for k, v in want.items():
                if v:
                    self.launches.setdefault(k, {})[name] = \
                        ranks[0]["main"]["launches"][k]
            self.steps[name] = t["steps"]
        emit("train_moe_350m_ep/bounds", limits=MOE_EP_LIMITS,
             bf16_vs_plain=BF16_VS_PLAIN, bf16_floored=BF16_FLOORED,
             gmm_tol=GMM_TOL, card=self.card)
        if problems:
            raise AssertionError("train_moe_350m_ep: " + "; ".join(problems))
        self.state["moe_ep"] = {
            k: {"step_ms": v["step_ms"], "tokens_per_s": v["tokens_per_s"],
                "mfu": v["mfu"], "idle": v["device_idle_share_rank0"],
                "e3": v["e3_received_buffer"][0]}
            for k, v in results.items()}
        torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    # offload
    # ------------------------------------------------------------------ #
    def phase_train_llama2_7b_super_offload(self, t=None):
        """llama2_7b at full width under SuperOffload on an empty card:
        the host facts, gates S1-S3 at ``gate_layers`` layers, then the
        main path (3 steps with overlap, 2 without), its host update,
        copies, memory and idle share."""
        torch = self.torch
        import itertools

        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build

        t = dict(SUPER, **(t or {}))
        if self.dev.type == "cuda":
            build.build_all()
        dev_free(self.dev)
        facts = host_facts(nvme_dir())
        full = T.get_model_config(t["model"])
        L = super_layers(t["model"], host_available(facts), t["max_layers"])
        copy_gbs = host_copy_gbs(t.get("copy_elems", 2 ** 28))
        emit("train_llama2_7b_super_offload/host", card=self.card,
             host_copy_gbs=copy_gbs, layers=L, **facts)
        if L < 1:
            raise RuntimeError(f"no layer of {t['model']} fits "
                               f"{facts['mem_available_bytes']} bytes")
        t0 = time.perf_counter()
        gates = super_gates(t, self.dev, self.seed)
        gates_s = time.perf_counter() - t0
        problems = [f"{p}" for p in super_gate_problems(gates)]
        emit("train_llama2_7b_super_offload/gates", card=self.card,
             seconds=gates_s, bounds={"master_rel": SUPER_MASTER_REL,
                                      "bf16_vs_device": BF16_VS_PLAIN},
             **gates)
        if problems:
            raise AssertionError("train_llama2_7b_super_offload: "
                                 + "; ".join(problems))

        # ---- the main path ------------------------------------------ #
        dev_peak(self.dev, reset=True)
        t0 = time.perf_counter()
        engine = offload_engine(t, self.dev, SUPER_ZERO, "bf16", layers=L)
        self.sync()
        init_s = time.perf_counter() - t0
        runner = engine._host_runner
        cfg = engine.model_spec.config
        n = engine._numel
        rng = np.random.default_rng(self.seed)
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (t["micro"], t["seq"]),
                                        dtype=np.int32)}
        data = itertools.repeat(batch)
        placed = {"master": engine.flat_master.device.type,
                  "moments": sorted({v.device.type for v in
                                     engine.state["opt"].values()
                                     if isinstance(v, torch.Tensor)}),
                  "compute": engine.flat_compute.device.type,
                  "grad_acc": engine.flat_grad_acc.device.type}
        t0 = time.perf_counter()
        first = float(engine.train_batch(data))
        warm_s = time.perf_counter() - t0
        runner.wait()           # the warm-up's host update, outside the count
        self.reset_counts()
        losses, walls, modes = [], [], []
        profiles = {"overlap": {}, "sync": {}}
        for overlap, steps in ((True, t["overlap_steps"]),
                               (False, t["sync_steps"])):
            if runner.overlap != overlap:
                runner.drain()              # the schedule changes here
                runner.overlap = overlap
            mode = "overlap" if overlap else "sync"
            for i in range(steps):
                # the second step of each schedule is profiled (the card's
                # activity only): its device time against the steps' wall
                with (self.device_profile(profiles[mode]) if i == 1
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    loss = engine.train_batch(data)
                    self.sync()
                    walls.append(time.perf_counter() - t0)
                losses.append(float(loss))
                modes.append(mode)
        counts = self.read_counts()
        upd = runner.stats()[-(t["overlap_steps"] + t["sync_steps"]):]
        peak = dev_peak(self.dev)
        mem = process_memory()
        pinned = sum(b.numel() * b.element_size()
                     for b in (runner.landing, runner.staging))
        acc_b = n * engine.flat_grad_acc.element_size()
        runner_threads = runner.threads
        t0 = time.perf_counter()
        s0 = host_adam_gate(engine, self.dev)
        s0["seconds"] = time.perf_counter() - t0
        problems += host_adam_gate_problems(s0)
        emit("train_llama2_7b_super_offload/s0", card=self.card,
             bounds={"p_ulps": S0_P_ULPS, "p_share": S0_P_SHARE}, **s0)
        engine.close()
        del engine, runner, data
        dev_free(self.dev)
        micros = t["gas"] * (t["overlap_steps"] + t["sync_steps"])
        want = {"flash_fwd": 2 * L * micros, "flash_bwd_dq": L * micros,
                "flash_bwd_dkv": L * micros, "rms_norm": (4 * L + 1) * micros,
                "fused_adam": 0}
        if self.dev.type == "cuda":
            problems += [f"{k} launched {counts[k]} times, want {v}"
                         for k, v in want.items() if counts[k] != v]
        # every step's update ran in the host library, one call each pass
        steps_run = t["overlap_steps"] + t["sync_steps"]
        for k in ("host_grad_prep", "host_adam"):
            if counts[k] != steps_run:
                problems.append(f"{k} called {counts[k]} times, want "
                                f"{steps_run}")
        if not all(np.isfinite([first] + losses)):
            problems.append(f"non-finite loss {[first] + losses}")
        elif not losses[-1] < first:
            problems.append(f"loss did not fall: {[first] + losses}")
        if placed != {"master": "cpu", "moments": ["cpu"],
                      "compute": self.dev.type, "grad_acc": self.dev.type}:
            problems.append(f"state placed {placed}")
        card_bytes = (torch.cuda.get_device_properties(self.dev).total_memory
                      if self.dev.type == "cuda" else 0)
        if card_bytes and not peak < card_bytes:
            problems.append(f"device peak {peak} >= the card's {card_bytes}")

        def median(key):
            vals = [u[key] for u in upd if u.get(key) is not None]
            return float(np.median(vals)) if vals else "not measured"

        step_s = {m: float(np.median([w for w, mm in zip(walls, modes)
                                      if mm == m])) for m in set(modes)}
        tokens = t["micro"] * t["seq"] * t["gas"]
        flops = flops_per_token(cfg, t["seq"]) * tokens
        host_s = median("host_update_s")
        d2h_ms, h2d_ms = median("d2h_ms"), median("h2d_ms")
        host_bytes = (HOST_ADAM_BYTES + HOST_PREP_BYTES) * n
        bound_s = host_bytes / (copy_gbs * 1e9)

        def gbs(nbytes, ms):
            return nbytes / (ms / 1e3) / 1e9 if isinstance(ms, float) \
                else "not measured"

        result = {
            "model": t["model"], "layers": L,
            "layers_full": full.num_layers,
            "reduced": (None if L == full.num_layers else
                        f"{L} of {full.num_layers} layers: host bytes "
                        f"{SUPER_HOST_BYTES} B a parameter x "
                        f"{SUPER_HOST_MARGIN} must fit the host's "
                        f"{host_available(facts)} B available (MemAvailable "
                        f"{facts['mem_available_bytes']} B, cgroup limit "
                        f"{facts['cgroup_limit_bytes']} B less its use)"),
            "params": cfg.num_params(), "flat_elements": n,
            "micro": t["micro"], "seq": t["seq"], "gas": t["gas"],
            "zero": SUPER_ZERO, "placed": placed, "init_seconds": init_s,
            "warmup_step_seconds": warm_s, "losses": [first] + losses,
            "modes": modes, "step_walls_s": walls,
            "step_s": step_s.get("overlap"), "step_s_sync": step_s.get("sync"),
            # the overlap steps after the first, whose update k-1 was done
            # before it began (the warm-up's, waited for the counts)
            "step_s_overlap_after_first": float(np.median(
                walls[1:t["overlap_steps"]])),
            "tokens_per_s": tokens / step_s["overlap"],
            "tokens_per_s_sync": tokens / step_s["sync"],
            "mfu": flops / step_s["overlap"] / PEAK_FLOPS["bfloat16"],
            "mfu_sync": flops / step_s["sync"] / PEAK_FLOPS["bfloat16"],
            "host_update_s": host_s,
            "host_update_route": "host library ops/csrc/cpu_adam.cpp",
            "host_prep_s": median("host_prep_s"),
            "host_adam_s": median("host_adam_s"),
            "host_threads": runner_threads,
            "host_update_gbs": (host_bytes / host_s / 1e9
                                if isinstance(host_s, float)
                                else "not measured"),
            "host_update_bytes_per_param": HOST_ADAM_BYTES + HOST_PREP_BYTES,
            "host_update_bound_s": bound_s, "host_copy_gbs": copy_gbs,
            "s0": s0,
            "d2h_s": d2h_ms / 1e3 if isinstance(d2h_ms, float) else d2h_ms,
            "d2h_gbs": gbs(acc_b, d2h_ms),
            "h2d_s": h2d_ms / 1e3 if isinstance(h2d_ms, float) else h2d_ms,
            "h2d_gbs": gbs(n * 2, h2d_ms), "updates": upd,
            "device_peak_bytes": peak, "card_bytes": card_bytes,
            "no_offload_state_bytes": 20 * cfg.num_params(),
            "pinned_host_bytes": pinned, **mem,
            "torch_threads": torch.get_num_threads(),
            "nproc": facts["nproc"], "launches": counts,
            "launches_want": want, "profile_steps": profiles,
            **{f"device_idle_share_{m}": (
                1 - profiles[m]["device_ms"] / (step_s[m] * 1e3)
                if isinstance(profiles[m].get("device_ms"), float)
                else "not measured") for m in profiles},
            "card": self.card}
        emit("train_llama2_7b_super_offload", **result)
        if problems:
            raise AssertionError("train_llama2_7b_super_offload: "
                                 + "; ".join(problems))
        name = "train_llama2_7b_super_offload"
        for k, v in want.items():
            if v:
                self.launches.setdefault(k, {})[name] = counts[k]
        self.steps[name] = t["overlap_steps"] + t["sync_steps"]
        self.state["super_offload"] = result
        # the host library's row of the kernels line: its Adam pass on
        # S0's slice against the plain version and PyTorch's fused AdamW
        # on the same inputs
        slice_bytes = HOST_ADAM_BYTES * s0["elements"]
        self.host_rows["host_adam"] = {
            "name": "host_adam", "route": "host",
            "source": "deepspeed_tpu_torch/ops/csrc/cpu_adam.cpp",
            "replaces": "deepspeed_tpu/runtime/host_step.py:160",
            "launches": counts["host_adam"],
            "max_abs_err": s0["vs_plain_p_max_abs"],
            "ms": s0["host_adam_s"] * 1e3,
            "plain_ms": s0["plain_s"] * 1e3,
            "bound_ms": slice_bytes / (copy_gbs * 1e9) * 1e3,
            "bound_by": "bytes",
            "library_ms": None if s0["library_s"] is None
            else s0["library_s"] * 1e3,
            "step_update_s": host_s, "step_update_bound_s": bound_s,
            "threads": runner_threads}

    @contextlib.contextmanager
    def device_profile(self, out):
        """torch.profiler over the block, the card's activity only (the
        host update's many CPU ops stay out of the trace): fills ``out``
        with the device ms by kind and in all ("not measured" on the
        CPU)."""
        if self.dev.type != "cuda":
            out["device_ms"] = "not measured"
            yield
            return
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield
        kinds = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = float(getattr(e, "self_device_time_total", 0)
                       or getattr(e, "self_cuda_time_total", 0))
            if getattr(e, "is_user_annotation", False) or not us:
                continue
            kind = "memcpy" if e.key.startswith("Memcpy") \
                else kernel_kind(e.key)
            kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
        device_ms = sum(kinds.values())
        out.update(device_ms=device_ms if device_ms else "not measured",
                   device_ms_by_kind=kinds or "not measured")

    def phase_train_llama_750m_offload(self, t=None):
        """llama_750m at its training shape: (a) offload_optimizer cpu,
        (b) nvme, (c) ZenFlow, each against the run without offload; (d)
        ZeRO-3 at world 1 with offload_param cpu and nvme."""
        torch = self.torch
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build

        t = dict(OFFLOAD, **(t or {}))
        if self.dev.type == "cuda":
            build.build_all()
        dev_free(self.dev)
        path = os.path.join(nvme_dir(), "750m")
        shutil.rmtree(path, ignore_errors=True)
        facts = host_facts(path)
        if facts["disk_free_bytes"] < NVME_MIN_FREE:
            raise RuntimeError(f"{path}: {facts['disk_free_bytes']} bytes "
                               f"free, the NVMe runs need {NVME_MIN_FREE}")
        cfg = T.get_model_config(t["model"])
        L = cfg.num_layers
        rng = np.random.default_rng(self.seed)
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (t["micro"], t["seq"]),
                                        dtype=np.int32)}
        runs, problems, ref = {}, [], None
        for run, zero, check in (
                ("none", {"stage": 1}, None),
                ("a_cpu", {"stage": 1, "offload_optimizer":
                           {"device": "cpu"}}, moments_on_host),
                ("b_nvme", {"stage": 1, "offload_optimizer":
                            {"device": "nvme", "nvme_path": path}},
                 nvme_swap_times),
                ("c_zenflow", {"stage": 1, "zenflow": ZENFLOW}, None)):
            engine, res = offload_run(
                t, self.dev, zero, batch, after_step=check,
                ref=ref if run in ("a_cpu", "b_nvme") else None)
            if run == "none":
                ref = res.pop("_master")
            res.pop("_master", None)
            if run == "a_cpu":
                res["swap"] = opt_swap_rate(engine, self.dev)
            runs[run] = res
            engine.close()
            del engine
            dev_free(self.dev)
        del ref
        base = runs["none"]
        for run in ("a_cpu", "b_nvme"):
            r = runs[run]
            if r["losses"] != base["losses"]:
                problems.append(f"({run}) losses {r['losses']} != "
                                f"{base['losses']}")
            if not r["master_bit_equal"]:
                problems.append(f"({run}) master differs from no offload")
        for c in runs["a_cpu"]["checks"]:
            if not (c["all_host"] and c["all_pinned"] in (True, None)):
                problems.append(f"(a) moments between steps: {c}")
        for c in runs["b_nvme"]["checks"]:
            if not c or not c["swapped"]:
                problems.append(f"(b) moments not in their files: {c}")
        zl = runs["c_zenflow"]["losses"]
        if not all(np.isfinite(zl)) or not zl[-1] < zl[0]:
            problems.append(f"(c) ZenFlow loss did not fall: {zl}")
        micros = t["gas"] * t["steps"]
        want = {"flash_fwd": 2 * L * micros, "flash_bwd_dq": L * micros,
                "flash_bwd_dkv": L * micros, "rms_norm": (4 * L + 1) * micros,
                "fused_adam": t["steps"]}
        if self.dev.type == "cuda":
            problems += [f"({run}) {k} launched {r['launches'][k]} times, "
                         f"want {v}" for run, r in runs.items()
                         for k, v in want.items() if r["launches"][k] != v]
        # (d): ZeRO-3 at world 1 on a spawned rank, streaming; the int8
        # wire at world 2, boundary swap
        t0 = time.perf_counter()
        (param,) = spawn_ranks("train_llama_750m_offload_param_rank", 1,
                               self.seed, dict(t, device=str(self.dev),
                                               nvme_path=path))
        param_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        int8 = spawn_ranks("train_llama_750m_offload_param_rank", 2,
                           self.seed, dict(t, device=str(self.dev),
                                           nvme_path=path, wire=OFFLOAD_INT8,
                                           runs=("none", "cpu")))
        int8_s = time.perf_counter() - t0
        shutil.rmtree(path, ignore_errors=True)
        cuda = self.dev.type == "cuda"
        for label, res, runs_where, stream in (
                ("(d)", param, (("cpu", "cpu"), ("nvme", "file")), True),
                *((f"(d) int8 rank {r}", x, (("cpu", "cpu"),), False)
                  for r, x in enumerate(int8))):
            for run, where in runs_where:
                r = res[run]
                if r["losses"] != res["none"]["losses"]:
                    problems.append(f"{label} {run}: losses {r['losses']} "
                                    f"!= {res['none']['losses']}")
                if not r["master_bit_equal"]:
                    problems.append(f"{label} {run}: master differs")
                bad = [c for c in r["checks"] if c["master"] != where
                       or c.get("pinned") is False]
                if bad:
                    problems.append(f"{label} {run}: master between steps "
                                    f"{bad}")
                if r["stream"] != stream:
                    problems.append(f"{label} {run}: streaming "
                                    f"{r['stream']}, want {stream}")
        for x in int8:
            if x["cpu"]["wire"] != "qz":
                problems.append(f"(d) int8: wire {x['cpu']['wire']}")
        d_mem = {}
        if cuda:
            none_peak = param["none"]["peak_memory_bytes"]
            for run in ("cpu", "nvme"):
                r = param[run]
                d_mem[run] = {
                    "fb_peak_gb": max(r["fb_peak_bytes"][1:]) / 1e9,
                    "step_peak_gb": max(r["step_peak_bytes"][1:]) / 1e9,
                    "no_offload_step_peak_gb": none_peak / 1e9,
                    "stream_pass_ms": r["stream_pass_ms"],
                    "stream_gbs_each_way": r["stream_gbs_each_way"],
                    "stream_chunks": r["stream_chunks"],
                    "staging_gb": r["stream_staging_bytes"] / 1e9}
                # the master (4 B a parameter) off the card for the
                # forward and backward, less the staging buffers
                if not max(r["fb_peak_bytes"][1:]) < none_peak:
                    problems.append(f"(d) {run}: forward-backward peak "
                                    f"{max(r['fb_peak_bytes'][1:])} not "
                                    f"below no offload's {none_peak}")
        tokens = t["micro"] * t["seq"] * t["gas"]
        result = {"model": t["model"], "micro": t["micro"], "seq": t["seq"],
                  "gas": t["gas"], "steps": t["steps"], "nvme_path": path,
                  "disk_free_bytes": facts["disk_free_bytes"],
                  "zenflow": ZENFLOW, "runs": runs,
                  "tokens_per_s": {k: tokens / (r["step_ms"] / 1e3)
                                   for k, r in runs.items()},
                  "peak_vs_no_offload_bytes": {
                      k: r["peak_memory_bytes"] - base["peak_memory_bytes"]
                      for k, r in runs.items()},
                  "d_param_layers": t["param_layers"], "d_world": 1,
                  "d_seconds": param_s, "d_runs": param,
                  "d_stream_memory": d_mem, "d_int8_world": 2,
                  "d_int8_seconds": int8_s, "d_int8_runs": int8,
                  "launches_want": want, "card": self.card}
        emit("train_llama_750m_offload", **result)
        if problems:
            raise AssertionError("train_llama_750m_offload: "
                                 + "; ".join(problems))
        self.train_gate(t["model"], None, batch,
                        zero={"stage": 1, "zenflow": ZENFLOW},
                        layers=t["gate_layers"],
                        label="train_llama_750m_offload/zenflow_gate")
        name = "train_llama_750m_offload"
        for run in ("a_cpu", "b_nvme", "c_zenflow"):
            for k, v in want.items():
                if v:
                    self.launches.setdefault(k, {})[f"{name}/{run}"] = \
                        runs[run]["launches"][k]
            self.steps[f"{name}/{run}"] = t["steps"]
        self.state["offload_750m"] = result

    def phase_quantized_reduce_scatter(self):
        """The entry point at world 2 and 4, ranks on the one card."""
        from deepspeed_tpu_torch.ops import build

        build.build_all()
        self.torch.cuda.empty_cache()
        out, problems = {}, []
        for world in QRS["worlds"]:
            ranks = spawn_ranks("quantized_reduce_scatter_rank", world,
                                self.seed, dict(QRS, device=str(self.dev)))
            for r in ranks:
                tag = f"world {world} rank {r['rank']}"
                if not r["kernel_equals_plain"]:
                    problems.append(f"{tag}: kernels differ from plain")
                if r["chunk"] != ranks[0]["whole"][r["rank"]]:
                    problems.append(f"{tag}: its chunk is not chunk "
                                    f"{r['rank']} of the whole reduction")
                if r["err_out_of_bound"] or not r["finite"]:
                    problems.append(f"{tag}: {r['err_out_of_bound']} "
                                    "elements past the int8 error bound")
                if r["launches"] != {"quant_int8": 1, "dequant_reduce": 1}:
                    problems.append(f"{tag}: launches {r['launches']}")
            out[f"world{world}"] = [{k: v for k, v in r.items()
                                     if k not in ("chunk", "whole")}
                                    for r in ranks]
        emit("quantized_reduce_scatter", card=self.card, n_per_rank=QRS["n"],
             wire_note="gloo through host memory, ranks sharing one card",
             **out)
        if problems:
            raise AssertionError("quantized_reduce_scatter: "
                                 + "; ".join(problems))

    def quant_times(self, flush):
        """quantize_int8_blocks on llama_750m's packed qgZ gradient at world
        2 and dequant_reduce on its [2, n_sh] receive: kernel, plain, bound
        (each input read once, each output written once: quantize 4 + 1
        bytes an element and a scale a block; dequant-reduce W int8 rows,
        their scales and the fp32 row). Beside each, ``replica_hop``: the
        same kernel in hpZ's replica hop (data 2 x zshard 2), quantizing a
        rank's reduced shard [n_sh] and summing the two replicas' rows [2,
        n_sh] (no mean). No single PyTorch call computes per-block int8
        with this scale rule, so library_ms is null."""
        torch = self.torch
        from deepspeed_tpu_torch.ops import quant_kernels as QK

        W, B = ZEROPP["world"], 2048
        n_sh = (self.state["zeropp"]["n_sh"] if "zeropp" in self.state
                else self.packed_width(ZEROPP["model"], W)[0])
        N = W * n_sh
        g = torch.Generator(self.dev).manual_seed(23)
        x = torch.randn(N, generator=g, device=self.dev) * 1e-3
        q, sc = QK.quantize_int8_blocks(x)
        lib = "none: no single PyTorch call computes per-block int8 with " \
              "this scale rule"
        shape = {"W": W, "n_sh": n_sh, "block": B}
        # hpZ's replica hop: a zshard group of 2 shards the layout as
        # data = 2 does, so the rank's reduced shard has the same n_sh
        D = HPZ["world"] // HPZ_Z
        xr = x[:n_sh]
        qr, scr = q.view(W, -1)[:D], sc.view(W, -1)[:D]
        out = {
            "quant_int8": dict(
                self.bound(5.0 * N + 4.0 * N / B, 4.0 * N, "float32"),
                ms=self.time_ms(lambda: QK.quantize_int8_blocks(x),
                                flush=flush),
                plain_ms=self.time_ms(lambda: QK.quantize_int8_blocks_ref(x),
                                      iters=5, flush=flush),
                library_ms=None, library=lib,
                shape=dict(shape, n=N, dtype="float32"),
                replica_hop=dict(
                    self.bound(5.0 * n_sh + 4.0 * n_sh / B, 4.0 * n_sh,
                               "float32"),
                    ms=self.time_ms(lambda: QK.quantize_int8_blocks(xr),
                                    flush=flush),
                    plain_ms=self.time_ms(
                        lambda: QK.quantize_int8_blocks_ref(xr), iters=5,
                        flush=flush),
                    library_ms=None, shape={"n": n_sh, "dtype": "float32"})),
            "dequant_reduce": dict(
                self.bound(N + 4.0 * N / W + 4.0 * N / B, 2.0 * N,
                           "float32"),
                ms=self.time_ms(lambda: QK.dequant_reduce(
                    q.view(W, -1), sc.view(W, -1), mean=True), flush=flush),
                plain_ms=self.time_ms(lambda: QK.dequant_reduce_ref(
                    q.view(W, -1), sc.view(W, -1), mean=True), iters=5,
                    flush=flush),
                library_ms=None, library=lib,
                shape=dict(shape, C=n_sh, mean=True),
                replica_hop=dict(
                    self.bound(D * n_sh + 4.0 * n_sh + 4.0 * D * n_sh / B,
                               2.0 * D * n_sh, "float32"),
                    ms=self.time_ms(lambda: QK.dequant_reduce(qr, scr),
                                    flush=flush),
                    plain_ms=self.time_ms(lambda: QK.dequant_reduce_ref(
                        qr, scr), iters=5, flush=flush),
                    library_ms=None,
                    shape={"W": D, "C": n_sh, "mean": False}))}
        del x, q, sc, xr, qr, scr
        torch.cuda.empty_cache()
        return out

    # ------------------------------------------------------------------ #
    def time_ms(self, fn, iters=20, flush=None):
        """Median device ms of ``fn`` by CUDA events, one event pair per
        call, with L2 flushed before each (the serving path meets each
        layer's pool cold). A spin kernel queued first keeps the card busy
        while the host enqueues the flush, the events and ``fn``'s kernels,
        so the events time the device, not the host's launch latency."""
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(5_000_000)        # spin 5e6 cycles
            if flush is not None:
                flush.zero_()
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def pa_case(self, name, q, kp, vp, tables, lengths, flush):
        """The call's time (CUDA events, as every kernel row), plain,
        bound and SDPA-on-pre-gathered-KV times, with the plan built
        beforehand where the call reads one, as forward_paged does once a
        tick; besides, each kernel's own device time under the profiler."""
        torch = self.torch
        import torch.nn.functional as F
        from deepspeed_tpu_torch.ops import paged_attention as PA

        Tn, N, D = q.shape
        _, bs, K, _ = kp.shape
        elt = q.element_size()
        dtype = str(q.dtype).split(".")[-1]
        plan = PA.build_plan(tables) if PA.uses_plan(q.dtype, Tn) else None
        got = PA.paged_attention(q, kp, vp, tables, lengths, plan=plan)
        want = PA.paged_attention_reference(q, kp, vp, tables, lengths)
        tb, ln = tables.cpu().numpy(), lengths.cpu().numpy()
        pre = torch.from_numpy(prefill_rows(tb, PA.MIN_RUN)).to(self.dev)
        err = self.close(name, got[~pre], want[~pre], dtype) \
            if bool((~pre).any()) else 0.0
        rule = None
        if bool(pre.any()):
            want32 = PA.paged_attention_reference(q.float(), kp.float(),
                                                  vp.float(), tables, lengths)
            err_p, rule = self.close_flash(name + "/prefill", got[pre],
                                           want[pre], want32[pre], dtype, "o")
            err = max(err, err_p)
        cap = tb.shape[1] * bs
        blocks = {int(tb[t, j]) for t in range(Tn)
                  for j in range(-(-min(int(ln[t]), cap) // bs))}
        kv_bytes = len(blocks) * bs * K * D * 2 * elt
        io_bytes = 2 * q.numel() * elt + tables.numel() * 4 + Tn * 4
        flops = float(4 * N * D * np.clip(ln, 0, cap).astype(np.int64).sum())
        t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        call = lambda: PA.paged_attention(q, kp, vp, tables, lengths,
                                          plan=plan)
        ms = self.time_ms(call, flush=flush)
        # the host's cost of a call: 50 calls queued back to back (the card
        # keeps up or falls behind; either way the host does not wait)
        self.sync()
        t0 = time.perf_counter()
        for _ in range(50):
            call()
        host_ms = (time.perf_counter() - t0) / 50 * 1e3
        self.sync()
        by_kernel = self.kernel_device_ms(
            call, ("paged_attention_decode", "paged_attention_prefill"),
            flush=flush)
        plain = self.time_ms(lambda: PA.paged_attention_reference(
            q, kp, vp, tables, lengths), iters=5, flush=flush)
        # SDPA over KV gathered beforehand into [T, N, ctx, D]: a different
        # function (no paging, rectangular context), timed as a yardstick
        ctx = int(ln.max())
        idx = tables[:, :-(-ctx // bs)].long()
        kg = kp[idx].reshape(Tn, -1, K, D)[:, :ctx].repeat_interleave(
            N // K, 2).transpose(1, 2).contiguous()
        vg = vp[idx].reshape(Tn, -1, K, D)[:, :ctx].repeat_interleave(
            N // K, 2).transpose(1, 2).contiguous()
        mask = (torch.arange(ctx, device=self.dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        qs = q[:, :, None, :]
        sdpa = self.time_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask), flush=flush)
        del kg, vg
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                "kernel_ms": by_kernel, "host_ms_per_call": host_ms,
                "bf16_rule": rule,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "unique_kv_bytes": kv_bytes, "rows": Tn,
                "prefill_rows": int(pre.sum()),
                "sdpa_pregathered_ms": sdpa}

    def kernel_device_ms(self, fn, subs, iters=10, flush=None):
        """Device ms a call of ``fn`` spends in the kernels whose names
        hold each of ``subs``: torch.profiler's kernel times over ``iters``
        calls, each behind an L2 flush, over ``iters``."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        self.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                fn()
            self.sync()
        out = {sub: 0.0 for sub in subs}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            t = float(getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
            for sub in subs:
                if sub in e.key:
                    out[sub] += t / 1e3 / iters
        return {k: v or "not measured" for k, v in out.items()}

    def norm_case(self, kind, x, s, b, eps, flush):
        torch = self.torch
        import torch.nn.functional as F
        from deepspeed_tpu_torch.ops import norms

        H = x.shape[-1]
        if kind == "rms_norm":
            k = lambda: norms.rms_norm(x, s, eps)
            p = lambda: norms.rms_norm_ref(x, s, eps)
            lib = lambda: F.rms_norm(x, (H,), s, eps)
            params = (s,)
        else:
            k = lambda: norms.layer_norm(x, s, b, eps)
            p = lambda: norms.layer_norm_ref(x, s, b, eps)
            lib = lambda: F.layer_norm(x, (H,), s, b, eps)
            params = (s, b)
        err = self.close(kind, k(), p(), str(x.dtype).split(".")[-1])
        nbytes = 2 * x.numel() * x.element_size() + sum(
            t.numel() * t.element_size() for t in params)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 8.0 * x.numel() / PEAK_FLOPS[str(x.dtype).split(".")[-1]] * 1e3
        return {"max_abs_err": err, "ms": self.time_ms(k, flush=flush),
                "plain_ms": self.time_ms(p, flush=flush),
                "library_ms": self.time_ms(lib, flush=flush),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "rows": x.shape[0]}

    def decode_rate(self, model):
        """Graph ticks against eager ticks in one run, from one state, the
        keys warm. The main path's prompts are prefilled by step() ticks
        each way (TTFT p50, prefill tokens/s); then decode windows of 32
        ticks in turns eager, graph, graph, eager, each from the same
        restored state after a window that warms its key (host clock around
        synchronised work), and one window of 8 each way under the profiler
        (device ms, idle share, kernels and CUDA runtime calls a tick);
        then decode_stream's rate from one drain to the next, on the
        graphs; and each graph key's capture cost. The norm forwards'
        device time per launch inside the graph is the profiled window's
        norm time over its launches."""
        torch = self.torch
        st = self.state[model]
        eng, prompts = st["engine"], st["prompts"]
        cuda = self.dev.type == "cuda"
        out = {"batch": len(prompts), "card": self.card}
        for mode, base in (("eager", 200), ("graph", 100)):
            eng._graphs = mode == "graph" and cuda
            uids = list(range(base, base + len(prompts)))
            ticks0 = eng.device_ticks.copy()
            self.sync()
            t0 = time.perf_counter()
            self.prefill(eng, uids, prompts)
            self.sync()
            wall = time.perf_counter() - t0
            ran = eng.device_ticks - ticks0
            out[mode] = {
                "prefill_steps": sum(n for (how, _), n in ran.items()
                                     if how != "warmup"),
                "prefill_captures": sum(n for (how, _), n in ran.items()
                                        if how == "warmup"),
                "prefill_wall_s": wall,
                "prefill_tokens_per_s": sum(st["lens"]) / wall,
                "ttft_p50_s": float(np.median(
                    list(eng.ttft_log)[-len(prompts):]))}
            if mode == "eager":
                eng.flush(uids)
        live = [eng.seqs[u] for u in uids]
        _, restore, saved = self.saver(eng, live)

        walls = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            eng._graphs = mode == "graph" and cuda
            restore()
            eng.decode_steps(32)                # warms the key
            restore()
            self.sync()
            t0 = time.perf_counter()
            got = eng.decode_steps(32)
            self.sync()
            walls[mode].append(time.perf_counter() - t0)
            n_tok = sum(len(v) for v in got.values())
        for mode in ("eager", "graph"):
            eng._graphs = mode == "graph" and cuda
            restore()
            eng.decode_steps(8)
            restore()
            prof = self.profile_window(eng, 8)
            w = float(np.median(walls[mode]))
            tick_ms = w / 32 * 1e3
            dev_ms = prof.pop("device_ms_per_tick")
            out[mode].update(
                decode_tokens=n_tok, decode_wall_s=walls[mode],
                decode_tokens_per_s=[n_tok / x for x in walls[mode]],
                decode_tick_ms=tick_ms, device_ms_per_tick=dev_ms or
                "not measured",
                device_idle_share=(1 - dev_ms / tick_ms if dev_ms
                                   else "not measured"), **prof)
        # decode_stream on the graphs: drain-to-drain over 6 windows of 8
        eng._graphs = cuda
        restore()
        marks = []
        self.sync()
        for _ in eng.decode_stream(window=8):
            marks.append(time.perf_counter())
            if len(marks) == 7:
                break
        gaps = np.diff(marks)
        out["stream"] = {"windows": len(gaps), "window_wall_s": gaps.tolist(),
                         "decode_tokens_per_s": float(
                             8 * len(live) / np.median(gaps)) if len(gaps)
                         else "not measured"}
        eng.flush(uids)
        # the norm forwards inside the graph: device ms a launch
        kind = "rms_norm" if eng.cfg.norm == "rmsnorm" else "layer_norm"
        per_tick = out["graph"]["device_ms_per_tick_by_kind"]
        norm_ms = (per_tick.get(kind) if isinstance(per_tick, dict)
                   else None)
        out["norm_in_graph"] = {
            "kernel": kind, "launches_per_tick": 2 * eng.cfg.num_layers + 1,
            "device_ms_per_launch": (norm_ms / (2 * eng.cfg.num_layers + 1)
                                     if norm_ms else "not measured")}
        stats = eng.graph_stats()
        out["graphs"] = {"keys": len(stats), "per_key": stats}
        return out

    def profile_window(self, eng, n_ticks):
        """One decode_steps window of ``n_ticks`` under torch.profiler:
        device ms, kernels and the host's CUDA runtime calls a tick, and
        the device's idle gaps between its first and last kernel (with
        graphs: the gaps between nodes and between replays)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = eng.decode_steps(n_ticks)
            self.sync()
        ticks = n_ticks if got else 0
        spans = {"decode_window", "decode_tick", "schedule_tick"}
        dev_us = {}     # kernels only: ops and span ranges would double count
        n_kernels = 0
        runtime = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CPU and e.key.startswith("cuda"):
                # the host's CUDA runtime calls (launches, copies,
                # synchronisations) a tick, as CUPTI sees them
                runtime[e.key] = {
                    "calls": e.count / max(ticks, 1),
                    "us": float(getattr(e, "cpu_time_total", 0))
                    / max(ticks, 1)}
            if e.device_type != DeviceType.CUDA or e.key in spans \
                    or getattr(e, "is_user_annotation", False):
                continue
            t = float(getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
            if t:
                dev_us[e.key] = dev_us.get(e.key, 0.0) + t
                n_kernels += e.count
        by_kind = {}
        for key, us in dev_us.items():
            kind = kernel_kind(key)
            if kind in ("norm_fwd", "other"):     # the norm kernel by kind
                low = key.lower()
                kind = ("rms_norm" if "rms_norm" in low
                        else "layer_norm" if "layer_norm" in low else kind)
            by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / max(ticks, 1)
        total_us = sum(dev_us.values())
        # the device's busy intervals, merged: their gaps inside the span
        spans_us = sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.key in dev_us)
        gap_us, end = 0.0, None
        for a, b in spans_us:
            if end is not None and a > end:
                gap_us += a - end
            end = b if end is None else max(end, b)
        span_us = end - spans_us[0][0] if spans_us else 0.0
        return {"profiled_ticks": ticks,
                "device_span_ms_per_tick": (span_us / 1e3 / ticks
                                            if span_us and ticks
                                            else "not measured"),
                "device_gap_ms_per_tick": (gap_us / 1e3 / ticks
                                           if span_us and ticks
                                           else "not measured"),
                "kernels_per_tick": (n_kernels / ticks if n_kernels
                                     else "not measured"),
                "device_ms_per_tick": (total_us / 1e3 / ticks
                                       if total_us and ticks else None),
                "device_ms_per_tick_by_kind": by_kind or "not measured",
                "host_runtime_per_tick": runtime or "not measured",
                "top_kernels_us": {k[:90]: v for k, v in sorted(
                    dev_us.items(), key=lambda kv: -kv[1])[:8]}}

    def phase_times(self):
        """Times what the phases before it ran: the serving rows need the
        serving phases, fused Adam train_gpt2_125m, the grouped GEMM
        train_moe_350m, each step profile its train phase; the kernel rows
        of flash, block-sparse and Evoformer attention and the norms need
        none. Every phase runs before it when the script runs whole."""
        torch = self.torch
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=self.dev)
        g = torch.Generator(self.dev).manual_seed(2)
        nm = {}
        for kind, H, R in (("rms_norm", 4096, 8), ("rms_norm", 4096, 256),
                           ("rms_norm", 1536, 8192), ("layer_norm", 768, 8),
                           ("layer_norm", 768, 512),
                           ("layer_norm", 768, 32768)):
            x = torch.randn(R, H, generator=g, device=self.dev).to(
                torch.bfloat16)
            s = (1 + 0.1 * torch.randn(H, generator=g, device=self.dev)).to(
                torch.bfloat16)
            b = (0.1 * torch.randn(H, generator=g, device=self.dev)).to(
                torch.bfloat16)
            nm[f"{kind}[R={R}]"] = self.norm_case(kind, x, s, b, 1e-5, flush)
        pa = rates = None
        if "llama2_7b" in self.state and "gpt2_125m" in self.state:
            pa = self.serving_times(flush)
            rates = {m: self.decode_rate(m) for m in ("llama2_7b",
                                                      "gpt2_125m")}
            # device ms a launch inside the decode tick's graph
            for m, row, name in (
                    ("llama2_7b", nm["rms_norm[R=8]"], None),
                    ("gpt2_125m", nm["layer_norm[R=8]"], None),
                    ("llama2_7b", pa["decode"], "paged_attention_decode")):
                r = rates[m]
                by_kind = r["graph"]["device_ms_per_tick_by_kind"]
                L = self.state[m]["engine"].cfg.num_layers
                row["in_graph_kernel_ms"] = (
                    r["norm_in_graph"]["device_ms_per_launch"] if name is None
                    else by_kind[name] / L if isinstance(by_kind, dict)
                    and by_kind.get(name) else "not measured")
            for m in ("llama2_7b", "gpt2_125m"):       # free the engines
                self.state.pop(m)
        emit("times", card=self.card, paged_attention=pa, norms=nm,
             decode=rates, peak_memory_bytes=torch.cuda.max_memory_allocated(
                 self.dev))
        torch.cuda.empty_cache()
        fl = {label: self.flash_times(label, B, S, N, K, D, flush)
              for label, B, S, N, K, D, _ in FLASH_CASES[:3]}
        adam = (self.adam_times(flush) if "train_gpt2_125m" in self.state
                else None)
        gg = (self.gmm_times(flush) if "train_moe_350m" in self.state
              else None)
        nb = self.norm_bwd_times(flush)
        sp = self.sparse_times(flush, fl["llama_750m"])
        ev = self.evo_times(flush)
        steps = {m: self.state[f"train_{m}"]["profile"] for m in TRAIN
                 if f"train_{m}" in self.state}
        if "zeropp" in self.state:
            zp = self.state["zeropp"]
            steps["llama_750m_zeropp_dp2"] = zp["profile"]
            steps["llama_750m_exact_zero2_dp2"] = zp["baseline"]
        if "zero3" in self.state:
            steps["llama_750m_exact_zero3_dp2"] = self.state["zero3"]["exact"]
            steps["llama_750m_zero3_qgz_qwz_loco_dp2"] = \
                self.state["zero3"]["wire"]
        if "hpz" in self.state:
            steps["llama_750m_zero3_hpz_qwz_qgz_dp4"] = \
                self.state["hpz"]["trio"]
            steps["llama_750m_mics_zero3_dp4"] = self.state["hpz"]["mics"]
        if "moe_ep" in self.state:
            steps["moe_350m_ep2"] = self.state["moe_ep"]["a"]
            steps["moe_350m_data2_ep2"] = self.state["moe_ep"]["b"]
        if "evoformer" in self.state:
            ev["msa_row_attention_step_ms"] = self.evo_step_times()
        q8 = self.quant_times(flush)
        emit("times/train", card=self.card, flash=fl, fused_adam=adam,
             grouped_gemm=gg, norm_backward=nb, block_sparse=sp,
             evoformer=ev, int8_wire=q8, steps=steps,
             wire_note="data-parallel step times: gloo through host "
                       "memory, two (hpZ: four) ranks sharing one card")
        return {"pa": pa, "nm": nm, "fl": fl, "adam": adam, "gg": gg,
                "sp": sp, "ev": ev, "q8": q8}

    def serving_times(self, flush):
        """Paged attention at llama2_7b's decode, prefill and mixed
        ticks."""
        torch = self.torch
        llama = self.state["llama2_7b"]
        eng = llama["engine"]
        lens = llama["lens"]
        bs = eng.block_size
        dt = "bfloat16"
        # decode tick of the main path: one row per request, each at its
        # prompt length + 16, table width tier of the longest
        dec_len = [n + 16 for n in lens]
        mb = eng._mb_tier(max(dec_len) // bs + 1)
        pa = {}
        args = self.pa_inputs(32, 32, 128, bs, mb, dt, dec_len, pad_rows=0)
        pa["decode"] = self.pa_case("paged_attention[decode]", *args, flush)
        # prefill tick: 256 rows, the last chunk of the longest prompt
        L0 = max(max(lens), 256)
        chunk = [L0 - 255 + i for i in range(256)]
        mb = eng._mb_tier((L0 - 1) // bs + 1)
        q, kp, vp, tables, _ = self.pa_inputs(32, 32, 128, bs, mb, dt,
                                              [L0], pad_rows=0)
        q = torch.randn(256, 32, 128, device=self.dev).to(q.dtype)
        ticks = {"prefill": (q, kp, vp, tables.expand(256, -1).contiguous(),
                             torch.tensor(chunk, dtype=torch.int32,
                                          device=self.dev))}
        pa["prefill"] = self.pa_case("paged_attention[prefill]",
                                     *ticks["prefill"], flush)
        # mixed tick: the 8 decode rows, then a 248-row chunk of the
        # longest prompt ending at its last token
        mixed = dec_len[:8] + [L0 - 247 + i for i in range(248)]
        mb = eng._mb_tier(max(mixed) // bs + 1)
        q, kp, vp, tables, _ = self.pa_inputs(32, 32, 128, bs, mb, dt,
                                              dec_len[:8] + [L0], pad_rows=0)
        q = torch.randn(256, 32, 128, device=self.dev).to(q.dtype)
        tables = torch.cat([tables[:8], tables[8:].expand(248, -1)])
        tables = tables.contiguous()
        ticks["mixed"] = (q, kp, vp, tables, torch.tensor(
            mixed, dtype=torch.int32, device=self.dev))
        pa["mixed"] = self.pa_case("paged_attention[mixed]",
                                   *ticks["mixed"], flush)
        pa["plan"] = self.plan_case(tables, flush)
        pa["decode_grid_rows"] = self.decode_grid_sweep(eng, dec_len, ticks,
                                                        flush)
        return pa

    def decode_grid_sweep(self, eng, dec_len, ticks, flush):
        """The decode kernel's grid x, capped by PA.DECODE_GRID_ROWS (its
        blocks walk the rows past the cap in turn; None: one block row a
        row), at caps 16, 32, 64 and none: decode ticks of 32, 64 and 128
        rows at llama2_7b's shapes (the main path's lengths, repeated;
        every row its own table, so every row a decode row), and the
        prefill and mixed ticks of ``ticks``, whose grid is mostly blocks
        with no decode row. The call's time by CUDA events."""
        from deepspeed_tpu_torch.ops import paged_attention as PA

        bs, cap0 = eng.block_size, PA.DECODE_GRID_ROWS
        out = {"default": cap0}

        def sweep(name, args):
            plan = PA.build_plan(args[3])
            for cap in (16, 32, 64, None):
                PA.DECODE_GRID_ROWS = cap
                out[f"{name}_cap{cap or 'none'}_ms"] = self.time_ms(
                    lambda: PA.paged_attention(*args, plan=plan),
                    flush=flush)

        try:
            for n in (32, 64, 128):
                ln = [dec_len[i % len(dec_len)] for i in range(n)]
                mb = eng._mb_tier(max(ln) // bs + 1)
                sweep(f"decode{n}", self.pa_inputs(
                    32, 32, 128, bs, mb, "bfloat16", ln, pad_rows=0, seed=n))
            for name, args in ticks.items():
                sweep(name, args)
        finally:
            PA.DECODE_GRID_ROWS = cap0
        return out

    def plan_case(self, tables, flush):
        """The plan kernel at a tick's tables against build_plan_reference
        on the card (bit-equal), timed; bound: the tables read once and the
        plan written once."""
        from deepspeed_tpu_torch.ops import paged_attention as PA

        got = PA.build_plan(tables)
        ref = PA.build_plan_reference(tables)
        if not all(self.torch.equal(a, b)
                   for a, b in zip(got.fields(), ref.fields())):
            raise AssertionError("paged_attention[plan]: the plan kernel "
                                 "differs from build_plan_reference")
        out_bytes = sum(t.numel() * 4 for t in got.fields())
        b = self.bound(tables.numel() * 4 + out_bytes, 0.0)
        return {"max_abs_err": 0.0, "rows": tables.shape[0],
                "table_width": tables.shape[1],
                "ms": self.time_ms(lambda: PA.build_plan(tables),
                                   flush=flush),
                "plain_ms": self.time_ms(
                    lambda: PA.build_plan_reference(tables), flush=flush),
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}

    @staticmethod
    def bound(nbytes, flops, dtype="bfloat16"):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops}

    def flash_times(self, label, B, S, N, K, D, flush):
        """Forward, dq and dkv at a main-path shape (bf16, causal, N == K):
        kernel, plain, the library's calls (SDPA forward; PyTorch's
        flash-attention backward op alone, which gives dq, dk and dv
        together; SDPA forward+backward as well), bounds with each
        input read and each output written once and the causal half of the
        score matrix computed."""
        torch = self.torch
        import torch.nn.functional as F
        from deepspeed_tpu_torch.ops import flash_attention as PF

        q, k, v, do = self.flash_inputs(B, S, N, K, D, "bfloat16", seed=7)
        o, lse = PF.flash_fwd(q, k, v, True)
        delta = PF.flash_bwd_delta(o, do)
        elt, BN = q.element_size(), B * N
        pairs = BN * S * (S + 1) // 2
        qb, kvb, rowb = q.numel() * elt, k.numel() * elt, BN * S * 4
        out = {
            "flash_fwd": dict(self.bound(2 * qb + 2 * kvb + rowb,
                                         4.0 * pairs * D),
                              ms=self.time_ms(lambda: PF.flash_fwd(
                                  q, k, v, True), flush=flush),
                              plain_ms=self.time_ms(lambda: PF.flash_fwd_ref(
                                  q, k, v, True), iters=5, flush=flush)),
            "flash_bwd_dq": dict(self.bound(3 * qb + 2 * kvb + 2 * rowb,
                                            6.0 * pairs * D),
                                 ms=self.time_ms(lambda: PF.flash_bwd_dq(
                                     q, k, v, do, lse, delta, True),
                                     flush=flush)),
            "flash_bwd_dkv": dict(self.bound(2 * qb + 4 * kvb + 2 * rowb,
                                             8.0 * pairs * D),
                                  ms=self.time_ms(lambda: PF.flash_bwd_dkv(
                                      q, k, v, do, lse, delta, True),
                                      flush=flush))}
        # the plain backward computes dq, dk and dv together
        plain_bwd = self.time_ms(lambda: PF.flash_bwd_ref(
            q, k, v, o, lse, do, True), iters=5, flush=flush)
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        gqa = dict(enable_gqa=True) if K != N else {}
        sdpa_fwd = self.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, **gqa), flush=flush)
        qr, kr, vr = (x.detach().requires_grad_() for x in (qt, kt, vt))

        def sdpa_fb():
            F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                           **gqa).backward(dot)

        sdpa_fb_ms = self.time_ms(sdpa_fb, flush=flush)
        # the library's backward alone: PyTorch's flash-attention backward
        # op from the same (do, q, k, v) and its own forward's o and lse
        aten = torch.ops.aten
        fo = aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True)
        lib_bwd = self.time_ms(
            lambda: aten._scaled_dot_product_flash_attention_backward(
                dot, qt, kt, vt, *fo[:6], 0.0, True, *fo[6:8]), flush=flush)
        out["flash_fwd"]["library_ms"] = sdpa_fwd
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            out[name].update(plain_ms=plain_bwd, plain_computes="dq, dk, dv",
                             library_ms=lib_bwd,
                             library_computes="dq, dk, dv")
        for row in out.values():
            row["sdpa_fwd_bwd_ms"] = sdpa_fb_ms
            row["shape"] = {"B": B, "S": S, "N": N, "K": K, "D": D,
                            "causal": True, "dtype": "bfloat16"}
            row["tflops_per_s"] = row["flops"] / row["ms"] / 1e9
        del q, k, v, do, o, lse, delta, qr, kr, vr, fo
        torch.cuda.empty_cache()
        return out

    def sparse_times(self, flush, dense):
        """Block-sparse forward, dq and dkv at the main path's shape
        (llama_750m: B 4, S 2048, N 12, D 128, bf16, block 64, the causal
        fixed layout): kernel, plain, bound (each input read and each output
        written once; flops over the active squares' causal pairs only),
        and the library's yardsticks on the layout expanded to an [S, S]
        mask — SDPA forward, and the memory-efficient attention backward op
        (dq, dk, dv together) where this PyTorch takes its arguments. The
        port's dense flash kernels' times at this shape (``dense``) stand
        beside them."""
        torch = self.torch
        import torch.nn.functional as F
        from deepspeed_tpu_torch.ops import block_sparse as BS
        from deepspeed_tpu_torch.ops import flash_attention as PF

        t = TRAIN["llama_750m_sparse"]
        B, S, N, D, blk = t["micro"], t["seq"], 12, 128, SPARSE_BLOCK
        lay = self.sparse_layout("fixed", S // blk, True)
        q, k, v, do = self.flash_inputs(B, S, N, N, D, "bfloat16", seed=9)
        o, lse = BS.block_sparse_fwd(q, k, v, lay, blk, True)
        delta = PF.flash_bwd_delta(o, do)
        idx = np.argwhere(lay != 0)
        diag = int((idx[:, 0] == idx[:, 1]).sum())
        pairs = B * N * ((len(idx) - diag) * blk * blk
                         + diag * blk * (blk + 1) // 2)
        elt, BN = q.element_size(), B * N
        qb, kvb, rowb = q.numel() * elt, k.numel() * elt, BN * S * 4
        args = (lay, blk, True)
        out = {
            "block_sparse_fwd": dict(
                self.bound(2 * qb + 2 * kvb + rowb, 4.0 * pairs * D),
                ms=self.time_ms(lambda: BS.block_sparse_fwd(q, k, v, *args),
                                flush=flush),
                plain_ms=self.time_ms(lambda: BS.block_sparse_fwd_ref(
                    q, k, v, *args), iters=5, flush=flush),
                dense_flash_ms=dense["flash_fwd"]["ms"]),
            "block_sparse_bwd_dq": dict(
                self.bound(3 * qb + 2 * kvb + 2 * rowb, 6.0 * pairs * D),
                ms=self.time_ms(lambda: BS.block_sparse_bwd_dq(
                    q, k, v, do, lse, delta, *args), flush=flush),
                dense_flash_ms=dense["flash_bwd_dq"]["ms"]),
            "block_sparse_bwd_dkv": dict(
                self.bound(2 * qb + 4 * kvb + 2 * rowb, 8.0 * pairs * D),
                ms=self.time_ms(lambda: BS.block_sparse_bwd_dkv(
                    q, k, v, do, lse, delta, *args), flush=flush),
                dense_flash_ms=dense["flash_bwd_dkv"]["ms"])}
        plain_bwd = self.time_ms(lambda: BS.block_sparse_bwd_ref(
            q, k, v, o, lse, do, *args), iters=5, flush=flush)
        mask = BS._mask(lay, blk, S, True, self.dev)
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        sdpa_fwd = self.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), flush=flush)
        # the memory-efficient attention op pair with the layout as an
        # additive bias (0 / -inf), its backward alone
        bias = torch.zeros(S, S, dtype=q.dtype, device=self.dev) \
            .masked_fill(~mask, float("-inf")).expand(B, N, S, S)
        aten = torch.ops.aten
        lib_bwd, lib_op = None, "aten._scaled_dot_product_efficient_" \
            "attention_backward"
        try:
            qc, kc, vc, dc = (x.contiguous() for x in (qt, kt, vt, dot))
            fo = aten._scaled_dot_product_efficient_attention(
                qc, kc, vc, bias, True, 0.0, False)
            lib_bwd = self.time_ms(
                lambda: aten._scaled_dot_product_efficient_attention_backward(
                    dc, qc, kc, vc, bias, fo[0], fo[1], fo[2], fo[3], 0.0,
                    [True, True, True, False], False), flush=flush)
            del qc, kc, vc, dc, fo
        except (RuntimeError, TypeError) as e:
            lib_op = f"none ({type(e).__name__}: {str(e)[:120]})"
        out["block_sparse_fwd"].update(
            library_ms=sdpa_fwd, library="F.scaled_dot_product_attention "
            "(bool mask)")
        for name in ("block_sparse_bwd_dq", "block_sparse_bwd_dkv"):
            out[name].update(plain_ms=plain_bwd, plain_computes="dq, dk, dv",
                             library_ms=lib_bwd, library=lib_op,
                             library_computes="dq, dk, dv")
        for row in out.values():
            row["shape"] = {"B": B, "S": S, "N": N, "K": N, "D": D,
                            "block": blk, "layout": "fixed (causal)",
                            "active_squares": len(idx),
                            "causal_squares": (S // blk) * (S // blk + 1)
                            // 2, "dtype": "bfloat16"}
            row["tflops_per_s"] = row["flops"] / row["ms"] / 1e9
        del q, k, v, do, o, lse, delta, mask, bias, qt, kt, vt, dot
        torch.cuda.empty_cache()
        return out

    def evo_times(self, flush):
        """The Evoformer forward at OpenFold's triangle (per-row bias) and
        MSA-row (shared bias) shapes, bf16 with a bf16 bias: kernel, plain,
        bound (q, k, v and the bias read once, o written once; 4 G N S^2 D
        flops) and SDPA with the bias as its float ``attn_mask``."""
        torch = self.torch
        import torch.nn.functional as F
        from deepspeed_tpu_torch.ops import evoformer as EV

        out = {}
        for label, G, S, N, D, bias_kind in EVO_CASES[:2]:
            q, k, v, bias = self.evo_inputs(G, S, N, D, bias_kind,
                                            "bfloat16", seed=3)
            elt = q.element_size()
            nbytes = 4 * q.numel() * elt + bias.numel() * bias.element_size()
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row = out[label] = dict(
                self.bound(nbytes, 4.0 * G * N * S * S * D),
                ms=self.time_ms(lambda: EV.evoformer_fwd(q, k, v, bias),
                                flush=flush),
                plain_ms=self.time_ms(lambda: EV.evoformer_flash_ref(
                    q, k, v, bias), iters=5, flush=flush),
                library_ms=self.time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bias), flush=flush),
                library="F.scaled_dot_product_attention (float attn_mask)",
                shape={"G": G, "S": S, "N": N, "D": D,
                       "bias": list(bias.shape), "dtype": "bfloat16"})
            row["tflops_per_s"] = row["flops"] / row["ms"] / 1e9
            del q, k, v, bias, qt, kt, vt
            torch.cuda.empty_cache()
        return out

    def evo_step_times(self):
        """One bf16 forward + backward of the evoformer phase's main path,
        kernel and plain (CUDA events, median)."""
        x = self.state.pop("evoformer")["inputs"]
        return {"kernels": self.time_ms(lambda: self.evo_step(x, None),
                                        iters=5),
                "plain": self.time_ms(lambda: self.evo_step(x, False),
                                      iters=5)}

    def adam_times(self, flush):
        """Fused Adam over gpt2_125m's flat buffer (the main path's, with
        the bf16 compute copy written): kernel, plain, and
        ``torch.optim.AdamW(fused=True).step()`` as the yardstick (no
        compute copy)."""
        torch = self.torch
        from deepspeed_tpu_torch.ops import fused_adam as FA

        n = self.state["train_gpt2_125m"]["flat_n"]
        g = torch.Generator(self.dev).manual_seed(5)
        p, grad, m = (0.02 * torch.randn(n, generator=g, device=self.dev)
                      for _ in range(3))
        v = 1e-6 * torch.rand(n, generator=g, device=self.dev)
        out = torch.empty(n, dtype=torch.bfloat16, device=self.dev)
        bc1, bc2 = FA.bias_corrections(10, (0.9, 0.999))
        args = (TRAIN_LR, (0.9, 0.999), 1e-8, 0.0, bc1, bc2, True, out)
        ms = self.time_ms(lambda: FA.fused_adam(p, grad, m, v, *args),
                          flush=flush)
        plain = self.time_ms(lambda: FA.fused_adam_ref(p, grad, m, v, *args),
                             iters=5, flush=flush)
        pl = p.clone().requires_grad_()
        pl.grad = grad
        opt = torch.optim.AdamW([pl], lr=TRAIN_LR, weight_decay=0.0,
                                fused=True)
        opt.step()                      # allocates its state
        lib = self.time_ms(opt.step, flush=flush)
        res = dict(self.bound(30.0 * n, 15.0 * n, "float32"), ms=ms,
                   plain_ms=plain, library_ms=lib, n=n,
                   bytes_per_element=30)
        del p, grad, m, v, out, pl, opt
        torch.cuda.empty_cache()
        return res

    def gmm_times(self, flush):
        """The grouped GEMMs of one moe_350m layer on the main path (bf16,
        the warm-up step's layer-0 group sizes): up and down forward, their
        input gradients (rhs transposed) and weight gradients (tgmm) —
        kernel, plain, the library's grouped product (``torch._grouped_mm``)
        and the bound (each operand read once, the output written once,
        2 M K N flops over the routed rows)."""
        torch = self.torch
        from deepspeed_tpu_torch.ops import grouped_gemm as GG

        st = self.state["train_moe_350m"]
        cfg = st["config"]
        sizes = np.array(st["group_sizes_layer0"], np.int32)
        H, Fe, E = cfg.hidden_size, cfg.moe_ffn, cfg.n_experts
        M = int(sizes.sum())
        gs = torch.from_numpy(sizes).to(self.dev)
        offs = torch.cumsum(gs, 0).to(torch.int32)
        g = torch.Generator(self.dev).manual_seed(11)
        bf = torch.bfloat16
        out = {}
        for proj, K, N in (("up", H, Fe), ("down", Fe, H)):
            x = torch.randn(M, K, generator=g, device=self.dev).to(bf)
            w = (torch.randn(E, K, N, generator=g, device=self.dev)
                 / K ** 0.5).to(bf)
            dy = torch.randn(M, N, generator=g, device=self.dev).to(bf)
            cases = {
                "gmm": (lambda: GG.gmm(x, w, gs),
                        lambda: GG.gmm_ref(x, w, gs),
                        lambda: torch._grouped_mm(x, w, offs=offs),
                        (x, w), M * N),
                "gmm_transpose_rhs": (
                    lambda: GG.gmm(dy, w, gs, transpose_rhs=True),
                    lambda: GG.gmm_ref(dy, w, gs, transpose_rhs=True),
                    lambda: torch._grouped_mm(dy, w.transpose(1, 2),
                                              offs=offs),
                    (dy, w), M * K),
                "tgmm": (lambda: GG.tgmm(x, dy, gs),
                         lambda: GG.tgmm_ref(x, dy, gs),
                         lambda: torch._grouped_mm(x.t(), dy, offs=offs),
                         (x, dy), E * K * N)}
            for op, (kern, plain, lib, ins, n_out) in cases.items():
                nbytes = 2 * (sum(t.numel() for t in ins) + n_out) + 4 * E
                row = out[f"{op}[{proj}]"] = dict(
                    self.bound(nbytes, 2.0 * M * K * N),
                    ms=self.time_ms(kern, flush=flush),
                    plain_ms=self.time_ms(plain, iters=5, flush=flush),
                    library_ms=self.time_ms(lib, flush=flush),
                    library="torch._grouped_mm",
                    shape={"M": M, "K": K, "N": N, "E": E,
                           "group_sizes": sizes.tolist(),
                           "dtype": "bfloat16"})
                row["tflops_per_s"] = row["flops"] / row["ms"] / 1e9
            del x, w, dy
        torch.cuda.empty_cache()
        return out

    def norm_bwd_times(self, flush):
        """The norm backward at gpt2_125m's training size (R 32,768, H 768,
        bf16): the plain version on the main path (``ops/norms.py``
        ``layer_norm_bwd``) against PyTorch's one-call backward
        (``aten.native_layer_norm_backward``), and the RMS counterpart at
        llama_750m's (R 8,192, H 1,536) where this PyTorch has one."""
        torch = self.torch
        from deepspeed_tpu_torch.ops import norms

        aten = torch.ops.aten
        g = torch.Generator(self.dev).manual_seed(13)
        out = {}
        for kind, R, H in (("layer_norm", 32768, 768),
                           ("rms_norm", 8192, 1536)):
            x, dy = (torch.randn(R, H, generator=g, device=self.dev)
                     .to(torch.bfloat16) for _ in range(2))
            s = (1 + 0.1 * torch.randn(H, generator=g, device=self.dev)
                 ).to(torch.bfloat16)
            b = torch.zeros_like(s)
            if kind == "layer_norm":
                plain = lambda: norms.layer_norm_bwd(x, s, dy, 1e-5)
                _, mean, rstd = aten.native_layer_norm(x, (H,), s, b, 1e-5)
                lib_op = "aten.native_layer_norm_backward"
                lib = lambda: aten.native_layer_norm_backward(
                    dy, x, (H,), mean, rstd, s, b, [True, True, True])
            else:
                plain = lambda: norms.rms_norm_bwd(x, s, dy, 1e-5)
                op = getattr(aten, "_fused_rms_norm_backward", None)
                fwd = getattr(aten, "_fused_rms_norm", None)
                lib = lib_op = None
                if op is not None and fwd is not None:
                    try:
                        _, rstd = fwd(x, [H], s, 1e-5)
                        lib = lambda: op(dy, x, [H], rstd, s,
                                         [True, True])
                        lib()
                        lib_op = "aten._fused_rms_norm_backward"
                    except (RuntimeError, TypeError) as e:
                        lib, lib_op = None, f"none ({type(e).__name__})"
            nbytes = 3 * x.numel() * 2 + 2 * H * 2
            out[f"{kind}[R={R},H={H}]"] = dict(
                self.bound(nbytes, 10.0 * x.numel()),
                plain_ms=self.time_ms(plain, iters=5, flush=flush),
                library_ms=(self.time_ms(lib, flush=flush) if lib
                            else None), library=lib_op)
            del x, dy, s, b
        torch.cuda.empty_cache()
        return out

    def train_profile(self, model):
        """One more step of the main-path engine under torch.profiler (at
        the end of its train phase, before the engine is freed): the
        device time by kernel kind, the annotated loss and norm-backward
        spans, and the idle share of that step (its device time against
        its own synchronised wall, which the profiler's host cost lengthens
        beside the unprofiled median step)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        st = self.state[f"train_{model}"]
        engine = st["engine"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            self.sync()
            t0 = time.perf_counter()
            engine.train_batch(st["data"])
            self.sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        annotated = ("fused_lm_loss", "fused_lm_loss_backward",
                     "norm_backward", "moe_gate", "moe_dispatch",
                     "moe_combine", "moe_dispatch_backward",
                     "moe_combine_backward")
        kinds, spans = {}, {}
        n_kernels = 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = float(getattr(e, "self_device_time_total", 0)
                       or getattr(e, "self_cuda_time_total", 0))
            if e.key in annotated:
                spans[e.key] = spans.get(e.key, 0.0) + us / 1e3
                continue
            if getattr(e, "is_user_annotation", False) or not us:
                continue
            kind = kernel_kind(e.key)
            kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
            n_kernels += e.count
        device_ms = sum(kinds.values())
        attention_ms = sum(v for k, v in kinds.items()
                           if k.startswith(("flash_", "block_sparse_")))
        moe = {}
        if "moe_gmm" in kinds:
            # the MoE layer's share: the grouped GEMM kernels, and the
            # annotated spans of the gathers and the gate (plain PyTorch)
            moe = {"gmm": kinds["moe_gmm"], "tgmm": kinds.get("moe_tgmm", 0.0),
                   "dispatch_combine_gathers": sum(
                       spans.get(k, 0.0) for k in (
                           "moe_dispatch", "moe_combine",
                           "moe_dispatch_backward", "moe_combine_backward")),
                   "gating": spans.get("moe_gate", 0.0)}
        return {"step_ms": st["step_ms"], "tokens_per_s": st["tokens_per_s"],
                "model_tflops_per_s": st["model_tflops_per_s"],
                "mfu": st["mfu"], "peak_memory_bytes": st["peak_memory_bytes"],
                "device_ms_per_step": device_ms or "not measured",
                "device_ms_by_kind": kinds or "not measured",
                "attention_device_ms": attention_ms if device_ms
                else "not measured",
                "attention_share": (attention_ms / device_ms if device_ms
                                    else "not measured"),
                "annotated_device_ms": spans or "not measured",
                "moe_device_ms": moe or None,
                "kernels_per_step": n_kernels or "not measured",
                "profiled_step_ms": wall_ms,
                "device_idle_share": (1 - device_ms / wall_ms
                                      if device_ms else "not measured")}

    def kernels_line(self, timed_rows):
        """One row per kernel with every key of the contract, for the
        kernels whose rows the run measured (all of them in a whole run)."""
        pa, nm, fl = timed_rows["pa"], timed_rows["nm"], timed_rows["fl"]
        adam, gg = timed_rows["adam"], timed_rows["gg"]
        sp, ev = timed_rows["sp"], timed_rows["ev"]
        pa_src = ("cuda", "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
                  "deepspeed_tpu/ops/pallas/paged_attention.py:40")
        src = {"paged_attention_decode": pa_src,
               "paged_attention_prefill": pa_src,
               "paged_attention_plan": pa_src,
               "rms_norm": ("triton", "deepspeed_tpu_torch/ops/norms.py",
                            "deepspeed_tpu/ops/pallas/norms.py:30"),
               "layer_norm": ("triton", "deepspeed_tpu_torch/ops/norms.py",
                              "deepspeed_tpu/ops/pallas/norms.py:37")}
        flash_src = "deepspeed_tpu_torch/ops/csrc/flash_attention.cu"
        src.update({
            "flash_fwd": ("cuda", flash_src,
                          "deepspeed_tpu/ops/pallas/flash_attention.py:71"),
            "flash_bwd_dq": ("cuda", flash_src,
                             "deepspeed_tpu/ops/pallas/flash_attention.py:169"),
            "flash_bwd_dkv": ("cuda", flash_src,
                              "deepspeed_tpu/ops/pallas/flash_attention.py:214"),
            "fused_adam": ("cuda", "deepspeed_tpu_torch/ops/csrc/fused_adam.cu",
                           "deepspeed_tpu/ops/pallas/fused_adam.py:34"),
            # megablox gmm / tgmm (its VJP), reached from grouped_dot
            "gmm": ("cuda", "deepspeed_tpu_torch/ops/csrc/grouped_gemm.cu",
                    "deepspeed_tpu/moe/layer.py:185"),
            "tgmm": ("cuda", "deepspeed_tpu_torch/ops/csrc/grouped_gemm.cu",
                     "deepspeed_tpu/moe/layer.py:185"),
            # the flash kernels' bodies over the layout's active squares
            "block_sparse_fwd": ("cuda", flash_src,
                                 "deepspeed_tpu/ops/pallas/block_sparse.py:120"),
            "block_sparse_bwd_dq": (
                "cuda", flash_src,
                "deepspeed_tpu/ops/pallas/block_sparse.py:211"),
            "block_sparse_bwd_dkv": (
                "cuda", flash_src,
                "deepspeed_tpu/ops/pallas/block_sparse.py:251"),
            "evoformer_fwd": ("cuda",
                              "deepspeed_tpu_torch/ops/csrc/evoformer.cu",
                              "deepspeed_tpu/ops/pallas/evoformer.py:33"),
            "quant_int8": ("cuda",
                           "deepspeed_tpu_torch/ops/csrc/quantization.cu",
                           "deepspeed_tpu/ops/pallas/quantization.py:40"),
            "dequant_reduce": ("cuda",
                               "deepspeed_tpu_torch/ops/csrc/quantization.cu",
                               "deepspeed_tpu/ops/pallas/quantization.py:80")})
        timed = {"rms_norm": nm["rms_norm[R=8]"],
                 "layer_norm": nm["layer_norm[R=8]"]}
        if pa is not None:
            # the wrapper's call at the tick each kernel serves (CUDA events,
            # as every row); the kernel's own profiler time beside it
            for name, case in (("paged_attention_decode", "decode"),
                               ("paged_attention_prefill", "prefill")):
                timed[name] = dict(pa[case], library_ms=None,
                                   kernel_ms=pa[case]["kernel_ms"][name])
            timed["paged_attention_plan"] = dict(pa["plan"], library_ms=None)
        if adam is not None and "fused_adam" in self.errs:
            timed["fused_adam"] = dict(adam,
                                       max_abs_err=self.errs["fused_adam"])
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            if name in self.errs:
                timed[name] = dict(fl["gpt2_125m"][name],
                                   max_abs_err=self.errs[name])
        for name, key in (("gmm", "gmm[up]"), ("tgmm", "tgmm[up]")):
            if gg is not None and name in self.errs:
                timed[name] = dict(gg[key], max_abs_err=self.errs[name])
                if "moe_ep" in self.state and name == "gmm":
                    # the kernel on a rank's real received buffer (E3)
                    e3 = self.state["moe_ep"]["a"]["e3"]
                    timed[name]["ep_buffer"] = {
                        k: e3.get(k) for k in (
                            "rows", "routed_rows", "group_sizes",
                            "gmm_max_abs_err", "gmm_ms", "gmm_plain_ms")}
        for name in sp:
            if name in self.errs:
                timed[name] = dict(sp[name], max_abs_err=self.errs[name])
        if "evoformer_fwd" in self.errs:
            timed["evoformer_fwd"] = dict(
                ev["msa_row"], max_abs_err=self.errs["evoformer_fwd"])
        for name in ("quant_int8", "dequant_reduce"):
            if name in self.errs:
                timed[name] = dict(timed_rows["q8"][name],
                                   max_abs_err=self.errs[name])
        src = {k: v for k, v in src.items() if k in timed}
        out = []
        for name, (route, source, replaces) in src.items():
            t = timed[name]
            by_model = self.launches.get(name, {})
            out.append({"name": name, "route": route, "source": source,
                        "replaces": replaces,
                        "launches": sum(by_model.values()),
                        "launches_by_model": by_model,
                        "launches_per_tick": {
                            m: n / self.ticks[m] for m, n in by_model.items()
                            if self.ticks.get(m)},
                        "launches_per_step": {
                            m: n / self.steps[m] for m, n in by_model.items()
                            if self.steps.get(m)},
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
            for extra in ("sdpa_fwd_bwd_ms", "dense_flash_ms",
                          "tflops_per_s", "kernel_ms", "in_graph_kernel_ms",
                          "replica_hop", "ep_buffer"):
                if extra in t:
                    out[-1][extra] = t[extra]
        # the host library of the host-executed step (not a card kernel):
        # the same keys, beside the kernels
        return {"kernels": out,
                "host_libraries": list(self.host_rows.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import deepspeed_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the deepspeed_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    # fp32 matmuls in full fp32 (the PyTorch default, stated): the fp32
    # kernel checks compare against fp32 references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smoke = Smoke(torch, args.seed)
    t_start = time.perf_counter()
    timed = None
    for phase in phases:
        t0 = time.perf_counter()
        try:
            res = getattr(smoke, f"phase_{phase}")()
        except Exception as e:
            emit(phase, error=f"{type(e).__name__}: {e}")
            print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
            raise
        if phase == "times":
            timed = res
        emit(f"{phase}/done", seconds=time.perf_counter() - t0)
    emit("total", seconds=time.perf_counter() - t_start)
    print(smoke.card or nvidia_smi(), flush=True)
    if timed is not None:
        print(json.dumps(smoke.kernels_line(timed)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
