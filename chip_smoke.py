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
               empty group, moe_1b's width, tgmm at outputs of O(100) with
               each side's distance from the fp64 sum; sparse layouts with
               an inactive
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
7b. checkpoint_llama_750m — checkpoints on that path (CKPT): C1 one
               process at full width, CKPT["layers"] layers, steps 1-2, a
               sync save,
               steps 3-4, and a fresh engine from another seed that loads
               the tag and runs steps 3-4 bit-equal (losses; fingerprints
               of the master, both moments, the bf16 compute copy; lr and
               the step counters), its kernels counted on the resumed
               steps; C2 an async save in flight while steps run, its tag
               verified and loaded to C1's bits; C3 two ranks, ZeRO-3 +
               qgZ + qwZ + LoCo at CKPT["zero3_layers"]: a native reload at world 2
               bit-equal, the universal conversion loaded into one process
               bit-equal to the gathered leaves, LoCo folded
               sum-preservingly, the first loss equal to an engine given
               the same state directly; C4 the NVMe optimizer tier's reload
               bit-equal; C5 the 16-bit export equal to the compute
               params; each save's gather / write / fsync / CRC seconds,
               GB and GB/s, each load's with its verify, the host RSS peak
               of the save, the disk free before (three tags' size or it
               fails); the tags deleted at the end;
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
               width, ZEROPP_LAYERS of its 20 layers, with ZeRO-2 + qgZ +
               qwZ + LoCo (the repo's
               zero2_qgz_llama_750m_bf16 row: micro 4 a rank, seq 2048, gas
               ZEROPP_GAS, bf16, flash, remat full, Adam): the loss falls,
               the counters prove every step launched the int8 quantize and
               dequant-reduce kernels; four gates (the wire bit-exact on the
               step's real packed gradient; one fp32 step at
               ZEROPP_GATE_LAYERS layers all kernels vs all plain within a
               tenth of the wire's own noise; bf16 no further
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
               ZeRO-3 vs ZeRO-2 at ZERO3["gate_layers"] layers, full width,
               by the training
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
               and of hpZ ZeRO-2 against the same step at data = 4, at
               HPZ["gate_layers"] layers, by the training rule), H2 (bf16:
               the first loss
               bit-equal to data = 4's, the update no further from fp32
               than 2x), H3 (the step's real reduced shard through the
               replica hop: its quantize and dequant-reduce kernels
               bit-equal to their plain versions, the int8 two-hop mean
               within half a step a hop of the exact one), H4 (each
               group's collectives and elements a step by formula: no
               parameter gather on the data group, which carries the
               replica hop only), H5 (the launches and gathers a step);
13b. train_moe_350m_ep — moe_350m over the expert axis (MOE_EP,
               MOE_EP_B): (a) two ranks at mesh {expert: 2}, full width,
               MOE_EP_LAYERS of 12 layers, each holding 2 of the 4
               experts, the choices sent to their expert's rank by
               all-to-all; (b) four ranks at mesh {data: 2, expert: 2},
               as many layers; gates E1-E5 (the fp32 step
               by the training rule against the same ranks without the
               expert axis, and against one process; bf16 within 2x the
               plain bf16 path; the grouped GEMM on a rank's received
               buffer; the all-to-alls and the aux loss's means a step by
               formula, nothing dropped); step, tokens/s, MFU by active
               parameters, peak a rank, the expert group's host seconds,
               the idle share;
13c. train_moe_350m_ep_zero — the expert axis on every engine (MOE_EPZ):
               four ranks train moe_350m at full width, MOE_EP_LAYERS
               layers, with (b)
               exact ZeRO-2, (c) ZeRO-3, (d) ZeRO-2 + qgZ + qwZ + LoCo, (e)
               ZeRO-3 + qgZ + qwZ at {data: 2, expert: 2} and (f) hpZ
               ZeRO-3 at {zshard: 2, expert: 2}; two ranks with (g) the
               dense dispatch across experts at {expert: 2}; gates E6 (one
               fp32 step of (c) and (f) against exact ZeRO-2 by the
               training rule, bf16 within 2x ZeRO-2's), E7 (the int8
               kernels bit-equal on the step's real rows, one fp32 step
               kernels vs plain within a tenth of the wire's noise), E8
               (each group's collectives a step by formula), E9 ((g)
               against one process), E10 ((c)'s peak below (b)'s); step,
               tokens/s, MFU, peak a rank, the idle share of rank 0;
13d. train_llama_750m_sp2 — sequence parallelism (SP2): two ranks train
               llama_750m at full width, SP2_LAYERS layers, at mesh {seq:
               2} (each
               1,024 positions of the same 4 rows) with (a) Ulysses around
               the flash kernels and (b) the K/V ring, four ranks with (c)
               Ulysses at {data: 2, seq: 2}; gates SP1-SP2 and SP1c (one
               fp32 step against one process with flash by the training
               rule), SP3 (bf16 within 2x the plain bf16 path), SP4 (the
               flash launches at the head-sharded shape and the seq
               group's all-to-alls / permutes a step by formula), SP5 (a
               rank's forward-backward peak below one process's), SP6
               (FPDT with K/V in pinned host memory against chunked
               attention, its device peak lower); step, tokens/s, MFU,
               peak a rank, rank 0's idle share, the seq group's host
               seconds;
13e. train_llama_750m_tp2 — tensor parallelism (TP2): llama_750m at full
               width, TP2_LAYERS layers, (a) two ranks at {tensor: 2} with ZeRO-1
               (each 6 of the 12 heads, half the FFN and the vocab), (b)
               four at {data: 2, tensor: 2} with ZeRO-3 exact; gates TP1
               (one fp32 step of each way against one process with flash
               by the training rule), TP2 (bf16 (a): the loss within 1e-5
               of one process's, the update within 2x the plain bf16
               path's), TP3 (the tensor group's all-reduces and elements
               and the kernels' launches a step by formula, the flash
               kernels at a rank's heads), TP4 (each rank's parameters
               and master the reckoned TP-local sizes, its forward-backward
               peak below one process's); step, tokens/s, MFU, peak a rank,
               rank 0's idle share, the tensor group's host seconds;
13f. llama2_7b_tp2 — FastGen at {tensor: 2} (TP7B): two ranks serve
               llama2_7b at full width, TP7B_LAYERS of its 32 layers
               (each 16 of the 32 heads and KV
               heads, half the FFN and the vocab) with eager ticks on the
               paged kernels, the llama2_7b phase's requests; gates T1 (a
               mixed tick's logits against the one-process plain path's:
               fp32 top-1 and relative error, bf16 within 2x the
               one-process bf16 engine's), T2 (the ranks' tokens equal),
               T3 (the tensor group's calls a tick: 2L + 1 all-reduces and
               the logits' gather); decode tokens/s, TTFT p50, rank 0's
               idle share; spawned in the world-2 spawn, before the serving
               phases' engines take the card;
13g. train_llama_750m_pp2 — pipeline parallelism (PP2): llama_750m at
               full width, 1F1B with M = 4 pipeline micro-batches of 1 x
               2048 tokens, gas 2, ZeRO-1: (a) two ranks at {pipe: 2},
               PP2_LAYERS layers (PP2_LAYERS / 2 a stage), (b) four at
               {pipe: 2, tensor: 2}, PP2_GATE_LAYERS layers; gates PP1 (one
               fp32 step of each way at PP2_GATE_LAYERS layers against one
               process with flash and the
               exact loss: loss 1e-6, norm and gradient 1e-5), PP2 (bf16
               (a): the first loss within 2x the plain bf16 path's distance
               of one process's bf16 loss), PP3 (a rank's launches and the
               stage hops a step by formula: M·gas activations and
               cotangents), PP4 (the stage-local parameters; 1F1B's peak
               at M = 8 within 1.15x of M = 4's, GPipe's beside); step,
               tokens/s, MFU, peak a rank, rank 0's idle share, the bubble
               (formula and measured), the pipe group's host seconds;
13h. train_llama_750m_pp_compose — the pipe axis composed (PPC): full
               width, PPC_LAYERS layers (PPC_LAYERS / 2 a stage), 1F1B with M = 4
               pipeline micro-batches of 1 row a batch rank, gas 2, bf16
               with an fp32 master; (a) llama_750m at {pipe: 2, data: 2},
               ZeRO-3 (gathered by the chunks of the stage's layers) beside
               ZeRO-2: PC1 (one fp32 step against ZeRO-2's by the training
               rule), PC2 (bf16 loss within 1e-5 of ZeRO-2's, update within
               2x ZeRO-2's from fp32), PC3 (the gathers and reduces a step
               by formula), PC4 (the peak a rank below ZeRO-2's by 0.75 of
               the reckoned margin); (b) {pipe: 2, seq: 2} with
               ulysses_flash: PC5 (one fp32 step against the same rows at
               {pipe: 2, data: 2} with flash), the seq group's all-to-alls
               by formula; (c) moe_350m at {pipe: 2, expert: 2}: PC6 (one
               fp32 step against {pipe: 2, data: 2} on the same rows,
               routing agreement >= 1 - 1e-4, aux within 1e-5), the grouped
               GEMM on a rank's received buffer against its plain version;
               (d) two ranks at {pipe: 2}, ZeRO-1 with offload_optimizer
               cpu: PC7 (losses and the master's and moments' fingerprints
               bit-equal to no offload); each way's step, tokens/s, MFU,
               peak a rank, rank 0's idle share, the pipe, seq and expert
               groups' host seconds; (a)-(c) in the world-4 spawn, (d) in
               the world-2 spawn;
13i. train_sp_tp_moe_compose — the seq axis composed and MoE under
               tensor (STM): full width, STM_LAYERS layers, bf16 with an
               fp32 master, remat full, gas 2; (a) llama_750m hpZ ZeRO-3
               at {zshard: 2, seq: 2} with Ulysses around flash: SC1 (one
               fp32 step against ZeRO-3 at {data: 2, seq: 2} by the
               training rule), SC2 (each group's collectives by formula);
               (b) moe_350m at {expert: 2, seq: 2}: SC3 (against {data: 2,
               expert: 2} on the same rows: training rule, routes over the
               global batch ≥ 1 − 1e-4, aux 1e-5), the expert and seq
               all-to-alls by formula, the grouped GEMM on a received
               buffer; (c) llama_750m at {seq: 2} with the sync host step:
               SC4 (loss bit-equal, master within 1e-6 of the device
               step's, the card's peak while the engine is built 12 bytes
               an element of the master below the device step's); (d)
               moe_350m at {expert: 2, tensor: 2}: SC5 (as SC3, the tensor
               group's all-reduces by formula), SC6 (the grouped GEMM over
               a rank's [2, 768, 1536] slice, the peak a rank below
               (e)'s); (e) moe_350m at {expert: 2}; (a), (b), (d) in the
               world-4 spawn, (c), (e) in the world-2 spawn;
14. quantized_reduce_scatter — the entry point at world 2 and 4 (ranks on
               the one card), 2^26 fp32 a rank: kernels vs plain bit-equal,
               the error against the exact mean within the bound, the ranks'
               chunks concatenating to the whole reduction;
15. train_llama2_7b_super_offload — the host's facts (MemAvailable, cores,
               threads, the NVMe directory's disk), then llama2_7b at full
               width under SuperOffload (the fp32 master and Adam's moments
               in host memory, the update on the host's cores; bf16, flash,
               remat full, micro 2, seq 2048, gas 4) at the depth the
               host's memory holds, at most SUPER["max_layers"]: gates S1
               (one fp32 host step, overlap
               off, against the device path: loss bit-equal, master within
               1e-6), S2 (bf16: the update no further from S1's than 2x
               the device bf16 step's), S3 (the overlap schedule's losses)
               at SUPER["gate_layers"] layers; then 3 steps with overlap
               and 2 without, the
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
               2 steps) and its kernels-vs-plain step at
               OFFLOAD["gate_layers"] layers by the training rule, (d)
               ZeRO-3 at world 1 on a spawned rank with
               offload_param cpu and nvme at OFFLOAD["param_layers"]
               layers in JAX's in-step
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
    python3 chip_smoke.py --phases card,build,train_moe_350m_ep_zero
    python3 chip_smoke.py --phases card,build,kernels,llama2_7b,gpt2_125m,times
    python3 chip_smoke.py --phases card,build,train_llama2_7b_super_offload,train_llama_750m_offload
    python3 chip_smoke.py --phases card,build,checkpoint_llama_750m
    python3 chip_smoke.py --phases card,build,kernels,train_llama_750m_sp2
    python3 chip_smoke.py --phases card,build,kernels,train_llama_750m_tp2,llama2_7b_tp2
    python3 chip_smoke.py --phases card,build,kernels,train_llama_750m_pp2
    python3 chip_smoke.py --phases card,build,kernels,train_llama_750m_pp_compose
    python3 chip_smoke.py --phases card,build,kernels,train_sp_tp_moe_compose

The whole run takes the phases in PHASES order: the data-parallel phases
(11-14, 13b-13i among them) and the offload phases (15-16) run right after
the kernels phase, before the serving phases' engines take the card.
Their ranks run in one spawn a world size (MERGED_SPAWNS: the first of
them prepares every selected phase's jobs of its world, the checkpoint
phase's C3 and the offload phase's int8 ranks among them, and each phase
then checks its own results). Wire times of the data-parallel phases are
gloo's through host memory, the ranks sharing one card: not NVLink's.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
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
import typing

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
# The data-parallel phases run before the serving phases, whose engines
# the parent holds until `times` (~23 GB beside two ranks' engines did not
# fit 80 GB); so do the offload phases (llama2_7b under SuperOffload needs
# the empty card).
PHASES = ("card", "build", "kernels", "train_llama_750m_zeropp_dp2",
          "train_llama_750m_zero3_dp2", "train_llama_750m_hpz_dp4",
          "train_moe_350m_ep", "train_moe_350m_ep_zero",
          "train_llama_750m_sp2", "train_llama_750m_tp2",
          "train_llama_750m_pp2", "train_llama_750m_pp_compose",
          "train_sp_tp_moe_compose",
          "quantized_reduce_scatter", "train_llama2_7b_super_offload",
          "train_llama_750m_offload", "llama2_7b_tp2", "llama2_7b",
          "gpt2_125m", "moe_350m", "train_gpt2_125m",
          "train_llama_750m", "checkpoint_llama_750m", "train_moe_350m",
          "train_llama_750m_sparse",
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
               ("full_d128_unaligned", 1, 300, 4, 2, 128, False),
               # Ulysses' head-sharded blocks on train_llama_750m_sp2: ways
               # (a)-(b) at {seq: 2}, way (c) at {data: 2, seq: 2}; the
               # same shapes are a tensor rank's heads on
               # train_llama_750m_tp2: way (a) at {tensor: 2}, way (b) at
               # {data: 2, tensor: 2}
               ("llama_750m_ulysses", 4, 2048, 6, 6, 128, True),
               ("llama_750m_ulysses_d2", 2, 2048, 6, 6, 128, True),
               # a pipeline micro-batch (1 row) on train_llama_750m_pp2:
               # way (a) at {pipe: 2}, way (b) at a tensor rank's heads
               ("llama_750m_pp", 1, 2048, 12, 12, 128, True),
               ("llama_750m_pp_t2", 1, 2048, 6, 6, 128, True))
# Grouped GEMM against its plain version: both sum exact products in fp32,
# over up to K = 3072 terms (gmm) and a whole group's rows (tgmm, ~16k: the
# kernel in chunks of 1024 rows, then the chunk sums), in other orders, so
# fp32 gets flash attention's 1e-4 on outputs of O(1) (the inputs are
# scaled so); bf16 adds one rounding of the output (2^-7).
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
# super_offload; llama_750m's H 1536 is a masked BLOCK_H 2048 program; 2048
# rows a pipeline micro-batch on train_llama_750m_pp2)
NORM_CASES = (("rms_norm", 4096, (1, 37, 256, 4096)),
              ("rms_norm", 1536, (8192, 2048)),
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
# contexts of MB * bs = 2048; the mixed tick at a tensor rank's heads of
# llama2_7b (N = K = 16 of 32, llama2_7b_tp2's tick). fp32 outputs and the
# bf16 decode rows (fp32 P)
# are held at TOL; the bf16 prefill rows (P rounded to bf16 for the tensor
# cores) by FLASH_BF16_RULE.
PA_TICKS = tuple(
    [(f"run{n}", f"run{n}", 32, 32, 128, 32, 16) for n in (1, 63, 64, 65, 256)]
    + [("mixed", "mixed", 32, 32, 128, 32, 16),
       ("mixed_tp2", "mixed", 16, 16, 128, 32, 16),
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
# "model" names the preset where the run's key does not. gate_micro: the
# rows of the step gate. moe_350m's gate takes the main path's whole
# micro-batch (2 rows before the pipeline phase came): over 2 rows its bf16
# loss distance is set by routing flips at near-ties (0.3-0.4 % of the
# (token, choice) pairs on each bf16 path, each moving one token's loss),
# not by the paths' arithmetic. From one trained master (tools/
# probe_moe_gate.py, NVIDIA H100 80GB HBM3, 700.00 W), the kernel path's
# distance was 0.71-3.33x the plain path's over the batch's 8 slices of 2
# rows, and the two equal (1.797e-6) over all 16.
TRAIN = {"gpt2_125m": dict(micro=32, seq=1024, gas=4, steps=4,
                           norm="layer_norm", gate_micro=2),
         "llama_750m": dict(micro=4, seq=2048, gas=4, steps=3,
                            norm="rms_norm", gate_micro=1),
         "moe_350m": dict(micro=16, seq=1024, gas=4, steps=3,
                          norm="layer_norm", gate_micro=16),
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
# llama_750m's 28,311,552 elements a layer, 17 layers a chunk, so at
# ZEROPP_LAYERS one chunk, which publishes as one group of every leaf (at
# all 20 layers two chunks of 10 and three groups: the head group, then
# each chunk). Per rank and step
# the design launches quantize gas + groups times (each micro-batch's qgZ
# send, the publish's groups) and dequant-reduce 2 gas + groups times
# (each micro-batch's receive and LoCo's dequantized send, the publish's
# groups).
ZEROPP = dict(model="llama_750m", world=2, micro=4, seq=2048, gas=4, steps=2,
              gate_micro=1)
# the phase's main path runs this many of llama_750m's 20 layers, full
# width (all 20 until the pipeline phase came: with it the whole script
# took 1,016.9 s on an H100 and was stopped past 1,200 s on another)
ZEROPP_LAYERS = 4
ZEROPP_CHUNKS = [[0, ZEROPP_LAYERS]]
# the phase's main-path runs take one timed step after the warm-up (2
# before the checkpoint phase came) of ZEROPP_GAS micro-batches (4 before
# the expert-axis phase train_moe_350m_ep_zero came): the cuts that keep
# the whole script within its time beside them; depth and width stay full
ZEROPP_STEPS = 1
ZEROPP_GAS = 2
# the phase's gate steps (gates 2-3 and the overlap gate) run this many
# layers at full width from the seed's initial weights (the main path's
# trained master at all 20 before the expert-axis phase came, 4 before
# the pipeline phase came), as the ZeRO-3 and hpZ gates do
ZEROPP_GATE_LAYERS = 2
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
# stage3_prefetch_bucket_size 5e7: JAX's plan of min(layers, 8) layer
# chunks (at all 20 layers even_chunk_bounds(20, 8): 3, 3, 3, 3, 2, 2, 2,
# 2 layers; at ZERO3_LAYERS one layer each). Run (a) exact ZeRO-3, (b)
# ZeRO-3 + qgZ + qwZ + LoCo, (c) exact ZeRO-2 at the same depth; 1 warm-up
# + ZERO3_STEPS steps each, at gas ZEROPP_GAS (the row's 4 before the
# pipeline phase came: the cut that keeps the whole script within its
# time; hpZ's phase takes it too). The gate steps Z1-Z2 run the model cut
# to ZERO3["gate_layers"] layers at full width (gas 1, micro 1 a rank).
ZERO3 = dict(ZEROPP, gas=ZEROPP_GAS, gate_layers=ZEROPP_GATE_LAYERS)
ZERO3_EXACT = {"stage": 3}
ZERO3_WIRE = dict(ZEROPP_WIRE, stage=3)
ZERO3_CHUNKS = 8
# the phase's main path runs this many of llama_750m's 20 layers (width
# unchanged; JAX's plan cuts them into min(layers, 8) chunks, one layer
# each here) and one timed step after the warm-up: the cuts that keep the
# whole script within its time beside the expert-parallel and checkpoint
# phases (10 layers and 2 steps before the checkpoint phase came, 4
# layers before the pipeline phase came). Its
# exact ZeRO-2 baseline runs in this phase at the same depth; the gates
# keep their own depth.
ZERO3_LAYERS = 2
ZERO3_STEPS = 1
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
# unchanged) and one timed step after the warm-up (8 layers and 2 steps
# before the checkpoint phase came, 4 layers before the pipeline phase
# came): the cuts that keep the whole script within its time; the gates
# keep their own depth
HPZ_LAYERS = 2
HPZ_STEPS = 1
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

# The checkpoint phase (checkpoint_llama_750m), on the train_llama_750m
# path's shapes (micro 4, seq 2048, gas 4, bf16, ZeRO-1, flash, remat
# full): C1 one process at full width, CKPT["layers"] layers — steps 1-2,
# a sync save,
# steps 3-4; a fresh engine from another seed loads the tag and runs steps
# 3-4 bit-equal (losses, fingerprints of the master, both moments and the
# bf16 compute copy, lr and counters), the kernels counted on the resumed
# steps; C2 an async save of the same state: it returns while the write is
# in flight, steps run beside it, and after finalize_async the tag
# verifies and loads to C1's bits; C3 two ranks over gloo, ZeRO-3 + qgZ +
# qwZ + LoCo at ZERO3_LAYERS: a native reload at world 2 continues
# bit-equal, and the port's universal conversion of the tag loaded into a
# one-process engine gives the gathered master and moments bit for bit,
# each LoCo leaf's rows folded sum-preservingly, and the first loss of an
# engine given the same master and moments directly; C4 the NVMe
# optimizer tier (750m offload (b) at CKPT["nvme_layers"] layers): a load
# after two more steps, then those two steps again bit-equal; C5 the
# 16-bit export bit-equal to the compute params. Tags live under
# build/checkpoints/ (ignored by git) and are deleted at the end.
# C1-C2 run CKPT["layers"] of llama_750m's 20 layers and C3
# CKPT["zero3_layers"] (20 and ZERO3_LAYERS before the expert-axis phase
# train_moe_350m_ep_zero came, C1-C2 and C4 at 8 before the pipeline phase
# came: the cuts that keep the whole script within its time)
CKPT = dict(model="llama_750m", micro=4, seq=2048, gas=4, layers=4,
            zero3_layers=2, nvme_layers=4)
# the disk under build/checkpoints/ must hold this many tags of C1's size
# (12 bytes a parameter: the fp32 master and Adam's two moments)
CKPT_TAGS_FREE = 3


def ckpt_root():
    """The phase's checkpoint root: ``DSTPU_CHECKPOINT_PATH``, else
    ``build/checkpoints`` in the checkout (the machine's local disk)."""
    return os.environ.get("DSTPU_CHECKPOINT_PATH") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "checkpoints")


def fingerprint(t, chunk=2 ** 26) -> str:
    """A tensor's 32-bit words summed twice on its own device, plain and
    weighted by (position mod 2^31 - 1) + 1, each sum wrapping in int64:
    any changed word changes it. (A hash of the bytes on the host would
    read 10 GB a state.)"""
    import torch

    w = t.detach().reshape(-1)
    if w.element_size() != 4:
        w = w.view(torch.int16)
        w = torch.cat([w, w.new_zeros(w.numel() % 2)]).view(torch.int32)
    else:
        w = w.view(torch.int32)
    s1 = torch.zeros((), dtype=torch.int64, device=w.device)
    s2 = torch.zeros((), dtype=torch.int64, device=w.device)
    for lo in range(0, w.numel(), chunk):
        c = w[lo:lo + chunk].to(torch.int64)
        idx = torch.arange(lo, lo + c.numel(), dtype=torch.int64,
                           device=w.device) % 2147483647 + 1
        s1 += c.sum()
        s2 += (c * idx).sum()
    mask = (1 << 64) - 1
    return f"{int(s1) & mask:016x}{int(s2) & mask:016x}"


def state_fingerprints(engine):
    """The engine's local master, moments, compute copy and LoCo rows."""
    engine._tiers_in()
    out = {"master": fingerprint(engine.flat_master)}
    for k in engine._opt_names():
        out[k] = fingerprint(engine.state["opt"][k])
    out["opt_step"] = int(engine.state["opt"]["step"])
    for name in ("flat_compute", "loco_err"):
        t = getattr(engine, name, None)
        if t is not None:
            out[name] = fingerprint(t)
    engine._tiers_out()
    return out


class RssPeak:
    """The process's resident set, sampled every ``period`` seconds by a
    thread while the block runs: its peak in bytes."""

    def __init__(self, period=0.02):
        self.period, self.peak, self._stop = period, 0, False

    @staticmethod
    def rss():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _run(self):
        while not self._stop:
            self.peak = max(self.peak, self.rss())
            time.sleep(self.period)

    def __enter__(self):
        import threading

        self.before = self.rss()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop = True
        self._t.join()
        self.peak = max(self.peak, self.rss())


def ckpt_rates(save=None, load=None):
    """A save's seconds by part with its GB and GB/s, or a load's."""
    out = {}
    if save is not None:
        gb = save.get("bytes", 0) / 1e9
        out.update({k: save.get(k) for k in ("seconds", "gather_s", "write_s",
                                             "fsync_s", "crc_s")},
                   gb_written=gb,
                   write_gbs=gb / save["write_s"] if save.get("write_s")
                   else None,
                   save_gbs=gb / save["seconds"] if save.get("seconds")
                   else None)
    if load is not None:
        gb = load.get("bytes", 0) / 1e9
        out.update(load_seconds=load["seconds"], verify_s=load["verify_s"],
                   gb_read=gb, load_gbs=gb / load["seconds"])
    return out


def checkpoint_zero3_rank(rank, world, seed, t):
    """C3 on one rank: ZeRO-3 + qgZ + qwZ + LoCo at ``t["zero3_layers"]``:
    a warm-up step, a save, steps 2-3; a fresh engine from another seed
    loads the tag and runs steps 2-3. Returns the losses,
    the local state's fingerprints after each run, and the save's and
    the load's timings."""
    import itertools

    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import transformer as T

    dev = torch.device(t["device"])
    depth = {"num_layers": t["zero3_layers"]}
    vocab = T.get_model_config(t["model"]).vocab_size
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (t["micro"] * world, t["seq"]),
                                    dtype=np.int32)}

    def build(s):
        spec = dtt.causal_lm_spec(t["model"], attention="flash",
                                  remat="full", **depth)
        cfg = zeropp_config(t["micro"], t["gas"], "bf16", ZERO3_WIRE)
        cfg["seed"] = s
        return dtt.initialize(model=spec, config=cfg, device=dev)[0]

    out = {"rank": rank}
    engine = build(seed)
    data = itertools.repeat(batch)
    out["losses"] = [float(engine.train_batch(data))]
    engine.save_checkpoint(t["root"], tag="c3")
    out["save"] = dict(engine.checkpoint_timings["save"])
    out["losses"] += [float(engine.train_batch(data)) for _ in range(2)]
    out["wire"] = engine._wire_format()
    out["want"] = state_fingerprints(engine)
    engine.close()
    del engine
    dev_free(dev)
    fresh = build(seed + 1)
    fresh.load_checkpoint(t["root"], tag="c3")
    out["load"] = dict(fresh.checkpoint_timings["load"])
    out["resumed_steps"] = fresh.global_steps
    out["resumed"] = [float(fresh.train_batch(data)) for _ in range(2)]
    out["got"] = state_fingerprints(fresh)
    out["type"] = type(fresh).__name__
    fresh.close()
    del fresh
    dev_free(dev)
    return out


# The seconds a spawned rank spends in its main helpers (each call's whole
# time, helpers called inside it included), by job: ``jobs_rank`` clears it
# before each job and keeps it in JOB_PARTS, which the rank sends to the
# parent with its fixed costs (the spawn line's "parts", rank 0's).
PART_SECONDS: dict = {}
JOB_PARTS: dict = {}


def timed_part(fn):
    """``fn`` with its calls and seconds added to PART_SECONDS."""
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            calls, sec = PART_SECONDS.get(fn.__name__, (0, 0.0))
            PART_SECONDS[fn.__name__] = (calls + 1,
                                         sec + time.perf_counter() - t0)
    return timed


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
    """Yields a list that receives every routed MoE layer's (routes, aux
    loss), detached, while the block runs: the ragged dispatch's experts
    [T, k], or the dense dispatch's kept choices [T, E] (a token's
    dispatch to an expert within its capacity). The layer's gates are
    wrapped for the block's duration and restored after."""
    from deepspeed_tpu_torch.moe import layer as MoE

    gate, dense, routes = MoE._gate_indices, MoE.topk_gating, []

    def recording_gate(*args, **kwargs):
        out = gate(*args, **kwargs)
        routes.append((out.experts.detach(), out.aux_loss.detach()))
        return out

    def recording_dense(*args, **kwargs):
        out = dense(*args, **kwargs)
        routes.append((out.dispatch.detach().any(dim=-1),
                       out.aux_loss.detach()))
        return out

    MoE._gate_indices, MoE.topk_gating = recording_gate, recording_dense
    try:
        yield routes
    finally:
        MoE._gate_indices, MoE.topk_gating = gate, dense


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
    fixed = {"entered": time.time()}
    try:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import torch

        fixed["torch_imported"] = time.time()
        if not torch.cuda.is_available():
            torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if torch.cuda.is_available():
            torch.cuda.set_device(0)
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        fixed["cuda_context"] = time.time()
        import deepspeed_tpu_torch as dtt

        fixed["port_imported"] = time.time()
        dtt.init_distributed(dist_backend="gloo", init_method=init_method,
                             rank=rank, world_size=world,
                             timeout=PG_TIMEOUT_S, verbose=False)
        fixed["group_joined"] = time.time()
        builds = []
        real_init = dtt.initialize

        def timed_init(*a, **k):
            t0 = time.time()
            res = real_init(*a, **k)
            builds.append(time.time() - t0)
            return res

        dtt.initialize = timed_init
        try:
            result = globals()[fn_name](rank, world, *args)
        finally:
            dtt.initialize = real_init
        fixed["returned"] = time.time()
        fixed["engine_builds_s"] = builds
        fixed["parts"] = dict(JOB_PARTS) or {fn_name: dict(PART_SECONDS)}
        dtt.comm.destroy_process_group()
        out.put((rank, "ok", result, fixed))
    except Exception:                                   # noqa: BLE001
        out.put((rank, "error", traceback.format_exc(), fixed))
    # the result flushed to the parent, the process ends at once: freeing
    # a rank's pinned staging buffers and engines one by one took 2-22 s a
    # spawn (spawn_costs' teardown_s); the process's exit frees them whole
    out.close()
    out.join_thread()
    os._exit(0)


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
    spawned = time.time()
    for p in procs:
        p.start()
    results, errors, fixed = {}, [], {}
    deadline = time.time() + RANKS_TIMEOUT_S
    try:
        while len(results) < world and not errors:
            try:
                rank, status, value, fixed[rank] = out.get(
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
    emit("spawn", **spawn_costs(fn_name, world, spawned, fixed, time.time()))
    return [results[r] for r in range(world)]

# The data-parallel phases whose ranks share a spawn, by world size: a
# spawn's fixed cost (process start, torch's import, the CUDA context, the
# group) is 9-12 s and its teardown 1.5-7 s (the spawn lines of the chip
# run that measured them), paid once a world instead of once a phase.
MERGED_SPAWNS = {
    2: ("train_llama_750m_zeropp_dp2", "train_llama_750m_zero3_dp2",
        "train_llama_750m_sp2", "train_llama_750m_tp2",
        "train_llama_750m_pp2", "train_llama_750m_pp_compose",
        "train_sp_tp_moe_compose",
        "train_moe_350m_ep", "train_moe_350m_ep_zero",
        "quantized_reduce_scatter",
        "train_llama_750m_offload", "checkpoint_llama_750m",
        "llama2_7b_tp2"),
    4: ("train_llama_750m_hpz_dp4", "train_moe_350m_ep",
        "train_moe_350m_ep_zero", "train_llama_750m_sp2",
        "train_llama_750m_tp2", "train_llama_750m_pp2",
        "train_llama_750m_pp_compose", "train_sp_tp_moe_compose",
        "quantized_reduce_scatter")}


class Job(typing.NamedTuple):
    """One rank function's run in a spawn: ``fn(rank, world, seed,
    args)``, its results kept under ``key``."""
    key: str
    fn: str
    world: int
    args: dict


def jobs_rank(rank, world, seed, jobs):
    """Several phases' rank functions in turn in one spawn: {key: (result,
    seconds)}; what a job's engines held is returned to the card before
    the next starts."""
    import torch

    out = {}
    for key, fn, args in jobs:
        PART_SECONDS.clear()
        t0 = time.perf_counter()
        out[key] = (globals()[fn](rank, world, seed, args),
                    time.perf_counter() - t0)
        JOB_PARTS[key] = dict(PART_SECONDS)
        # the job's pinned staging buffers (sized by its model) go too
        comm_mod = sys.modules.get("deepspeed_tpu_torch.comm.comm")
        if comm_mod is not None:
            comm_mod.settle()
            comm_mod._pinned.clear()
        dev_free(torch.device(args.get("device", "cpu")))
    return out


def spawn_costs(fn_name, world, spawned, fixed, joined):
    """A spawn's fixed costs from its ranks' wall-clock marks (the slowest
    rank's): process start to the rank's entry, importing torch, the CUDA
    context, importing the port, joining the group, each engine build,
    and from the last rank's return to every process joined; rank 0's
    seconds in its helpers by job (PART_SECONDS)."""
    def worst(a, b):
        return max(f[b] - (spawned if a is None else f[a])
                   for f in fixed.values())

    return {"fn": fn_name, "world": world,
            "process_start_s": worst(None, "entered"),
            "import_torch_s": worst("entered", "torch_imported"),
            "cuda_context_s": worst("torch_imported", "cuda_context"),
            "import_port_s": worst("cuda_context", "port_imported"),
            "join_group_s": worst("port_imported", "group_joined"),
            "to_fn_start_s": worst(None, "group_joined"),
            "engine_builds_s": [max(b) for b in zip(*(
                f["engine_builds_s"] for f in fixed.values()))],
            "run_s": worst("group_joined", "returned"),
            "teardown_s": joined - max(f["returned"]
                                       for f in fixed.values()),
            "wall_s": joined - spawned,
            "parts": fixed[min(fixed)].get("parts")}


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


@timed_part
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
                              **depth, **t.get("spec", {}))
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


def profile_window(eng, n_ticks, dev):
    """One decode_steps window of ``n_ticks`` under torch.profiler:
    device ms, kernels and the host's CUDA runtime calls a tick, and
    the device's idle gaps between its first and last kernel (with
    graphs: the gaps between nodes and between replays)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = eng.decode_steps(n_ticks)
        dev_sync(dev)
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


@timed_part
def zeropp_profile(engine, data, dev, profiled):
    """One more step; on rank 0 under torch.profiler: device time by kind
    (compute kernels, the two int8 kernels), the host time of the wire
    stages (telemetry spans: gloo through host memory), and the idle
    share. It traces the card's activity only (no host ops, so no spans'
    device time): a step of many small ops processes in a fraction of the
    time (1F1B's ticks took ~14 s with the host ops, 20 layers, on an
    H100)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch import telemetry

    telemetry.reset()
    # a rehearsal without a card traces the host
    acts = ([ProfilerActivity.CPU] if dev.type != "cuda" else []) \
        + [ProfilerActivity.CUDA]
    ctx = profile(activities=acts) if profiled else contextlib.nullcontext()
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
    kinds = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0)
                   or getattr(e, "self_cuda_time_total", 0))
        if e.key in spans or getattr(e, "is_user_annotation", False) \
                or not us:
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
            "host_span_ms": host_ms,
            "wire_host_ms_gloo": sum(host_ms[k] for k in (
                "qgz_all_to_all", "qwz_publish", "zero_reduce_issue",
                "zero_reduce_wait")),
            "device_idle_share": (1 - device_ms / wall_ms if device_ms
                                  else "not measured")}


@timed_part
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

    from deepspeed_tpu_torch.parallel import stage3 as S3

    W, B, grp = engine.shard_world, QK.DEFAULT_BLOCK, engine.shard_group
    mb = engine._to_device(engine._local_rows(stack_micros([batch])))
    mb = {k: v[0] for k, v in mb.items()}
    with engine._step_buffers():        # ZeRO-3: the step's full gradient
        with engine._moe_axes():
            engine._loss_and_grads(mb, None)
        engine._pack()
        x = engine._packed
        if engine.ep > 1:
            # the rows as the wire sends them: the dense rows summed over
            # the expert group, the expert leaves in JAX's blocks
            engine._expert_sum()
            x = S3.to_wire(engine, engine._wire_group,
                           x[:, :engine._n_sh]).contiguous()
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
    qa = comm.all_to_all_single(q.view(W, -1), grp)
    sa = comm.all_to_all_single(sc.view(W, -1), grp)
    del q, sc
    red = QK.dequant_reduce(qa, sa, mean=True)
    for i in range(0, red.numel(), step):
        red_equal &= same_bits(red[i:i + step], QK.dequant_reduce_ref(
            qa[:, i:i + step].contiguous(),
            sa[:, i // B:(i + step) // B].contiguous(), mean=True))
    xa = comm.all_to_all_single(x, grp)
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


@timed_part
def zeropp_gate_step(t, dev, master, batch, zero, precision, kernels):
    """One step (the gate's micro, ``t["gate_layers"]`` layers when set;
    ``batch`` one micro-batch, or a list of them: gas their number) from
    ``master`` (None: the seed's initial weights, the same in every gate
    engine) on this rank: (sharded elements, loss, reduced gradient,
    update) — the gradient's and update's local buffers stay on the
    device."""
    batches = batch if isinstance(batch, list) else [batch]
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import load_master

    depth = ({"num_layers": t["gate_layers"]} if t.get("gate_layers")
             else {})
    spec = dtt.causal_lm_spec(
        t["model"], attention="flash", remat="full", use_kernels=kernels,
        dtype="float32" if precision == "fp32" else "bfloat16", **depth)
    with (contextlib.nullcontext() if kernels else plain_wire()):
        engine, *_ = dtt.initialize(model=spec, config=zeropp_config(
            t["gate_micro"], len(batches), precision, zero), device=dev)
        if master is not None:
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
    # the gates' master: the main path's, or the seed's at gate depth
    master = None if t.get("gate_layers") else engine.full_master()
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


@timed_part
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


@timed_part
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


@timed_part
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


@timed_part
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


@timed_part
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


@timed_part
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
# (a) mesh {expert: 2} at world 2, MOE_EP_LAYERS of its 12 layers at full
# width: micro 8 a rank (the
# one-process cell's micro 16 in all), seq 1024, gas 1, 1 warm-up + 1
# step (gas 2 and 2 steps before the expert-axis phase
# train_moe_350m_ep_zero came: the cut that keeps the whole script within
# its time); each rank holds 2 of the 4 experts, the choices travel by
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
              seq=1024, gas=1, steps=1, gate_micro=1)
# the phase runs (a) and (b) at this many of moe_350m's 12 layers, full
# width ((a) at all 12 before the checkpoint phase came, both at 4 before
# the pipeline phase came): the cut that keeps the whole script within its
# time beside them
MOE_EP_LAYERS = 2
MOE_EP_B = dict(MOE_EP, world=4, mesh={"data": 2, "expert": 2}, micro=4,
                gas=1, layers=MOE_EP_LAYERS)
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
        dtype="float32" if precision == "fp32" else "bfloat16", **depth,
        **t.get("spec", {}))


@timed_part
def moe_ep_step(engine, tokens, L, dev):
    """One step of ``engine`` on ``tokens`` (or a batch dict) → loss, grad
    norm, the whole gradient and update as flat fp32 vectors (every leaf,
    sorted keys), the routes [L, rows, k] of this process's rows and the
    summed aux (None, None for a dense model: ``L`` 0)."""
    import torch

    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    before = engine.flat_master.clone()
    with recorded_routes() as routes, recorded_aux() as auxes:
        loss = float(engine.train_batch(iter([batch])))
    norm = engine.get_global_grad_norm()
    if hasattr(engine, "full_tree"):
        grad = _flat_tree(engine.full_tree(engine.flat_grad_acc, dev))
        upd = _flat_tree(engine.full_tree(engine.flat_master - before, dev))
    else:
        grad = _flat_tree(engine._views(engine.flat_grad_acc))
        upd = _flat_tree(engine._views(engine.flat_master - before))
    del before
    if not L:
        return loss, norm, grad, upd, None, None
    idx = torch.stack([r[0] for r in routes[:L]])
    aux = float(sum(float(a) for a in auxes[:L]))
    return loss, norm, grad, upd, idx, aux


def step_metrics(loss, norm, grad, upd, idx, aux, ref):
    """The training rule's metrics of one step against ``ref`` (the same
    keys; ``idx`` may be a slice of the reference's rows: ``ref_idx``; a
    dense model's ``idx`` and ``aux`` None: no routing or aux metric)."""
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
           "sign_miss": float(miss.sum() / nz.sum().clamp(min=1))}
    if idx is None:
        return out
    out["aux_rel"] = abs(aux - ref["aux"]) / abs(ref["aux"])
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


@timed_part
def moe_ep_gates(t, dev, ref, bf16=True, ways=("ep32", "dp32")):
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
    meshes = {"ep32": ("fp32", t["mesh"]), "dp32": ("fp32", {"data": world}),
              "ep16": ("bf16", t["mesh"])}
    ways = [(w,) + meshes[w] for w in ways + (("ep16",) if bf16 else ())]
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
        config = zeropp_config(t["gate_micro"], 1, prec,
                               t.get("zero", MOE_EP_ZERO))
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
    if "dp32" in kept:
        res["fp32"] = metrics(args, kept.pop("dp32"))
    res["fp32_one_process"] = metrics(args, one)
    if ep32["idx"].dtype == torch.bool:
        # the dense dispatch's kept choices over every rank's rows
        n = torch.tensor([float(ep32["idx"].sum())], dtype=torch.float64,
                         device=dev)
        comm.all_reduce(n)
        res["fp32_one_process"].update(kept=int(n),
                                       ref_kept=int(one["idx"].sum()))
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


@timed_part
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
        # the library's grouped product over the same routed rows (it
        # takes no empty tail: the kernel also writes the tail's zeros)
        offs = torch.cumsum(sizes.to(dev), 0).to(torch.int32)
        xr = x[:routed].contiguous()
        res["gmm_library_ms"] = ms(lambda: torch._grouped_mm(xr, w,
                                                             offs=offs))
        res["gmm_library"] = "torch._grouped_mm (the routed rows)"
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


# --------------------------------------------------------------------------- #
# The expert axis on every engine (train_moe_350m_ep_zero)
# --------------------------------------------------------------------------- #
# moe_350m at full width (H 768, 4 experts top-2, bf16 with the fp32
# master, flash, remat full), MOE_EP_LAYERS of its 12 layers, micro 4 a
# rank, seq 1024, gas 1, on four ranks sharing the card over gloo: (b) exact
# ZeRO-2 at {data: 2, expert: 2} (train_moe_350m_ep's (b), E10's
# baseline), (c) exact ZeRO-3, (d) ZeRO-2 + qgZ + qwZ + LoCo, (e) ZeRO-3 +
# qgZ + qwZ, all at
# {data: 2, expert: 2}, (f) hpZ ZeRO-3 at {zshard: 2, expert: 2}; 1 warm-up
# + MOE_EPZ["steps"] timed steps each, one more profiled on rank 0. (g) two
# ranks at {expert: 2} with moe_dispatch "dense" (the GShard [E, C, H]
# buffers by all-to-all across the experts), in a second spawn.
# Gates, all at MOE_EPZ["layers"] layers, full width, gate_micro 1 a rank,
# gas 1, from the seed's weights:
# E6 one fp32 step of (c) and (f) against the exact ZeRO-2 step at the
#    same ranks ({data: 2, expert: 2}: the same rows a rank) by the
#    training rule (MOE_EP_LIMITS); bf16: the first loss within 1e-5 of the
#    bf16 ZeRO-2 step's, the update no further from the fp32 ZeRO-2 step
#    than BF16_VS_PLAIN x the bf16 ZeRO-2 step's. (e)'s fp32 step, an int8
#    wire, is held by E7's rule instead;
# E7 (d) and (e): on the step's real packed gradient (the dense rows
#    summed over the expert group, the expert leaves in JAX's blocks), the
#    kernels' q, scales and reduced chunk bit-equal to the plain versions;
#    one fp32 step all kernels vs all plain: the loss within 1e-5, the
#    reduced gradient and the update no further apart than WIRE_NOISE_SHARE
#    x the plain step's distance from the exact ZeRO-2 step;
# E8 each group's collectives and elements a step (comm.traffic) by
#    formula from the layout (epz_traffic_want): the dense replica hop on
#    the expert group (on (data, expert) under hpZ: the expert group at
#    data = 1); on the exact wire no expert leaf crosses the expert group;
#    on the int8 wire an expert piece is all-gathered over it before its
#    quantization (JAX's blocks span every expert);
# E9 (g)'s fp32 step against one process with the dense dispatch by the
#    training rule, the kept choices agreeing on >= ROUTE_AGREE_MIN, their
#    number over the ranks equal to one process's (the exchange drops
#    none);
# E10 (c)'s peak a rank below (b)'s by at least 0.75 x the reckoned margin
#    (epz_memory_margin: the bytes ZeRO-2 keeps that ZeRO-3 does not, less
#    the gathers and reduce rows ZeRO-3 holds at once).
MOE_EPZ = dict(model="moe_350m", world=4, micro=4, seq=1024, gas=1, steps=1,
               layers=MOE_EP_LAYERS, gate_micro=1)
MOE_EPZ_INT8 = {"zero_quantized_gradients": True,
                "zero_quantized_weights": True}
MOE_EPZ_D2E2 = {"data": 2, "expert": 2}
MOE_EPZ_WAYS = (
    ("b_zero2", MOE_EPZ_D2E2, {"stage": 2}),
    ("c_zero3", MOE_EPZ_D2E2, {"stage": 3}),
    ("d_zero2_int8_loco", MOE_EPZ_D2E2,
     dict(MOE_EPZ_INT8, stage=2, loco_error_feedback=True)),
    ("e_zero3_int8", MOE_EPZ_D2E2, dict(MOE_EPZ_INT8, stage=3)),
    ("f_hpz_zero3", {"zshard": 2, "expert": 2},
     {"stage": 3, "zero_hpz_partition_size": 2}))
MOE_EPZ_DENSE = dict(MOE_EPZ, world=2, mesh={"expert": 2},
                     spec={"moe_dispatch": "dense"})
MOE_EPZ_MEMORY_SHARE = 0.75


def epz_way(label):
    return next(w for w in MOE_EPZ_WAYS if w[0] == label)


def _add(want, key, calls, elems):
    c = want.setdefault(key, [0, 0])
    c[0] += calls
    c[1] += elems


def epz_traffic_want(engine, t):
    """E8: the collectives a rank of ``engine`` runs in ``t["steps"]`` steps →
    {group label/kind: [calls, elements it sends in]}, from its layout: the
    MoE layer's (``moe_ep_traffic_want``; the dense dispatch's per layer and
    micro-batch: the gate's per-row counts gathered on the batch group in
    the forward and the recompute, the aux loss's mean there and in the
    backward, the [E, C, H] buffers to the experts and back in each of the
    three passes), then the engine's: ZeRO-3's gathers (each group in the
    forward, each chunk in the recompute) and exact reduces (each group's
    reduce-scatter on the shard group, its dense part's hop on the dense
    replica group, its expert part's on the expert leaves'), the int8 wire's
    dense rows summed on the expert group, its expert pieces all-gathered
    there (JAX's blocks), its all-to-all of q and the scales; the qwZ
    publish; the replicated leaves' mean, the norm's two sums and the loss's
    mean."""
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.moe import gating as G
    from deepspeed_tpu_torch.ops.quant_kernels import DEFAULT_BLOCK as B

    cfg = engine.model_spec.config
    L, gas = cfg.num_layers, t["gas"]
    mm = engine.mesh_manager
    X, W = engine.ep, engine.shard_world
    want = {}
    if cfg.moe_dispatch == "dense":
        world = mm.axes_size(M.BATCH_AXES)
        E, k, H = cfg.n_experts, cfg.moe_top_k, cfg.hidden_size
        C = G.gate_capacity(t["micro"] * t["seq"] * world, E, k,
                            cfg.moe_capacity_factor, cfg.moe_min_capacity)
        n = L * gas
        _add(want, "expert/all_to_all", 6 * n, 6 * n * E * C * H)
        _add(want, "batch/all_reduce", 3 * n, 3 * n * 2 * E)
        _add(want, "batch/all_gather", 2 * n, 2 * n * t["micro"] * k * E)
    else:
        want.update(moe_ep_traffic_want(L, gas, 1, t["micro"], t["seq"],
                                        cfg.moe_top_k, X, cfg.hidden_size,
                                        cfg.n_experts))
    shard = M.group_label(engine.shard_group)
    expert = M.group_label(engine.expert_group)
    world = M.group_label(None)
    int8 = engine._quant_grads()

    def wire(group, quantized):
        """(expert pieces' gather elements, the wire row's length)."""
        ex = engine.expert_rows(group) if quantized else None
        if ex is None:
            return 0, group.n_row
        return ex.n_local, ex.n_dense + ex.n_global

    for _ in range(gas):
        if engine.zero_stage >= 3:
            groups = engine._zero3.groups
            for g in list(groups) + list(groups[1:]):    # fwd, recompute
                n_ex, n_wire = wire(g, engine._quant_weights())
                if engine._quant_weights():
                    if n_ex:
                        _add(want, f"{expert}/all_gather", 1, n_ex)
                    _add(want, f"{shard}/all_gather", 2, n_wire
                         + n_wire // B)
                else:
                    _add(want, f"{shard}/all_gather", 1, g.n_row)
            if not int8:
                for g in groups:
                    _add(want, f"{shard}/reduce_scatter", 1, W * g.n_row)
                    for grp, lo, hi in engine.hops(g.n_dense, g.n_row):
                        _add(want, f"{M.group_label(grp)}/all_reduce", 1,
                             hi - lo)
        if int8:
            nsd = engine._n_sh_dense
            if X > 1:
                _add(want, f"{expert}/all_reduce", 1, W * nsd)
            n_ex, n_wire = wire(engine._wire_group, True)
            if n_ex:
                _add(want, f"{expert}/all_gather", 1, W * n_ex)
            _add(want, f"{shard}/all_to_all", 2, W * n_wire
                 + W * n_wire // B)
        if int8 and engine._n_rep:
            _add(want, f"{world}/all_reduce", 1, engine._n_rep_dense)
    if not int8 and engine._n_rep:
        _add(want, f"{world}/all_reduce", 1, engine._n_rep_dense)
    if engine._n_rep_dense < engine._n_rep:
        for grp, size in ((engine.shard_group, engine.shard_world),
                          (engine.expert_hop_group,
                           engine.expert_hop_world)):
            if size > 1:
                _add(want, f"{M.group_label(grp)}/all_reduce",
                     gas if int8 else 1,
                     (gas if int8 else 1) * (engine._n_rep
                                             - engine._n_rep_dense))
    if engine.zero_stage < 3 and engine._quant_weights():
        for g in engine._publish_groups:
            n_ex, n_wire = wire(g, True)
            if n_ex:
                _add(want, f"{expert}/all_gather", 1, n_ex)
            _add(want, f"{shard}/all_gather", 2, n_wire + n_wire // B)
    _add(want, f"{shard}/all_reduce", 1, 2)          # the norm's sums
    _add(want, f"{expert}/all_reduce", 1, 2)
    _add(want, f"{world}/all_reduce", 1, 1)          # the loss's mean
    return {k: [c * t["steps"], e * t["steps"]] for k, (c, e) in want.items()}


def epz_traffic_problems(label, traffic, want):
    """E8: every key's calls and elements equal the formula's, and no
    other group moved anything."""
    got = {k: [int(v[0]), int(v[1])] for k, v in traffic.items()
           if int(v[0])}
    if got != want:
        keys = sorted(set(got) | set(want))
        return [f"E8 {label}: " + "; ".join(
            f"{k} {got.get(k)} want {want.get(k)}" for k in keys
            if got.get(k) != want.get(k))]
    return []


def epz_memory_margin(zero2, zero3):
    """E10's reckoned margin, bytes a rank: what exact ZeRO-2 holds through
    the step and ZeRO-3 does not — the full compute copy and micro-batch
    gradient (compute dtype) and the packed fp32 rows — less what ZeRO-3
    holds at once instead: two groups gathered (the one in use and the
    next in flight, compute dtype) and two groups' reduce rows ([shard
    world, n_row] fp32), the largest ones."""
    el = zero2["compute_bytes_per_element"]
    keep = (2 * zero2["numel"] * el + 4 * zero2["packed_numel"])
    rows = sorted(zero3["group_rows"], reverse=True)[:2]
    held = sum(r * zero3["shard_world"] * (el + 4) for r in rows)
    return keep - held


def epz_layout(engine):
    return {"numel": engine._numel,
            "compute_bytes_per_element": engine.compute_dtype.itemsize,
            "packed_numel": (engine._packed.numel()
                             if getattr(engine, "_packed", None) is not None
                             else 0),
            "group_rows": [g.n_row for g in engine._zero3.groups]
            if hasattr(engine, "_zero3") else [],
            "shard_world": engine.shard_world,
            "n_sharded": engine._n_sh, "n_sharded_dense": engine._n_sh_dense,
            "n_replicated": engine._n_rep,
            "local_experts": next(sl.shape[1] for sl in engine._slots
                                  if sl.path == ("blocks", "w_up"))}


@timed_part
def epz_gate_step(t, dev, tokens, L, mesh, zero, precision, kernels=True):
    """One step of ``zero`` at ``mesh`` from the seed's weights on the
    gate's rows → {loss, norm, grad, upd, idx, aux, total}: the reduced
    gradient and the update as this rank's local buffers (every way of
    the phase lays them out alike: shard world 2, the same ZeRO dims, a
    rank's shard index r // 2), its routes, the summed aux, and
    ``total(x)``: the model-wide sum of a per-element quantity in that
    layout, each element once (the shards over the shard group, expert
    shards over the expert group too, a replicated expert leaf over the
    expert group), as the engine's norm sums squares."""
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import comm

    config = zeropp_config(t["gate_micro"], 1, precision, zero)
    config["mesh"] = dict(mesh)
    with (contextlib.nullcontext() if kernels else plain_wire()):
        engine, *_ = dtt.initialize(model=moe_ep_spec(t, precision),
                                    config=config, device=dev)
        before = engine.flat_master.clone()
        with recorded_routes() as routes, recorded_aux() as auxes:
            loss = float(engine.train_batch(iter([{"tokens": tokens}])))
    nsd, ns, nrd = engine._n_sh_dense, engine._n_sh, engine._n_rep_dense
    groups = engine.shard_group, engine.expert_group

    def total(x):
        x = x.double()
        parts = torch.stack([x[:nsd].sum(), x[nsd:ns].sum(),
                             x[ns + nrd:].sum(), x[ns:ns + nrd].sum()])
        comm.all_reduce(parts[:2], group=groups[0])
        comm.all_reduce(parts[1:3], group=groups[1])
        return float(parts.sum())

    step = {"loss": loss, "norm": engine.get_global_grad_norm(),
            "grad": engine.flat_grad_acc.float().clone(),
            "upd": engine.flat_master - before,
            "idx": torch.stack([r[0] for r in routes[:L]]),
            "aux": float(sum(float(a) for a in auxes[:L])), "total": total}
    engine.close()
    del engine, before
    dev_free(dev)
    return step


def epz_gates(t, dev, seed):
    """E6 and E7's steps on every rank (the same numbers on each: the
    local buffers' differences summed over the model; the routing
    agreement over every rank's rows)."""
    import torch
    from deepspeed_tpu_torch.comm import comm

    rows = t["gate_micro"] * comm.get_world_size()
    tokens = moe_ep_batch(t, seed)["tokens"][:rows]
    L = t["layers"]

    def run(label, precision, kernels=True):
        _, mesh, zero = epz_way(label)
        return epz_gate_step(t, dev, tokens, L, mesh, zero, precision,
                             kernels)

    def dist(a, b, key):
        return a["total"]((a[key] - b[key]).square()) ** 0.5

    def metrics(step, ref):
        """The training rule's metrics (``step_metrics``'s) on the local
        buffers."""
        total = step["total"]
        upd, rupd = step["upd"], ref["upd"]
        nz = (upd != 0) | (rupd != 0)
        miss = ((upd > 0) != (rupd > 0)) & nz
        route = torch.tensor([float((step["idx"] != ref["idx"]).float()
                                    .mean())], dtype=torch.float64,
                             device=dev)
        comm.all_reduce(route, op=comm.ReduceOp.AVG)
        return {"loss": step["loss"], "grad_norm": step["norm"],
                "loss_rel": abs(step["loss"] - ref["loss"]) / abs(
                    ref["loss"]),
                "norm_rel": abs(step["norm"] - ref["norm"]) / ref["norm"],
                "grad_rel": dist(step, ref, "grad") / total(
                    ref["grad"].square()) ** 0.5,
                "update_rel": dist(step, ref, "upd") / total(
                    rupd.square()) ** 0.5,
                "sign_miss": total(miss) / max(total(nz), 1.0),
                "aux_rel": abs(step["aux"] - ref["aux"]) / abs(ref["aux"]),
                "route_miss": float(route)}

    res = {}
    ref32 = run("b_zero2", "fp32")
    for label in ("c_zero3", "f_hpz_zero3"):
        res[f"fp32_{label}"] = metrics(run(label, "fp32"), ref32)
    for label in ("d_zero2_int8_loco", "e_zero3_int8"):
        plain = run(label, "fp32", kernels=False)
        kern = run(label, "fp32")
        res[f"fp32_{label}"] = {
            "loss_rel": abs(kern["loss"] - plain["loss"]) / abs(
                plain["loss"]),
            "grad_dist": dist(kern, plain, "grad"),
            "update_dist": dist(kern, plain, "upd"),
            "noise_grad_dist": dist(plain, ref32, "grad"),
            "noise_update_dist": dist(plain, ref32, "upd"),
            "against_exact": metrics(kern, ref32)}
        del plain, kern
    ref16 = run("b_zero2", "bf16")
    res["bf16_b_zero2"] = metrics(ref16, ref32)
    for label in ("c_zero3", "f_hpz_zero3"):
        b = run(label, "bf16")
        row = metrics(b, ref32)
        row["loss_rel_to_zero2"] = abs(b["loss"] - ref16["loss"]) / abs(
            ref16["loss"])
        res[f"bf16_{label}"] = row
        del b
    del ref32, ref16
    dev_free(dev)
    return res


def epz_gate_problems(g):
    out = []
    for label in ("c_zero3", "f_hpz_zero3"):
        row = g[f"fp32_{label}"]
        out += [f"E6 fp32 {label} {m} {row[m]:.3g} > {lim}"
                for m, lim in MOE_EP_LIMITS.items() if not row[m] <= lim]
        b, b2 = g[f"bf16_{label}"], g["bf16_b_zero2"]
        if not b["loss_rel_to_zero2"] <= TRAIN_LOSS_REL:
            out.append(f"E6 bf16 {label} loss {b['loss_rel_to_zero2']:.3g} "
                       "from ZeRO-2's")
        if not b["update_rel"] <= BF16_VS_PLAIN * b2["update_rel"]:
            out.append(f"E6 bf16 {label} update_rel {b['update_rel']:.3g} >"
                       f" {BF16_VS_PLAIN} x ZeRO-2's {b2['update_rel']:.3g}")
    for label in ("d_zero2_int8_loco", "e_zero3_int8"):
        row = g[f"fp32_{label}"]
        if not row["loss_rel"] <= TRAIN_LOSS_REL:
            out.append(f"E7 {label} loss rel {row['loss_rel']:.3g}")
        for m in ("grad_dist", "update_dist"):
            if not row[m] <= WIRE_NOISE_SHARE * row[f"noise_{m}"]:
                out.append(f"E7 {label} {m} {row[m]:.3g} > "
                           f"{WIRE_NOISE_SHARE} x the wire's noise "
                           f"{row[f'noise_{m}']:.3g}")
    return out


def train_moe_350m_ep_zero_rank(rank, world, seed, t):
    """One rank of the phase's first spawn: each way's main path (the
    counters and traffic to 0 just before the timed step, read just after;
    E7's wire gate on (d) and (e); a profiled step on rank 0), then the
    gate steps."""
    import torch

    dev = torch.device(t["device"])
    batch = moe_ep_batch(t, seed)
    out = {"rank": rank, "main": {}}
    for label, mesh, zero in MOE_EPZ_WAYS:
        engine, data, run = zeropp_run(dict(t, mesh=mesh), dev, zero, batch)
        run.update(epz_layout(engine), traffic_want=epz_traffic_want(
            engine, t), drop_frac_max=float(engine._moe_drop_max),
            coords=dict(engine.mesh_manager.coords),
            card_bytes=(torch.cuda.get_device_properties(dev).total_memory
                        if dev.type == "cuda" else 0))
        if hasattr(engine, "_zero3"):
            run["counts"] = dict(engine._zero3.counts)
        if engine._quant_grads():
            run["e7_wire"] = wire_gates(engine, batch, dev)
        run["profile"] = zeropp_profile(engine, data, dev,
                                        profiled=rank == 0)
        engine.close()
        del engine, data
        dev_free(dev)
        out["main"][label] = run
    out["gates"] = epz_gates(t, dev, seed)
    return out


def train_moe_350m_ep_dense_rank(rank, world, seed, t):
    """One rank of (g): the main path at {expert: 2} with the dense
    dispatch, a profiled step on rank 0, then E9's fp32 step against the
    one-process reference ``t["ref"]``."""
    import torch

    dev = torch.device(t["device"])
    batch = moe_ep_batch(t, seed)
    engine, data, run = zeropp_run(t, dev, {"stage": 2}, batch)
    run.update(epz_layout(engine), traffic_want=epz_traffic_want(engine, t),
               card_bytes=(torch.cuda.get_device_properties(dev).total_memory
                           if dev.type == "cuda" else 0))
    run["profile"] = zeropp_profile(engine, data, dev, profiled=rank == 0)
    engine.close()
    del engine, data
    dev_free(dev)
    gates = moe_ep_gates(dict(t, seed=seed, zero={"stage": 2}), dev,
                         t["ref"], bf16=False, ways=("ep32",))
    return {"rank": rank, "main": run, "gates": gates}


def epz_problems(ranks, dense, t):
    """The parent's checks of both spawns' ranks: the losses, E6-E10, the
    ZeRO-3 gathers, nothing dropped."""
    out = []
    gas = t["gas"]
    for r in ranks:
        tag = f"rank {r['rank']}"
        for label, m in r["main"].items():
            ls = m["losses"]
            if not all(np.isfinite(ls)):
                out.append(f"{tag} {label}: losses {ls}")
            if ls != ranks[0]["main"][label]["losses"]:
                out.append(f"{tag} {label}: the ranks' losses differ")
            if m["drop_frac_max"] != 0:
                out.append(f"{tag} {label}: dropped {m['drop_frac_max']}")
            if label != "b_zero2":
                out += epz_traffic_problems(f"{tag} {label}", m["traffic"],
                                            m["traffic_want"])
            if "counts" in m:
                chunks = len(m["group_rows"]) - 1
                out += [f"{tag} {label}: {p}" for p in zero3_count_problems(
                    m["counts"], gas, chunks,
                    "zero_quantized_gradients" in epz_way(label)[2])]
            if "e7_wire" in m:
                w = m["e7_wire"]
                for k in ("q_bitwise_equal", "scales_bitwise_equal",
                          "reduced_bitwise_equal"):
                    if not w[k]:
                        out.append(f"{tag} {label}: E7 {k} false")
                n_out = w["quant_err_out_of_bound"]
                if n_out:
                    out.append(f"{tag} {label}: E7 {n_out} elements past "
                               "half a step")
        out += [f"{tag}: {p}" for p in epz_gate_problems(r["gates"])]
        m2, m3 = r["main"]["b_zero2"], r["main"]["c_zero3"]
        margin = epz_memory_margin(m2, m3)
        if m2["card_bytes"] and not m3["peak_memory_bytes"] <= (
                m2["peak_memory_bytes"]
                                           - MOE_EPZ_MEMORY_SHARE * margin):
            out.append(f"{tag}: E10 ZeRO-3 peak {m3['peak_memory_bytes']} "
                       f"not {MOE_EPZ_MEMORY_SHARE} x {margin} below "
                       f"ZeRO-2's {m2['peak_memory_bytes']}")
    for r in dense:
        tag = f"(g) rank {r['rank']}"
        m = r["main"]
        if not all(np.isfinite(m["losses"])):
            out.append(f"{tag}: losses {m['losses']}")
        out += epz_traffic_problems(tag, m["traffic"], m["traffic_want"])
        g = r["gates"]["fp32_one_process"]
        out += [f"{tag}: E9 {k} {g[k]:.3g} > {lim}"
                for k, lim in MOE_EP_LIMITS.items() if not g[k] <= lim]
        if g["kept"] != g["ref_kept"]:
            out.append(f"{tag}: E9 kept choices {g['kept']}, one process "
                       f"{g['ref_kept']}")
    return out


# The kernel instantiations the launches reach, as sass_kernel_label names
# them: (family, "dtype rest").
# --------------------------------------------------------------------------- #
# The sequence-parallel phase (train_llama_750m_sp2)
# --------------------------------------------------------------------------- #
# llama_750m at full width (hidden 1536, 12 heads of 128, SwiGLU 4096,
# RMSNorm, RoPE), SP2_LAYERS of its 20 layers, bf16 with an fp32 master,
# remat full, Adam lr 1e-4, exact ZeRO-1; global micro 4 (the rows every
# seq rank shares), seq 2048, gas 2; two ranks at mesh {seq: 2} over gloo on
# the one card, each holding 1,024 positions of the same 4 rows. Ways,
# each timed one step after a warm-up, then one more step profiled on rank
# 0: (a) attention="ulysses_flash" (the flash kernels on [4, 2048, 6, 128]
# head-sharded blocks between Ulysses' all-to-alls), (b) attention="ring".
# Gates, on SP2_GATE batch (the same rows with a loss mask that keeps every
# token of rank 0's positions and a third of rank 1's):
# SP1 one fp32 step of (a) against one process with attention="flash" on
#     the same global batch and weights, by the training rule (loss, grad
#     norm, gradient and update relative L2, sign misses);
# SP2 the same for (b);
# SP3 bf16 (a): its first loss within TRAIN_LOSS_REL of one process's bf16
#     loss (flash), its update no further from the one-process fp32 update
#     than BF16_VS_PLAIN times the one-process plain bf16 path's;
# SP4 launches and traffic a step by formula: flash fwd 2·L·gas and dq,
#     dkv L·gas each at the head-sharded shape; Ulysses' all-to-alls on the
#     seq group 4 a layer in the forward, 4 in the recompute and 4 in the
#     backward, each of B·(S/sp)·N·D elements; (b)'s permutes 2·(sp − 1) a
#     layer in each of the three, of B·(S/sp)·K·D elements;
# SP5 each rank's forward-backward peak above its resident state below
#     one process's at the same global batch and depth;
# (c) attention="ulysses_flash" at mesh {data: 2, seq: 2} on four ranks
#     (the same global batch: 2 rows a data rank), timed the same way, its
#     fp32 step held against the same one process by SP1's rule (SP1c),
#     its launches and traffic by SP4's formula, its peak by SP5's;
# SP6 (one process) FPDT at [1, 8192, 12, 128] bf16, forward and backward
#     with K/V in pinned host memory, against chunked attention at the same
#     chunks: fp32 at FLASH_TOL, bf16 by the flash rule (relative L2 from
#     the fp32 chunked reference ≤ BF16_VS_PLAIN × chunked bf16's), its
#     device peak below chunked's.
SP2 = dict(model="llama_750m", world=2, mesh={"seq": 2}, micro=4, seq=2048,
           gas=2, steps=1, zero={"stage": 1})
SP2_LAYERS = 2
SP2_WAYS = (("a_ulysses_flash", "ulysses_flash"), ("b_ring", "ring"))
SP2_C = dict(world=4, mesh={"data": 2, "seq": 2},
             ways=(("c_d2_ulysses_flash", "ulysses_flash"),),
             gates=("sp1c_fp32_ulysses_flash",))
SP2_GATES = {"sp1_fp32_ulysses_flash": ("fp32", "ulysses_flash"),
             "sp2_fp32_ring": ("fp32", "ring"),
             "sp3_bf16_ulysses_flash": ("bf16", "ulysses_flash"),
             "sp1c_fp32_ulysses_flash": ("fp32", "ulysses_flash")}
SP2_LIMITS = {"loss_rel": TRAIN_LOSS_REL, "norm_rel": TRAIN_NORM_REL,
              "grad_rel": TRAIN_GRAD_REL, "update_rel": TRAIN_UPDATE_REL,
              "sign_miss": TRAIN_SIGN_MISS}
FPDT = dict(B=1, S=8192, N=12, D=128, num_chunks=4, kv_chunks=4)


def sp2_c(t):
    """Way (c)'s settings from the phase's: SP2_C's mesh, the same global
    batch (``micro`` split over the data ranks)."""
    return dict(t, **SP2_C, micro=t["micro"] // SP2_C["mesh"]["data"])


def sp2_batch(t, seed, masked=False):
    """The phase's global micro-batch (``micro`` rows of ``seq`` tokens a
    batch rank, from the seed: the ``seq``, ``tensor`` and ``pipe`` ranks
    of a row share it); ``masked``: a loss mask keeping every
    target of the first half of the positions and every third of the
    second."""
    from deepspeed_tpu_torch.models import transformer as T

    vocab = T.get_model_config(t["model"]).vocab_size
    rows = t["micro"] * t["world"] // (t["mesh"].get("seq", 1)
                                       * t["mesh"].get("tensor", 1)
                                       * t["mesh"].get("pipe", 1))
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, vocab, (rows, t["seq"]),
                                  dtype=np.int32)}
    if masked:
        mask = np.ones((rows, t["seq"]), np.float32)
        half = t["seq"] // 2
        mask[:, half:] = np.arange(half, t["seq"]) % 3 == 0
        out["loss_mask"] = mask
    return out


def sp2_spec(t, precision, attention, use_kernels=True):
    import deepspeed_tpu_torch as dtt

    return dtt.causal_lm_spec(
        t["model"], attention=attention, remat="full",
        use_kernels=use_kernels, num_layers=t["layers"],
        dtype="float32" if precision == "fp32" else "bfloat16",
        **t.get("spec", {}))


def sp2_engine(t, dev, precision, attention, micro, gas, mesh=None,
               use_kernels=True):
    import deepspeed_tpu_torch as dtt

    config = zeropp_config(micro, gas, precision, t["zero"])
    if mesh:
        config["mesh"] = dict(mesh)
    engine, *_ = dtt.initialize(
        model=sp2_spec(t, precision, attention, use_kernels), config=config,
        device=dev)
    return engine


def sp2_reference(t, dev, seed, path):
    """One process at the phase's depth (what the ranks read): the fp32
    step with the flash kernels on the gate batch (its whole gradient and
    update in numpy files beside ``path``), the bf16 kernels' loss, the
    plain bf16 path's metrics against the fp32 step (SP3's yardstick), and
    the bf16 main path's forward-backward peak above its resident state
    (SP5)."""
    import itertools

    gate = sp2_batch(t, seed, masked=True)
    out = {}
    ref = None
    for label, prec, use_kernels in (("fp32", "fp32", True),
                                     ("bf16", "bf16", True),
                                     ("bf16_plain", "bf16", False)):
        engine = sp2_engine(t, dev, prec, "flash", t["micro"], 1,
                            use_kernels=use_kernels)
        loss, norm, grad, upd, _, _ = moe_ep_step(engine, gate, 0, dev)
        del engine
        dev_free(dev)
        if ref is None:
            ref = {"loss": loss, "norm": norm, "grad": grad, "upd": upd}
            np.save(path + ".grad.npy", grad.cpu().numpy())
            np.save(path + ".upd.npy", upd.cpu().numpy())
            out.update(loss=loss, norm=norm, grad_path=path + ".grad.npy",
                       upd_path=path + ".upd.npy")
        else:
            out[label] = step_metrics(loss, norm, grad, upd, None, None,
                                      ref)
        del grad, upd
    del ref
    dev_free(dev)
    engine = sp2_engine(t, dev, "bf16", "flash", t["micro"], t["gas"])
    data = itertools.repeat(sp2_batch(t, seed))
    engine.train_batch(data)
    dev_sync(dev)
    resident = dev_allocated(dev)
    dev_peak(dev, reset=True)
    engine.train_batch(data)
    dev_sync(dev)
    out["one_process_fwd_bwd_peak_bytes"] = dev_peak(dev) - resident
    out["one_process_resident_bytes"] = resident
    del engine, data
    dev_free(dev)
    return out


@contextlib.contextmanager
def recorded_flash_shapes():
    """Yields a dict {kernel: set of q shapes} the flash wrappers are
    called with while the block runs (the module's functions wrapped for
    the block's duration and restored after)."""
    from deepspeed_tpu_torch.ops import flash_attention as PF

    shapes = {"flash_fwd": set(), "flash_bwd_dq": set(),
              "flash_bwd_dkv": set()}
    saved = {name: getattr(PF, name) for name in shapes}

    def wrap(name):
        def fn(q, *args, **kwargs):
            shapes[name].add(tuple(q.shape))
            return saved[name](q, *args, **kwargs)
        return fn

    for name in shapes:
        setattr(PF, name, wrap(name))
    try:
        yield shapes
    finally:
        for name, fn in saved.items():
            setattr(PF, name, fn)


@timed_part
def sp2_run(t, dev, attention, batch, timed=contextlib.nullcontext):
    """One way's main path on this rank: initialize at mesh {seq: 2}, a
    warm-up step, ``t["steps"]`` timed steps with the counters and the
    traffic set to 0 just before and read just after (the flash wrappers'
    shapes recorded meanwhile, the steps inside ``timed()``), the peak
    above the resident state; the warm-up's traffic beside."""
    import itertools

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import comm

    t0 = time.perf_counter()
    engine = sp2_engine(t, dev, "bf16", attention, t["micro"], t["gas"],
                        mesh=t["mesh"])
    dev_sync(dev)
    init_s = time.perf_counter() - t0
    data = itertools.repeat(batch)
    t0 = time.perf_counter()
    first = float(engine.train_batch(data))
    warm_s = time.perf_counter() - t0
    warm_traffic = {k: list(v) for k, v in comm.traffic.items()}
    comm.barrier()
    resident = dev_allocated(dev)
    dev_peak(dev, reset=True)
    reset_counts()
    comm.reset_traffic()
    losses, walls = [], []
    with recorded_flash_shapes() as shapes, timed():
        for _ in range(t["steps"]):
            t0 = time.perf_counter()
            loss = engine.train_batch(data)
            dev_sync(dev)
            walls.append(time.perf_counter() - t0)
            losses.append(float(loss))
    counts = read_counts()
    traffic = {k: list(v) for k, v in comm.traffic.items()}
    return engine, data, {
        "attention": attention, "init_seconds": init_s,
        "warmup_step_seconds": warm_s, "warmup_traffic": warm_traffic,
        "losses": [first] + losses,
        "step_walls_s": walls, "step_ms": float(np.median(walls)) * 1e3,
        "launches": counts, "traffic": traffic,
        "flash_shapes": {k: sorted(v) for k, v in shapes.items()},
        "seq_host_s_per_step": sum(v[2] for k, v in traffic.items()
                                   if k.startswith("seq/")) / t["steps"],
        "adam_per_step": adam_launches_per_step(engine),
        "resident_bytes": resident,
        "fwd_bwd_peak_bytes": dev_peak(dev) - resident,
        "coords": dict(engine.mesh_manager.coords)}


@timed_part
def sp2_gates(t, dev, ref, table=None):
    """SP1-SP3 (SP1c at (c)'s mesh; TP1-TP2 with ``table`` TP2_GATES) on
    this rank: one step of each of ``t["gates"]`` from the seed's weights
    on the masked gate batch, against the one-process reference (whole
    vectors, gathered over the shard group and the tensor group)."""
    import torch

    gate = sp2_batch(t, 0 if t.get("seed") is None else t["seed"],
                     masked=True)
    one = dict(ref, grad=torch.from_numpy(np.load(ref["grad_path"])).to(dev),
               upd=torch.from_numpy(np.load(ref["upd_path"])).to(dev))
    out = {}
    for label in t.get("gates", ("sp1_fp32_ulysses_flash", "sp2_fp32_ring",
                                 "sp3_bf16_ulysses_flash")):
        prec, attention = (table or SP2_GATES)[label]
        engine = sp2_engine(t, dev, prec, attention, t["micro"], 1,
                            mesh=t["mesh"])
        loss, norm, grad, upd, _, _ = moe_ep_step(engine, gate, 0, dev)
        del engine
        dev_free(dev)
        out[label] = step_metrics(loss, norm, grad, upd, None, None, one)
        del grad, upd
    del one
    dev_free(dev)
    return out


def sp2_gate_problems(g, ref):
    """SP1-SP3's verdicts."""
    problems = []
    for label in ("sp1_fp32_ulysses_flash", "sp2_fp32_ring",
                  "sp1c_fp32_ulysses_flash"):
        if label in g:
            problems += [f"{label}: {k} {g[label][k]:.3g} > {v}"
                         for k, v in SP2_LIMITS.items()
                         if not g[label][k] <= v]
    if "sp3_bf16_ulysses_flash" not in g:
        return problems
    b = g["sp3_bf16_ulysses_flash"]
    loss_rel = abs(b["loss"] - ref["bf16"]["loss"]) / abs(ref["bf16"]["loss"])
    if not loss_rel <= TRAIN_LOSS_REL:
        problems.append(f"sp3: first loss {loss_rel:.3g} from one process's "
                        f"bf16 loss > {TRAIN_LOSS_REL}")
    limit = BF16_VS_PLAIN * ref["bf16_plain"]["update_rel"]
    if not b["update_rel"] <= limit:
        problems.append(f"sp3: update {b['update_rel']:.4g} from fp32 > "
                        f"{BF16_VS_PLAIN} x the plain bf16 path's")
    return problems


def sp2_want(t, L, attention, cfg, adam_per_step):
    """SP4: a step's launches and seq-group traffic by formula."""
    gas, sp = t["gas"], t["mesh"]["seq"]
    B, S_l, N, K, D = (t["micro"], t["seq"] // sp, cfg.num_heads,
                       cfg.kv_heads, cfg.head_dim)
    flash = attention == "ulysses_flash"
    launches = {"flash_fwd": 2 * L * gas if flash else 0,
                "flash_bwd_dq": L * gas if flash else 0,
                "flash_bwd_dkv": L * gas if flash else 0,
                "rms_norm": (4 * L + 1) * gas,
                "fused_adam": adam_per_step, "quant_int8": 0,
                "dequant_reduce": 0, "block_sparse_fwd": 0, "gmm": 0,
                "tgmm": 0, "evoformer_fwd": 0, "paged_attention": 0}
    if flash:
        # q, k, v scattered and o gathered, in the forward, the recompute
        # and the backward (K/V heads repeated up to sp where sp does not
        # divide them)
        K_a2a = K if K % sp == 0 else -(-sp // K) * K
        n = 3 * L * gas
        traffic = {"seq/all_to_all": (4 * n,
                                      n * B * S_l * (2 * N + 2 * K_a2a) * D)}
        shapes = [(B, t["seq"], N // sp, D)]
    else:
        # K and V (their heads repeated up to N first) sent on sp - 1
        # times in the forward, the recompute and the backward
        n = 3 * 2 * (sp - 1) * L * gas
        traffic = {"seq/permute": (n, n * B * S_l * N * D)}
        shapes = []
    return launches, traffic, shapes


def train_llama_750m_sp2_rank(rank, world, seed, t):
    """One rank of the sequence-parallel phase (``t``: SP2, its depth, the
    device and the one-process reference): ways (a) and (b) — the main
    path and a profiled step — then the SP1-SP3 gate steps."""
    import torch

    dev = torch.device(t["device"])
    batch = sp2_batch(t, seed)
    out = {"rank": rank}
    for label, attention in t.get("ways", SP2_WAYS):
        engine, data, out[label] = sp2_run(t, dev, attention, batch)
        out[label]["profile"] = zeropp_profile(
            engine, data, dev, profiled=rank == 0 and dev.type == "cuda")
        engine.close()
        del engine, data
        dev_free(dev)
    out["gates"] = sp2_gates(t, dev, t["ref"])
    return out


def fpdt_gate(dev):
    """SP6: FPDT (K/V in pinned host memory, streamed a chunk at a time)
    against chunked attention at the same query chunks, forward and
    backward, fp32 and bf16, and their device peaks."""
    import torch

    from deepspeed_tpu_torch.sequence.tiled import (
        chunked_attention,
        fpdt_attention,
    )

    B, S, N, D = FPDT["B"], FPDT["S"], FPDT["N"], FPDT["D"]
    g = torch.Generator(dev).manual_seed(5)
    base = [torch.randn(B, S, N, D, generator=g, device=dev)
            for _ in range(4)]
    out = {}
    res = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, fn in (("chunked", lambda q, k, v: chunked_attention(
                q, k, v, causal=True, num_chunks=FPDT["num_chunks"])),
                         ("fpdt", lambda q, k, v: fpdt_attention(
                             q, k, v, causal=True,
                             num_chunks=FPDT["num_chunks"],
                             kv_chunks=FPDT["kv_chunks"], offload_kv=True))):
            q, k, v = (x.detach().to(dt).clone().requires_grad_()
                       for x in base[:3])
            do = base[3].to(dt)
            dev_sync(dev)
            resident = dev_allocated(dev)
            dev_peak(dev, reset=True)
            t0 = time.perf_counter()
            o = fn(q, k, v)
            o.backward(do)
            dev_sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            res[(dtype, name)] = {"o": o.detach(), "dq": q.grad,
                                  "dk": k.grad, "dv": v.grad}
            out[f"{name}_{dtype}"] = {
                "fwd_bwd_ms": ms,
                "peak_above_inputs_bytes": dev_peak(dev) - resident}
            del q, k, v, o, do
    kv_bytes = 2 * B * S * N * D * 2
    problems = []
    for key in ("o", "dq", "dk", "dv"):
        f32, c32 = res[("float32", "fpdt")][key], res[("float32", "chunked")][key]
        err = float((f32 - c32).abs().max())
        atol, rtol = FLASH_TOL["float32"]
        if not bool(((f32 - c32).abs() <= atol + rtol * c32.abs()).all()):
            problems.append(f"sp6: fp32 {key} max err {err:.3g} past "
                            f"FLASH_TOL")
        fb, cb = (res[("bfloat16", n)][key].float() for n in ("fpdt",
                                                              "chunked"))
        norm = float(c32.norm()) or 1.0
        rel, plain = float((fb - c32).norm()) / norm, \
            float((cb - c32).norm()) / norm
        limit = max(BF16_VS_PLAIN * plain, FLASH_TOL["float32"][1])
        out[f"bf16_{key}"] = {"rel_l2_vs_fp32": rel,
                              "chunked_rel_l2_vs_fp32": plain,
                              "limit": limit, "fp32_max_abs_err": err}
        if not (bool(torch.isfinite(fb).all()) and rel <= limit):
            problems.append(f"sp6: bf16 {key} {rel:.4g} > {limit:.4g}")
    for dtype in ("float32", "bfloat16"):
        pf = out[f"fpdt_{dtype}"]["peak_above_inputs_bytes"]
        pc = out[f"chunked_{dtype}"]["peak_above_inputs_bytes"]
        if not pf < pc:
            problems.append(f"sp6: {dtype} FPDT peak {pf} not below "
                            f"chunked's {pc}")
    out["kv_bytes_bf16_in_pinned_host"] = kv_bytes
    out["shape"] = dict(FPDT)
    del res
    dev_free(dev)
    return out, problems


# --------------------------------------------------------------------------- #
# The tensor-parallel phases (train_llama_750m_tp2, llama2_7b_tp2)
# --------------------------------------------------------------------------- #
# train_llama_750m_tp2: llama_750m at full width (hidden 1536, 12 heads of
# 128, SwiGLU 4096, vocab 32000), TP2_LAYERS of its 20 layers, bf16 with an
# fp32 master, flash attention, remat full, Adam lr 1e-4; global micro 4,
# seq 2048, gas 2. Ways, each timed one step after a warm-up, then one more
# step profiled on rank 0: (a) {tensor: 2}, ZeRO-1, two ranks, each with 6
# of the 12 heads (flash at [4, 2048, 6, 128]), 2048 of the 4096 FFN
# columns and 16000 of the 32000 vocab rows; (b) {data: 2, tensor: 2},
# ZeRO-3 exact, four ranks (2 rows a data rank, flash at [2, 2048, 6,
# 128]). Gates, on SP2's masked gate batch:
# TP1 one fp32 step of each way against one process (flash) on the same
#     global batch and weights, by the training rule (SP2_LIMITS);
# TP2 bf16 (a): its first loss within TRAIN_LOSS_REL of one process's bf16
#     loss, its update no further from the one-process fp32 update than
#     BF16_VS_PLAIN times the one-process plain bf16 path's;
# TP3 the tensor group's all-reduces and elements a step by formula
#     (tp2_traffic_want: 5L + 5 a micro-batch and the norm's one), the
#     kernels' launches a step and the flash wrapper's shapes (tp2_want);
# TP4 each rank's parameters the TP-local count reckoned from the config
#     (tp_local_params), its master its ZeRO part of them, its
#     forward-backward peak above its resident state below one process's.
TP2 = dict(model="llama_750m", world=2, mesh={"tensor": 2}, micro=4,
           seq=2048, gas=2, steps=1, zero={"stage": 1})
# the depth is cut for the script's time (4 layers took 126 s of the
# phase's own on the card; 2 keep the script within 950 s)
TP2_LAYERS = 2
TP2_B = dict(world=4, mesh={"data": 2, "tensor": 2}, zero={"stage": 3})
TP2_GATES = {"tp1_fp32": ("fp32", "flash"), "tp2_bf16": ("bf16", "flash")}
# llama2_7b_tp2: llama2_7b at full width (32 heads of 128, SwiGLU 11008),
# TP7B_LAYERS of its 32 layers, bf16 with random weights from the seed,
# FastGen at {tensor: 2} on two ranks over gloo on the one card: each rank
# holds 16 of the 32 heads (its 16 KV heads of the pool), 5504 FFN
# columns and 16000 vocab rows, and every tick runs eagerly with the
# kernels (a CUDA graph cannot capture a gloo collective). The main path:
# the llama2_7b phase's 8 requests of 16-1024 prompt tokens and 32 new,
# its pool (512 blocks of 32, 64 a sequence) and budget 256; then the
# decode rate from the same prompts with eager ticks (a window of 32 decode
# ticks, one of 8 profiled on rank 0). Gates:
# T1 one mixed tick (TP7B_TICK's two prompts: one decoding, one's chunk
#    prefilling), its KV blocks from a one-process engine in the parent:
#    the TP logits with the kernels against the one-process plain path's,
#    fp32 at TOP1_MIN / LOGIT_REL_TOL_FP32, bf16 no further from the
#    one-process fp32 plain logits than BF16_VS_PLAIN times the
#    one-process bf16 engine's (the kernels);
# T2 the two ranks emit the same tokens;
# T3 the tensor group's calls a tick: 2L + 1 all-reduces (L layers' two
#    row-parallel sums and the embedding's) and one gather of the logits.
TP7B = dict(model="llama2_7b", world=2, mesh={"tensor": 2}, n_req=8, lo=16,
            hi=1024, max_new=32, engine=dict(n_blocks=512, block_size=32,
                                              max_blocks_per_seq=64,
                                              token_budget=256))
# 16 of the 32 layers, full width: at all 32 its job took 44-45 s of the
# world-2 spawn, and the whole script 1,016.9 s on an H100 (stopped past
# 1,200 s on another); at 16, 22.9 s (the first card run of the phase)
TP7B_LAYERS = 16
TP7B_TICK = dict(lens=(40, 700), n_blocks=64)


def tp2_b(t):
    """Way (b)'s settings from the phase's: TP2_B's mesh and ZeRO-3, the
    same global batch (``micro`` split over the data ranks), TP1 only."""
    return dict(t, **TP2_B, micro=t["micro"] // TP2_B["mesh"]["data"],
                gates=("tp1_fp32",))


def tp_local_params(cfg, T):
    """A tensor rank's parameters by formula: the vocab rows (embedding and
    head), the attention's and the FFN's weights and their column biases
    ÷ T; the norms, ``bo`` / ``b_down`` and a learned position table
    whole."""
    H, L, F = cfg.hidden_size, cfg.num_layers, cfg.ffn_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    sliced = (cfg.vocab_size * H * (1 if cfg.tie_embeddings else 2)
              + L * (2 * H * q + 2 * H * kv
                     + (3 if cfg.activation == "swiglu" else 2) * H * F))
    whole = (2 * L + 1) * H * (2 if cfg.norm == "layernorm" else 1)
    if cfg.attn_bias_enabled:
        sliced += L * (q + 2 * kv)
    if cfg.use_bias:
        sliced += L * F
        whole += 2 * L * H
    if cfg.pos_emb == "learned":
        whole += cfg.max_seq_len * H
    return sliced // T + whole


def tp2_traffic_want(t, cfg):
    """TP3: the tensor group's all-reduces and their elements in
    ``t["steps"]`` steps (remat full, the fused loss): a micro-batch sums
    each layer's two row-parallel outputs in the forward, the attention's
    again in the recompute (the non-reentrant checkpoint stops a layer's
    recompute once the last tensor its backward saved is back, and the
    FFN's sum follows the last such product), and its two column-parallel
    inputs' gradients in the backward, each B·S·H; the embedding's B·S·H;
    the loss's row maxima, sums of exponentials and picked logits,
    B·(S − 1) each, and its hidden state's gradient, B·(S − 1)·H; a step
    adds the grad norm's two squares."""
    B, S, H, L = t["micro"], t["seq"], cfg.hidden_size, cfg.num_layers
    R = B * (S - 1)
    calls = t["gas"] * (5 * L + 5) + 1
    elems = t["gas"] * ((5 * L + 1) * B * S * H + 3 * R + R * H) + 2
    return {"tensor/all_reduce": (t["steps"] * calls, t["steps"] * elems)}


def tp2_want(t, cfg, adam_per_step):
    """TP3's launches in ``t["steps"]`` steps: flash fwd 2·L·gas (forward
    and recompute) and dq, dkv L·gas each, at the rank's heads; the norm
    (4L + 1)·gas; fused Adam; nothing else."""
    L, gas, n = cfg.num_layers, t["gas"], t["steps"]
    launches = {"flash_fwd": 2 * L * gas * n, "flash_bwd_dq": L * gas * n,
                "flash_bwd_dkv": L * gas * n,
                "rms_norm": (4 * L + 1) * gas * n,
                "fused_adam": adam_per_step * n, "quant_int8": 0,
                "dequant_reduce": 0, "block_sparse_fwd": 0, "gmm": 0,
                "tgmm": 0, "evoformer_fwd": 0, "paged_attention": 0}
    T = t["mesh"]["tensor"]
    shapes = [(t["micro"], t["seq"], cfg.num_heads // T, cfg.head_dim)]
    return launches, shapes


def tp2_gate_problems(g, ref):
    """TP1-TP2's verdicts."""
    problems = []
    if "tp1_fp32" in g:
        problems += [f"tp1: {k} {g['tp1_fp32'][k]:.3g} > {v}"
                     for k, v in SP2_LIMITS.items()
                     if not g["tp1_fp32"][k] <= v]
    if "tp2_bf16" in g:
        b = g["tp2_bf16"]
        loss_rel = abs(b["loss"] - ref["bf16"]["loss"]) / abs(
            ref["bf16"]["loss"])
        if not loss_rel <= TRAIN_LOSS_REL:
            problems.append(f"tp2: first loss {loss_rel:.3g} from one "
                            f"process's bf16 loss > {TRAIN_LOSS_REL}")
        limit = BF16_VS_PLAIN * ref["bf16_plain"]["update_rel"]
        if not b["update_rel"] <= limit:
            problems.append(f"tp2: update {b['update_rel']:.4g} from fp32 > "
                            f"{BF16_VS_PLAIN} x the plain bf16 path's")
    return problems


def tp2_problems(label, t, ranks, ref, cfg):
    """One way's verdicts, rank by rank: TP3's launches, traffic and flash
    shapes, the loss falling, TP4's sizes and peak, TP1-TP2."""
    launches, shapes = tp2_want(t, cfg, ranks[0]["main"]["adam_per_step"])
    traffic = tp2_traffic_want(t, cfg)
    params_want = tp_local_params(cfg, t["mesh"]["tensor"])
    problems = []
    for r in ranks:
        m, tag = r["main"], f"({label}) rank {r['rank']}"
        problems += [f"{tag}: {k} launched {m['launches'][k]} times, want "
                     f"{v}" for k, v in launches.items()
                     if m["launches"][k] != v]
        for key, (calls, elems) in traffic.items():
            got = m["traffic"].get(key, [0, 0])[:2]
            if got != [calls, elems]:
                problems.append(f"{tag}: TP3 {key} {got}, want "
                                f"{[calls, elems]}")
        # (the backward wrappers are not called on the CPU, where the
        # flash wrapper differentiates its plain version)
        fs = m["flash_shapes"]
        if fs["flash_fwd"] != shapes or any(v and v != shapes
                                            for v in fs.values()):
            problems.append(f"{tag}: flash shapes {fs}, want {shapes}")
        if m["losses"][-1] >= m["losses"][0] or not all(
                np.isfinite(m["losses"])):
            problems.append(f"{tag}: losses {m['losses']}")
        # TP4: the rank's parameters and its master's elements
        if m["params_local"] != params_want or m["master_local"] \
                != params_want // m["shard_world"]:
            problems.append(f"{tag}: TP4 {m['params_local']} parameters, "
                            f"{m['master_local']} master elements; want "
                            f"{params_want} and {params_want} / "
                            f"{m['shard_world']}")
        if not m["fwd_bwd_peak_bytes"] < \
                ref["one_process_fwd_bwd_peak_bytes"] and \
                m["fwd_bwd_peak_bytes"]:
            problems.append(f"{tag}: TP4 forward-backward peak "
                            f"{m['fwd_bwd_peak_bytes']} not below one "
                            f"process's "
                            f"{ref['one_process_fwd_bwd_peak_bytes']}")
        problems += [f"{tag}: {p}" for p in tp2_gate_problems(r["gates"],
                                                              ref)]
    return problems


def train_llama_750m_tp2_rank(rank, world, seed, t):
    """One rank of the tensor-parallel training phase (``t``: TP2 or its
    way (b), the depth, the device and the one-process reference): the
    main path and a profiled step, the rank's parameter and state sizes,
    then the gate steps."""
    import torch

    dev = torch.device(t["device"])
    engine, data, out = sp2_run(t, dev, "flash", sp2_batch(t, seed))
    out["profile"] = zeropp_profile(
        engine, data, dev, profiled=rank == 0 and dev.type == "cuda")
    out["tensor_host_s_per_step"] = sum(
        v[2] for k, v in out["traffic"].items()
        if k.startswith("tensor/")) / t["steps"]
    out["params_local"] = sum(s.numel for s in engine._slots)
    out["master_local"] = sum(sh.n_loc for sh in engine._shards)
    out["shard_world"] = engine.shard_world
    out["state_bytes"] = {
        name: buf.numel() * buf.element_size() for name, buf in (
            ("master", engine.flat_master),
            ("exp_avg", engine.state["opt"]["exp_avg"]),
            ("exp_avg_sq", engine.state["opt"]["exp_avg_sq"]),
            ("grad_acc", engine.flat_grad_acc),
            ("compute", engine.flat_compute),
            ("compute_shard", engine._shard_compute)) if buf is not None}
    engine.close()
    del engine, data
    dev_free(dev)
    gates = sp2_gates(t, dev, t["ref"], TP2_GATES)
    return {"rank": rank, "main": out, "gates": gates}


# --------------------------------------------------------------------------- #
# The pipeline phase (train_llama_750m_pp2)
# --------------------------------------------------------------------------- #
# train_llama_750m_pp2: llama_750m at full width (hidden 1536, 12 heads of
# 128, SwiGLU 4096, vocab 32000), bf16 with an fp32 master, flash
# attention, remat full, Adam lr 1e-4, ZeRO-1, the 1F1B schedule with
# M = 4 pipeline micro-batches of 1 row x 2048 tokens a step's micro-batch
# (global micro 4), gas 2; one timed step after a warm-up, then one more
# profiled on rank 0. Ways: (a) {pipe: 2}, PP2_LAYERS layers (each stage
# PP2_LAYERS / 2), two ranks; (b) {pipe: 2, tensor: 2} at PP2_GATE_LAYERS
# layers and gas 1, four ranks (flash at a tensor rank's 6 heads), no
# profiled step. Gates:
# PP1 one fp32 step of each way at PP2_GATE_LAYERS layers against one
#     process (flash, the exact loss the pipelined head computes) on the
#     same weights and masked batch: loss, grad norm, the whole gradient
#     (every stage's layers gathered) and the update within PP1_LIMITS;
# PP2 bf16 (a): its first loss (the warm-up step's, before any update) no
#     further from one process's bf16 loss on the same weights and batch
#     than BF16_VS_PLAIN times the one-process plain bf16 path's (a
#     distance below TRAIN_LOSS_REL counting as that);
# PP3 a rank's launches a step by formula (pp2_want: the no-grad forward,
#     the VJP's forward and its recompute on every stage but the last,
#     which skips the first) and the stage hops (pp_hops_want: M·gas
#     activations sent by every stage but the last, M·gas cotangents by
#     every stage but the first; the pipeline's sums one a run and the
#     norm's one a step);
# PP4 each rank's parameters the stage-local count (pp_local_params) and,
#     at PP2_GATE_LAYERS layers, 1F1B's forward-backward peak above the
#     resident state at M = 8 within PP4_GROWTH of M = 4's with the same
#     1-row micro-batch (O(P) activations); GPipe's at M = 4 beside them.
PP2 = dict(model="llama_750m", world=2, mesh={"pipe": 2}, micro=4,
           seq=2048, gas=2, steps=1, zero={"stage": 1},
           spec={"pipeline_schedule": "1f1b", "pipeline_micro_batches": 4,
                 "loss_impl": "exact"})
# cut from 20 for the script's time: with (a) at 20 layers the whole
# script took 1,044.8 s on an H100, past 950; at 10 it took 1,016.9 s
# there and was stopped past 1,200 s on another
PP2_LAYERS = 4
PP2_GATE_LAYERS = 4
# way (b) at gas 1 and without the profiled step, for the script's time
PP2_B = dict(world=4, mesh={"pipe": 2, "tensor": 2}, gas=1, profile=False)
PP2_GATES = {"pp1_fp32": ("fp32", "flash")}
PP1_LIMITS = {"loss_rel": 1e-6, "norm_rel": 1e-5, "grad_rel": 1e-5,
              "update_rel": TRAIN_UPDATE_REL, "sign_miss": TRAIN_SIGN_MISS}
PP4_GROWTH = 1.15
# PP4's runs at PP2_GATE_LAYERS layers, gas 1: (label, schedule, M)
PP4_RUNS = (("1f1b_m4", "1f1b", 4), ("1f1b_m8", "1f1b", 8),
            ("gpipe_m4", "gpipe", 4))


def pp2_b(t):
    """Way (b)'s settings from the phase's: PP2_B's mesh, gas 1, no
    profiled step, the gate depth, the same global micro-batch (the tensor
    ranks of a stage share it)."""
    return dict(t, **PP2_B, layers=PP2_GATE_LAYERS)


def pp_local_params(cfg, P, T=1):
    """A rank's parameters by formula: its stage's L/P layers and every
    leaf outside the layers (the embedding, the final norm, the head),
    each cut by the tensor axis as ``tp_local_params`` reckons."""
    import dataclasses

    return tp_local_params(
        dataclasses.replace(cfg, num_layers=cfg.num_layers // P), T)


def pp_hops_want(P, M, runs, stage):
    """PP3's stage hops of ``runs`` 1F1B schedules on ``stage``: the
    activations it sends (to stage + 1), the cotangents it sends (to stage
    − 1) and its exchanges (the ticks it sends or receives on), from the
    schedule's ticks (``parallel/pipeline.pipelined_train_1f1b``)."""
    act = cot = ex = 0
    lag = 2 * (P - 1) - stage
    for t in range(M + 2 * P - 2):
        sends_f = stage < P - 1 and 0 <= t - stage < M
        sends_b = stage > 0 and 0 <= t - lag < M
        recv_f = stage > 0 and 0 <= t - (stage - 1) < M
        recv_b = stage < P - 1 and 0 <= t - (lag - 1) < M
        act += sends_f
        cot += sends_b
        ex += sends_f or sends_b or recv_f or recv_b
    return {"activation": act * runs, "cotangent": cot * runs,
            "exchange": ex * runs}


def pp2_want(t, cfg, stage, adam_per_step):
    """PP3's launches of ``stage`` in ``t["steps"]`` steps (remat full, the
    1F1B schedule over M·gas pipeline micro-batches a step, L/P layers a
    stage): flash fwd 3 a layer a micro-batch on every stage but the last
    (the no-grad forward, the VJP's forward, its recompute), 2 on the last
    (no no-grad forward), dq and dkv 1; the norm 2 a layer a forward pass,
    the last stage's final norm once a micro-batch; fused Adam; nothing
    else. The flash shape: a pipeline micro-batch at a tensor rank's
    heads."""
    P, M = t["mesh"]["pipe"], t["spec"]["pipeline_micro_batches"]
    L, n = cfg.num_layers // P, M * t["gas"] * t["steps"]
    last = stage == P - 1
    launches = {"flash_fwd": (2 if last else 3) * L * n,
                "flash_bwd_dq": L * n, "flash_bwd_dkv": L * n,
                "rms_norm": ((4 * L + 1) if last else 6 * L) * n,
                "fused_adam": adam_per_step * t["steps"], "quant_int8": 0,
                "dequant_reduce": 0, "block_sparse_fwd": 0, "gmm": 0,
                "tgmm": 0, "evoformer_fwd": 0, "paged_attention": 0}
    T = t["mesh"].get("tensor", 1)
    shapes = [(t["micro"] // M, t["seq"], cfg.num_heads // T, cfg.head_dim)]
    return launches, shapes


def pp2_traffic_want(t, cfg, stage):
    """PP3's ``pipe`` group calls in ``t["steps"]`` steps: the hops
    (``pp_hops_want``, elements a pipeline micro-batch's [b, S, H]) and the
    all-reduces: the schedule's sum of the loss and the extras' gradients
    once a run, the grad norm's once a step."""
    P, M = t["mesh"]["pipe"], t["spec"]["pipeline_micro_batches"]
    runs = t["gas"] * t["steps"]
    hops = pp_hops_want(P, M, runs, stage)
    act = t["micro"] // M * t["seq"] * cfg.hidden_size
    return {"pipe/activation": [hops["activation"], hops["activation"] * act],
            "pipe/cotangent": [hops["cotangent"], hops["cotangent"] * act],
            "pipe/exchange": [hops["exchange"], None],
            "pipe/all_reduce": [runs + t["steps"], None]}


def pp2_reference(t, dev, seed, path):
    """One process: PP1's fp32 step at PP2_GATE_LAYERS layers on the masked
    gate batch (its whole gradient and update in numpy files beside
    ``path``), and PP2's first-step losses at the phase's depth on the
    main path's batch, from the seed's weights in bf16 (the master's
    compute copy): with the kernels and with the plain versions (forward
    only, the exact loss the pipelined head computes); each part's
    seconds."""
    import torch

    t0 = time.perf_counter()
    tg = dict(t, layers=PP2_GATE_LAYERS)
    engine = sp2_engine(tg, dev, "fp32", "flash", t["micro"], 1)
    loss, norm, grad, upd, _, _ = moe_ep_step(
        engine, sp2_batch(tg, seed, masked=True), 0, dev)
    del engine
    np.save(path + ".grad.npy", grad.cpu().numpy())
    np.save(path + ".upd.npy", upd.cpu().numpy())
    out = {"loss": loss, "norm": norm, "grad_path": path + ".grad.npy",
           "upd_path": path + ".upd.npy"}
    del grad, upd
    dev_free(dev)
    out["seconds"] = {"pp1_step": time.perf_counter() - t0}
    t0 = time.perf_counter()
    engine = sp2_engine(t, dev, "bf16", "flash", t["micro"], 1)
    mb = {k: torch.from_numpy(v).to(dev)
          for k, v in sp2_batch(t, seed).items()}
    with torch.no_grad():
        for label, kernels in (("bf16", True), ("bf16_plain", False)):
            out[f"first_loss_{label}"] = float(sp2_spec(
                t, "bf16", "flash", use_kernels=kernels).loss_fn(
                    engine._params, mb))
    del engine
    dev_free(dev)
    out["seconds"]["pp2_losses"] = time.perf_counter() - t0
    return out


def pp4_peaks(t, dev, seed):
    """PP4's forward-backward peaks above the resident state at
    PP2_GATE_LAYERS layers, bf16, gas 1, a 1-row pipeline micro-batch:
    one step to warm up, then the measured one, for each of PP4_RUNS."""
    import itertools

    out = {}
    for label, sched, M in PP4_RUNS:
        tm = dict(t, layers=PP2_GATE_LAYERS, micro=M, gas=1, spec=dict(
            t["spec"], pipeline_schedule=sched, pipeline_micro_batches=M))
        engine = sp2_engine(tm, dev, "bf16", "flash", M, 1, mesh=t["mesh"])
        data = itertools.repeat(sp2_batch(tm, seed))
        t0 = time.perf_counter()
        engine.train_batch(data)
        dev_sync(dev)
        out["first_step_s"] = out.get("first_step_s", []) + [
            time.perf_counter() - t0]
        resident = dev_allocated(dev)
        dev_peak(dev, reset=True)
        engine.train_batch(data)
        dev_sync(dev)
        out[label] = dev_peak(dev) - resident
        engine.close()
        del engine, data
        dev_free(dev)
    return out


def pp2_problems(label, t, ranks, ref, cfg):
    """One way's verdicts, rank by rank: PP3's launches, hops and flash
    shapes, the loss falling, PP4's sizes and peaks, PP1 (and PP2 at
    way (a))."""
    problems = []
    T = t["mesh"].get("tensor", 1)
    params_want = pp_local_params(cfg, t["mesh"]["pipe"], T)
    for r in ranks:
        m, tag = r["main"], f"({label}) rank {r['rank']}"
        stage = m["coords"]["pipe"]
        launches, shapes = pp2_want(t, cfg, stage, m["adam_per_step"])
        problems += [f"{tag}: {k} launched {m['launches'][k]} times, want "
                     f"{v}" for k, v in launches.items()
                     if m["launches"][k] != v]
        for key, (calls, elems) in pp2_traffic_want(t, cfg, stage).items():
            got = m["traffic"].get(key, [0, 0])[:2]
            if got[0] != calls or (elems is not None and got[1] != elems):
                problems.append(f"{tag}: PP3 {key} {got}, want "
                                f"{[calls, elems]}")
        # (the backward wrappers are not called on the CPU, where the
        # flash wrapper differentiates its plain version)
        fs = m["flash_shapes"]
        if fs["flash_fwd"] != shapes or any(v and v != shapes
                                            for v in fs.values()):
            problems.append(f"{tag}: flash shapes {fs}, want {shapes}")
        if m["losses"][-1] >= m["losses"][0] or not all(
                np.isfinite(m["losses"])):
            problems.append(f"{tag}: losses {m['losses']}")
        if m["params_local"] != params_want:
            problems.append(f"{tag}: PP4 {m['params_local']} parameters, "
                            f"want {params_want}")
        peaks = r.get("pp4")
        if peaks and peaks["1f1b_m4"] and not peaks["1f1b_m8"] <= \
                PP4_GROWTH * peaks["1f1b_m4"]:
            problems.append(f"{tag}: PP4 1F1B peak at M = 8 "
                            f"{peaks['1f1b_m8']} > {PP4_GROWTH} x M = 4's "
                            f"{peaks['1f1b_m4']}")
        g = r["gates"]["pp1_fp32"]
        problems += [f"{tag}: PP1 {k} {g[k]:.3g} > {v}"
                     for k, v in PP1_LIMITS.items() if not g[k] <= v]
        if t.get("pp2_gate"):
            d, limit = pp2_distance(m["losses"][0], ref)
            if not d <= limit:
                problems.append(f"{tag}: PP2 first loss {d:.3g} from one "
                                f"process's bf16 loss > {limit:.3g}")
    return problems


def pp2_distance(loss, ref):
    """PP2: (the bf16 pipelined loss's relative distance from one
    process's bf16 loss, its limit: BF16_VS_PLAIN x the plain bf16 path's
    distance, or TRAIN_LOSS_REL where that is less)."""
    one = ref["first_loss_bf16"]
    plain = abs(ref["first_loss_bf16_plain"] - one) / abs(one)
    return abs(loss - one) / abs(one), BF16_VS_PLAIN * max(plain,
                                                           TRAIN_LOSS_REL)


def train_llama_750m_pp2_rank(rank, world, seed, t):
    """One rank of the pipeline phase (``t``: PP2 or its way (b), the
    depth, the device and the one-process reference): the main path, a
    profiled step whose 1F1B runs are timed for the measured bubble, the
    rank's sizes, PP4's peaks (way (a)) and PP1's gate step."""
    import torch

    from deepspeed_tpu_torch.parallel import pipeline as PL

    dev = torch.device(t["device"])
    stats = {}

    @contextlib.contextmanager
    def timed():
        # the timed steps' 1F1B runs: the measured bubble
        PL.tick_stats = stats
        try:
            yield
        finally:
            PL.tick_stats = None

    t0 = time.perf_counter()
    PL.tick_stats = warm = {}
    try:
        engine, data, out = sp2_run(t, dev, "flash", sp2_batch(t, seed),
                                    timed)
    finally:
        PL.tick_stats = None
    out["bubble_measured"] = 1 - stats["compute_s"] / stats["wall_s"]
    out["pipeline_runs_timed"] = stats
    out["pipeline_runs_warmup"] = warm
    seconds = {"main": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out["profile"] = zeropp_profile(
        engine, data, dev, profiled=rank == 0 and dev.type == "cuda") \
        if t.get("profile", True) else {"device_idle_share": "not measured"}
    seconds["profile"] = time.perf_counter() - t0
    out["pipe_host_s_per_step"] = sum(
        v[2] for k, v in out["traffic"].items()
        if k.startswith("pipe/")) / t["steps"]
    out["params_local"] = sum(s.numel for s in engine._slots)
    out["state_bytes"] = {
        name: buf.numel() * buf.element_size() for name, buf in (
            ("master", engine.flat_master),
            ("exp_avg", engine.state["opt"]["exp_avg"]),
            ("exp_avg_sq", engine.state["opt"]["exp_avg_sq"]),
            ("grad_acc", engine.flat_grad_acc),
            ("compute", engine.flat_compute),
            ("grad32", getattr(engine, "flat_grad32", None)),
            ("compute_shard", engine._shard_compute)) if buf is not None}
    engine.close()
    del engine, data
    dev_free(dev)
    t0 = time.perf_counter()
    pp4 = pp4_peaks(t, dev, seed) if t.get("pp4") else None
    seconds["pp4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gates = sp2_gates(dict(t, layers=PP2_GATE_LAYERS), dev, t["ref"],
                      PP2_GATES)
    seconds["pp1"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return {"rank": rank, "main": out, "gates": gates, "pp4": pp4}


# --------------------------------------------------------------------------- #
# The pipe axis composed (train_llama_750m_pp_compose)
# --------------------------------------------------------------------------- #
# train_llama_750m_pp_compose: the pipe axis beside ZeRO-3, seq, expert and
# the offload tier, full width, PPC_LAYERS layers (PPC_LAYERS / 2 a stage),
# bf16 with an fp32 master, remat full, 1F1B with M = 4 pipeline
# micro-batches of 1 row a batch rank, gas 2; a warm-up step, one timed
# step, a profiled one on rank 0. Ways, each with its own gates:
# (a) llama_750m at {pipe: 2, data: 2}, ZeRO-3 (exact wire, the chunks of
#     the stage's layers), beside ZeRO-2 at the same mesh: PC1 one fp32
#     step against ZeRO-2's by the training rule (SP2_LIMITS); PC2 the
#     bf16 step's loss within TRAIN_LOSS_REL of ZeRO-2's and its update
#     from the fp32 ZeRO-2 step no further than BF16_VS_PLAIN x ZeRO-2's
#     bf16 one;
#     PC3 the gathers and reduces a step by formula (ppc_zero3_want); PC4
#     the peak a rank below ZeRO-2's by PPC_MEMORY_SHARE of the reckoned
#     margin (ppc_memory_margin);
# (b) llama_750m at {pipe: 2, seq: 2}, Ulysses around the flash kernels:
#     PC5 one fp32 step against the same rows at {pipe: 2, data: 2} with
#     flash (the same pipeline micro-batches) by the training rule; the seq
#     group's all-to-alls by formula (ppc_seq_want);
# (c) moe_350m at {pipe: 2, expert: 2} (its 1,024 tokens a row): PC6 one
#     fp32 step against the same rows at {pipe: 2, data: 2} by the
#     training rule, routing agreement >= ROUTE_AGREE_MIN and the aux loss
#     within TRAIN_LOSS_REL; the grouped GEMMs launched, and on a rank's
#     first received buffer against their plain versions (ep_buffer_gate);
# (d) llama_750m at {pipe: 2}, ZeRO-1 with offload_optimizer cpu (world 2):
#     PC7 the losses and the master's and moments' fingerprints bit-equal
#     to the same run without offload.
# Every way: the launches of flash and the norm by pp2_want's formula (the
# same schedule), step ms, tokens/s, MFU, the peak a rank, rank 0's idle
# share, and the pipe, seq and expert groups' host seconds a step.
PPC = dict(model="llama_750m", world=4, micro=4, seq=2048, gas=2, steps=1,
           zero={"stage": 1}, spec=dict(PP2["spec"]))
# cut from 4 for the script's time: with every way at 4 layers (way (a)'s
# gates at 2) the whole script took 947.1 s on an H100, at the 950 s mark
PPC_LAYERS = 2
PPC_WAYS = {
    "a": dict(mesh={"pipe": 2, "data": 2}, zero={"stage": 3},
              baseline={"stage": 2}),
    "b": dict(mesh={"pipe": 2, "seq": 2}, attention="ulysses_flash",
              ref_mesh={"pipe": 2, "data": 2}),
    "c": dict(model="moe_350m", seq=1024, mesh={"pipe": 2, "expert": 2},
              ref_mesh={"pipe": 2, "data": 2}),
    "d": dict(world=2, mesh={"pipe": 2}, zero={
        "stage": 1, "offload_optimizer": {"device": "cpu"}},
        baseline={"stage": 1})}
PPC_MEMORY_SHARE = 0.75


def ppc_way(t, label):
    """Way ``label``'s settings from the phase's."""
    return dict(t, **PPC_WAYS[label], way=label)


def ppc_zero3_want(t, chunks, stage):
    """PC3: a ZeRO-3 rank's gathers and reduces in ``t["steps"]`` steps
    of 1F1B (remat full): the head group (the extras) gathered once a
    schedule and reduced once (their sums over pipe); each of the stage's
    ``chunks`` gathered in the no-grad forward (not on the last stage), in
    each VJP's forward and in its recompute, and reduced once a VJP."""
    P, M = t["mesh"]["pipe"], t["spec"]["pipeline_micro_batches"]
    runs = t["gas"] * t["steps"]
    last = stage == P - 1
    return {"gather_fwd": runs * (1 + M * chunks * (1 if last else 2)),
            "gather_bwd": runs * M * chunks,
            "reduce": runs * (M * chunks + 1)}


def ppc_memory_margin(cfg, P, chunk_layers):
    """PC4's reckoned margin (bytes) of ZeRO-3 below ZeRO-2 at {pipe: P,
    data: D} (any D): what ZeRO-2 holds that ZeRO-3 does not — the
    stage's whole compute copy (bf16) and micro-batch gradient (bf16),
    1F1B's fp32 gradient buffer, the packed fp32 rows of the reduce ([D,
    N / D]) and the schedule's fp32 sums of the stage's layers — less
    what ZeRO-3 gathers for a step: the head group (bf16, a schedule
    long), two layer chunks (bf16) and two chunks' reduce rows (fp32) in
    flight."""
    import dataclasses

    stage = dataclasses.replace(cfg, num_layers=cfg.num_layers // P)
    n = tp_local_params(stage, 1)
    n_ex = tp_local_params(dataclasses.replace(stage, num_layers=0), 1)
    n_blk = n - n_ex
    n_chunk = n_blk // stage.num_layers * chunk_layers
    return (2 + 2 + 4 + 4) * n + 4 * n_blk - 2 * n_ex - (2 + 4) * 2 * n_chunk


def ppc_seq_want(t, cfg, stage):
    """The seq group's all-to-alls a rank makes in ``t["steps"]`` steps:
    Ulysses scatters q, k, v and gathers o (4 calls of B S/sp (2N + 2K) D
    elements in all) in each pass over a layer — the no-grad forward (not
    on the last stage), each VJP's forward, its recompute and its
    backward."""
    P, M, sp = (t["mesh"]["pipe"], t["spec"]["pipeline_micro_batches"],
                t["mesh"]["seq"])
    L = cfg.num_layers // P
    passes = (3 if stage == P - 1 else 4) * L * M * t["gas"] * t["steps"]
    b = t["micro"] // M
    elems = b * t["seq"] // sp * (2 * cfg.num_heads + 2 * cfg.kv_heads) \
        * cfg.head_dim
    return {"seq/all_to_all": [4 * passes, passes * elems]}


def ppc_host_seconds(traffic, steps):
    """Each group's host seconds a step (comm.traffic's third column)."""
    out = {}
    for k, v in traffic.items():
        g = k.split("/")[0]
        out[g] = out.get(g, 0.0) + v[2] / steps
    return {g: out.get(g, 0.0) for g in ("pipe", "seq", "expert")}


def ppc_main(t, dev, attention, batch, rank, profile=True):
    """One main-path run of a way (``sp2_run``): the timed step's launches,
    traffic and peak, the groups' host seconds, rank 0's profiled step."""
    engine, data, out = sp2_run(t, dev, attention, batch)
    if t["way"] == "d":
        # PC7: the state after the main path's steps (before any other)
        out["fingerprints"] = state_fingerprints(engine)
    out["host_s_per_step"] = ppc_host_seconds(out["traffic"], t["steps"])
    out["peak_bytes"] = out["resident_bytes"] + out["fwd_bwd_peak_bytes"]
    out["params_local"] = sum(s.numel for s in engine._slots)
    z = getattr(engine, "_zero3", None)
    if z is not None:
        out["zero3_counts"] = dict(z.counts)
        out["chunks"] = len(z.groups) - 1
        out["n_local"] = engine.flat_master.numel()
    out["profile"] = zeropp_profile(
        engine, data, dev, profiled=rank == 0 and dev.type == "cuda") \
        if profile else {"device_idle_share": "not measured"}
    return engine, data, out


def ppc_gate_step(t, dev, batch, zero, precision, attention, mesh, L=0):
    """One step from the seed's weights at ``mesh`` (gas 1): loss, norm,
    the whole gradient and update, and under MoE every routed call's
    routes and their summed aux (``moe_ep_step``)."""
    engine = sp2_engine(dict(t, zero=zero), dev, precision, attention,
                        t["micro"], 1, mesh=mesh)
    res = moe_ep_step(engine, batch, L, dev)
    engine.close()
    del engine
    dev_free(dev)
    return res


@timed_part
def ppc_gates(t, dev, seed):
    """The way's gate steps → {gate: training-rule metrics}: (a) ZeRO-3's
    fp32 and both bf16 steps against ZeRO-2's fp32 one; (b), (c) the
    way's fp32 step against the same rows at {pipe: 2, data: 2}."""
    w = t["way"]
    out = {}
    if w == "a":
        gate = sp2_batch(t, seed, masked=True)
        ref = None
        for label, zero, prec in (("z2_fp32", t["baseline"], "fp32"),
                                  ("z3_fp32", t["zero"], "fp32"),
                                  ("z2_bf16", t["baseline"], "bf16"),
                                  ("z3_bf16", t["zero"], "bf16")):
            loss, norm, grad, upd, _, _ = ppc_gate_step(
                t, dev, gate, zero, prec, "flash", t["mesh"])
            if ref is None:
                ref = {"loss": loss, "norm": norm, "grad": grad, "upd": upd}
            else:
                out[label] = step_metrics(loss, norm, grad, upd, None, None,
                                          ref)
            del grad, upd
        del ref
    elif w in ("b", "c"):
        L = 10 ** 6 if w == "c" else 0     # every routed call's routes
        # the same rows in both: M pipeline micro-batches of 2 rows
        tr = dict(t, mesh=t["ref_mesh"])
        gate = sp2_batch(tr, seed, masked=True)
        ref = dict(zip(("loss", "norm", "grad", "upd", "idx", "aux"),
                       ppc_gate_step(tr, dev, gate, t["zero"], "fp32",
                                     "flash", t["ref_mesh"], L)))
        # micro rows a batch rank of the way's mesh
        ta = dict(t, micro=len(gate["tokens"]) // int(np.prod(
            [t["mesh"].get(a, 1) for a in ("data", "zshard", "expert")])))
        out["pc_fp32"] = step_metrics(*ppc_gate_step(
            ta, dev, gate, t["zero"], "fp32", t.get("attention", "flash"),
            t["mesh"], L), ref)
        del ref
    dev_free(dev)
    return out


def train_llama_750m_pp_compose_rank(rank, world, seed, t):
    """One rank of way ``t["way"]`` of the composed pipe phase: its main
    path (and the ZeRO-2 / no-offload baseline's), what its gates need."""
    import torch

    dev = torch.device(t["device"])
    w = t["way"]
    batch = sp2_batch(t, seed)
    out = {"rank": rank, "way": w}
    if w == "c":
        with ep_buffer_capture() as cap:
            engine, data, out["main"] = ppc_main(t, dev, "flash", batch,
                                                 rank)
        out["ep_buffer"] = ep_buffer_gate(cap, dev)
        del cap
    else:
        engine, data, out["main"] = ppc_main(
            t, dev, t.get("attention", "flash"), batch, rank)
    engine.close()
    del engine, data
    dev_free(dev)
    if t.get("baseline"):
        engine, data, out["baseline"] = ppc_main(
            dict(t, zero=t["baseline"]), dev, "flash", batch, rank,
            profile=False)
        out["baseline"]["state_bytes"] = {
            name: buf.numel() * buf.element_size() for name, buf in (
                ("compute", engine.flat_compute),
                ("grad", engine.flat_grad),
                ("grad32", getattr(engine, "flat_grad32", None)),
                ("packed", engine._packed)) if buf is not None}
        engine.close()
        del engine, data
        dev_free(dev)
    out["gates"] = ppc_gates(t, dev, seed)
    return out


def ppc_problems(t, ranks, cfg):
    """One way's verdicts, rank by rank."""
    w = t["way"]
    problems = []
    P = t["mesh"]["pipe"]
    for r in ranks:
        m, tag = r["main"], f"({w}) rank {r['rank']}"
        stage = m["coords"]["pipe"]
        launches, shapes = pp2_want(t, cfg, stage, m["adam_per_step"])
        if cfg.norm != "rmsnorm":       # moe_350m's LayerNorm
            launches["layer_norm"] = launches.pop("rms_norm")
            launches["rms_norm"] = 0
        keys = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rms_norm",
                "layer_norm", "fused_adam", "quant_int8", "dequant_reduce")
        problems += [f"{tag}: {k} launched {m['launches'][k]} times, want "
                     f"{launches.get(k, 0)}" for k in keys
                     if m["launches"][k] != launches.get(k, 0)]
        if m["losses"][-1] >= m["losses"][0] or not all(
                np.isfinite(m["losses"])):
            problems.append(f"{tag}: losses {m['losses']}")
        if w == "a":
            want = ppc_zero3_want(t, m["chunks"], stage)
            if m["zero3_counts"] != want:
                problems.append(f"{tag}: PC3 ZeRO-3 counts "
                                f"{m['zero3_counts']}, want {want}")
            g = r["gates"]
            problems += [f"{tag}: PC1 {k} {g['z3_fp32'][k]:.3g} > {v}"
                         for k, v in SP2_LIMITS.items()
                         if not g["z3_fp32"][k] <= v]
            lrel = abs(g["z3_bf16"]["loss"] - g["z2_bf16"]["loss"]) \
                / abs(g["z2_bf16"]["loss"])
            if not lrel <= TRAIN_LOSS_REL:
                problems.append(f"{tag}: PC2 bf16 loss {lrel:.3g} from "
                                f"ZeRO-2's > {TRAIN_LOSS_REL}")
            limit = BF16_VS_PLAIN * g["z2_bf16"]["update_rel"]
            if not g["z3_bf16"]["update_rel"] <= limit:
                problems.append(f"{tag}: PC2 bf16 update "
                                f"{g['z3_bf16']['update_rel']:.4g} > "
                                f"{BF16_VS_PLAIN} x ZeRO-2's")
            margin = ppc_memory_margin(cfg, P,
                                       cfg.num_layers // P // m["chunks"])
            saved = r["baseline"]["peak_bytes"] - m["peak_bytes"]
            if t["device"].startswith("cuda") and \
                    not saved >= PPC_MEMORY_SHARE * margin:
                problems.append(f"{tag}: PC4 peak {m['peak_bytes']} only "
                                f"{saved} below ZeRO-2's, want >= "
                                f"{PPC_MEMORY_SHARE} x {margin}")
        if w in ("b", "c"):
            g = r["gates"]["pc_fp32"]
            limits = dict(SP2_LIMITS) if w == "b" else dict(
                SP2_LIMITS, route_miss=1 - ROUTE_AGREE_MIN,
                aux_rel=TRAIN_LOSS_REL)
            problems += [f"{tag}: PC{5 if w == 'b' else 6} {k} {g[k]:.3g} "
                         f"> {v}" for k, v in limits.items()
                         if not g[k] <= v]
        if w == "b":
            for key, (calls, elems) in ppc_seq_want(t, cfg, stage).items():
                got = m["traffic"].get(key, [0, 0])[:2]
                if got != [calls, elems]:
                    problems.append(f"{tag}: {key} {got}, want "
                                    f"{[calls, elems]}")
            want = [(t["micro"] // t["spec"]["pipeline_micro_batches"],
                     t["seq"], cfg.num_heads // t["mesh"]["seq"],
                     cfg.head_dim)]
            if m["flash_shapes"]["flash_fwd"] != want:
                problems.append(f"{tag}: flash shapes {m['flash_shapes']}, "
                                f"want {want}")
        if w == "c":
            if not (m["launches"]["gmm"] and m["launches"]["tgmm"]):
                problems.append(f"{tag}: gmm launched "
                                f"{m['launches']['gmm']} times, tgmm "
                                f"{m['launches']['tgmm']}, want both > 0")
            e = r["ep_buffer"]
            if not (e["gmm_close"] and e["tgmm_close"] and e["tail_zero"]):
                problems.append(f"{tag}: the received buffer's grouped GEMM "
                                f"against its plain version: {e}")
        if w == "d":
            b = r["baseline"]
            if m["losses"] != b["losses"] or any(
                    m["fingerprints"][k] != b["fingerprints"][k]
                    for k in ("master", "exp_avg", "exp_avg_sq")):
                problems.append(f"{tag}: PC7 offload {m['losses']} "
                                f"{m['fingerprints']} against "
                                f"{b['losses']} {b['fingerprints']}")
    return problems


# --------------------------------------------------------------------------- #
# The seq axis composed, and MoE on the tensor axis
# (train_sp_tp_moe_compose)
# --------------------------------------------------------------------------- #
# train_sp_tp_moe_compose: the seq axis beside hpZ, MoE and the host step,
# and MoE under the tensor axis, full width, STM_LAYERS layers, bf16 with
# an fp32 master, remat full, gas 2; a warm-up step, one timed step, a
# profiled one on rank 0. Ways, each with its own gates:
# (a) llama_750m hpZ ZeRO-3 at {zshard: 2, seq: 2}, Ulysses around the
#     flash kernels: SC1 one fp32 step against ZeRO-3 at {data: 2, seq:
#     2} on the same global batch by the training rule (SP2_LIMITS); SC2
#     each group's collectives and elements a step by formula — the
#     zshard gathers and reduce-scatters, the seq hop, the attentions' seq
#     all-to-alls, the norm's and the loss's sums (stm_hpz_traffic_want);
# (b) moe_350m at {expert: 2, seq: 2}, ZeRO-2, Ulysses around flash: SC3
#     one fp32 step against {data: 2, expert: 2} on the same rows by the
#     training rule, the routes (over the global batch) agreeing on at
#     least ROUTE_AGREE_MIN and the aux within TRAIN_LOSS_REL; the expert
#     and seq all-to-alls and the token group's sums by formula; the
#     grouped GEMM on a rank's first received buffer against its plain
#     version (role seq_expert_buffer);
# (c) llama_750m at {seq: 2}, ZeRO-1 with offload_optimizer cpu and the
#     sync host step (two ranks): SC4 one fp32 step against the same mesh
#     without offload, the loss bit-equal and the master within
#     HOST_SYNC_VS_PLAIN (relative L2), as SuperOffload's S1, and the
#     card's peak while the engine is built at least HOST_INIT_SAVED bytes
#     an element of the master below the device step's;
# (d) moe_350m (ragged) at {expert: 2, tensor: 2}, ZeRO-2, flash at a
#     rank's heads: SC5 one fp32 step against {data: 2, expert: 2} on the
#     same rows by the training rule, routes and aux as SC3; the tensor
#     group's all-reduces a step by formula, the MoE layer's included
#     (stm_tensor_traffic_want); SC6 the grouped GEMM over a rank's
#     received buffer and its [2, 768, 1536] expert slice against its
#     plain version (role tensor_expert_slice), and the peak a rank below
#     (e)'s;
# (e) moe_350m at {expert: 2} on the same global batch (two ranks): the
#     main path only, (d)'s peak and step time beside.
# Every way: the launches by formula, step ms, tokens/s, MFU (active
# parameters), the peak a rank, rank 0's idle share and the seq, expert,
# tensor and batch groups' host seconds a step. (a), (b), (d) run in the
# world-4 spawn, (c) and (e) in the world-2 spawn.
STM = dict(model="llama_750m", world=4, micro=2, seq=2048, gas=2, steps=1,
           zero={"stage": 1}, spec={})
STM_LAYERS = 2
STM_WAYS = {
    "a": dict(mesh={"zshard": 2, "seq": 2}, attention="ulysses_flash",
              zero={"stage": 3, "zero_hpz_partition_size": 2},
              ref_mesh={"data": 2, "seq": 2}, ref_zero={"stage": 3}),
    "b": dict(model="moe_350m", seq=1024, mesh={"expert": 2, "seq": 2},
              attention="ulysses_flash", zero={"stage": 2},
              ref_mesh={"data": 2, "expert": 2}, ref_zero={"stage": 2}),
    "c": dict(world=2, mesh={"seq": 2}, attention="ulysses_flash",
              zero={"stage": 1, "offload_optimizer": {
                  "device": "cpu", "host_step": True,
                  "overlap_step": False}},
              ref_mesh={"seq": 2}, ref_zero={"stage": 1}),
    "d": dict(model="moe_350m", seq=1024, mesh={"expert": 2, "tensor": 2},
              attention="flash", zero={"stage": 2},
              ref_mesh={"data": 2, "expert": 2}, ref_zero={"stage": 2}),
    "e": dict(world=2, model="moe_350m", seq=1024, mesh={"expert": 2},
              attention="flash", zero={"stage": 2})}
# SC4: the host step's fp32 master after one step against the device
# step's (relative L2; both run the same rounded fp32 operations but for
# PyTorch's CPU sqrt, as SuperOffload's S1)
HOST_SYNC_VS_PLAIN = 1e-6
# SC4: the bytes an element of the master that the host step's engine never
# puts on the card while it is built: the fp32 master and Adam's two fp32
# moments
HOST_INIT_SAVED = 12


def stm_way(t, label):
    """Way ``label``'s settings from the phase's."""
    return dict(t, **STM_WAYS[label], way=label)


def stm_batch_ranks(t):
    """The ranks over the batch axes (data × zshard × expert) of a way's
    mesh."""
    return int(np.prod([t["mesh"].get(a, 1)
                        for a in ("data", "zshard", "expert")]))


def stm_n_experts(t):
    """The way's model's experts (0: a dense model)."""
    from deepspeed_tpu_torch.models import transformer as T

    return T.get_model_config(t["model"]).n_experts


def stm_hpz_traffic_want(engine, t, cfg):
    """SC2: a ZeRO-3 rank's collectives in ``t["steps"]`` steps (remat
    full) → {group label/kind: [calls, elements it sends in]}: each
    gather group on the shard group in the forward, each layer chunk
    again in the recompute; each group's reduce-scatter on the shard
    group and its replica hop (``engine.hops``: ``seq`` under hpZ
    without data); the replicated leaves' mean; Ulysses' q, k, v and o on
    the attentions' seq group (``sp2_want``); the norm's sum on the shard
    group and the loss's mean."""
    from deepspeed_tpu_torch.comm import mesh as M

    want = {}
    shard = M.group_label(engine.shard_group)
    groups = engine._zero3.groups
    for _ in range(t["gas"]):
        for g in list(groups) + list(groups[1:]):    # fwd, recompute
            _add(want, f"{shard}/all_gather", 1, g.n_row)
        for g in groups:
            _add(want, f"{shard}/reduce_scatter", 1,
                 engine.shard_world * g.n_row)
            for grp, lo, hi in engine.hops(g.n_dense, g.n_row):
                _add(want, f"{M.group_label(grp)}/all_reduce", 1, hi - lo)
    if engine._n_rep:
        _add(want, "world/all_reduce", 1, engine._n_rep)
    _, seq, _ = sp2_want(t, cfg.num_layers, t["attention"], cfg, 0)
    for k, (calls, elems) in seq.items():
        _add(want, k, calls, elems)
    _add(want, f"{shard}/all_reduce", 1, 1)          # the norm's sum
    _add(want, "world/all_reduce", 1, 1)             # the loss's mean
    return {k: [c * t["steps"], e * t["steps"]] for k, (c, e) in want.items()}


def stm_moe_seq_traffic_want(t, cfg):
    """(b): the MoE layer's collectives (``moe_ep_traffic_want`` at a
    rank's tokens: its rows × its positions; the token group over
    ``expert`` and ``seq`` labelled ``batch``) and Ulysses' all-to-alls
    (``sp2_want``) in ``t["steps"]`` steps."""
    sp = t["mesh"]["seq"]
    want = moe_ep_traffic_want(cfg.num_layers, t["gas"], t["steps"],
                               t["micro"], t["seq"] // sp, cfg.moe_top_k,
                               t["mesh"]["expert"], cfg.hidden_size,
                               cfg.n_experts)
    _, seq, _ = sp2_want(t, cfg.num_layers, t["attention"], cfg, 0)
    want.update({k: [c * t["steps"], e * t["steps"]]
                 for k, (c, e) in seq.items()})
    return want


def stm_tensor_traffic_want(t, cfg, tp_classes):
    """SC5: the tensor group's all-reduces and their elements in
    ``t["steps"]`` steps (remat full, the fused loss). A micro-batch sums
    each layer's attention output (row-parallel) in the forward and again
    in the recompute, and its input's gradient (column-parallel) in the
    backward, each B·S·H; each MoE layer's received rows' outputs over
    the rank's ``mlp`` slices ([X·Cs, H], Cs = ep_shard_capacity(B·S·k,
    X)) in the forward and again in the recompute (its combine saves what
    the second all-to-all brings back), and its sent rows' gradient (B·S·H)
    in the backward; the vocab-parallel embedding's B·S·H; the loss's row
    maxima, sums of exponentials and picked logits, B·(S − 1) each, and
    its hidden state's gradient, B·(S − 1)·H. A step adds the global
    norm's squares of the ``tp_classes`` tensor-sliced leaf classes."""
    from deepspeed_tpu_torch.moe.layer import ep_shard_capacity

    B, S, H, L = t["micro"], t["seq"], cfg.hidden_size, cfg.num_layers
    X = t["mesh"]["expert"]
    R = B * (S - 1)
    rows = X * ep_shard_capacity(B * S * cfg.moe_top_k, X)
    calls = t["gas"] * (6 * L + 5) + 1
    elems = t["gas"] * (B * S * H + L * (4 * B * S * H + 2 * rows * H)
                        + 3 * R + R * H) + tp_classes
    return {"tensor/all_reduce": [t["steps"] * calls, t["steps"] * elems]}


def stm_global_routes(engine, idx, t):
    """The routes [L, rows, positions, k] over the global batch from every
    rank's routes of its tokens [L, b·s, k] (its rows at its batch index,
    its positions at its seq coordinate; a tensor rank's copy the same):
    gathered over the world (collective)."""
    import torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm import mesh as M

    mm = engine.mesh_manager
    Q = mm.sp_world_size
    L, n, k = idx.shape
    b = t["micro"]
    s = n // b
    rows = comm.all_gather(idx.contiguous(), tiled=False)     # [W, L, n, k]
    out = torch.empty(L, b * mm.batch_world_size, s * Q, k,
                      dtype=idx.dtype, device=idx.device)
    for r in range(mm.world_size):
        other = M.MeshManager(mm.shape, r)
        bi, q = other.batch_rank, other.coords["seq"]
        out[:, bi * b:(bi + 1) * b, q * s:(q + 1) * s] = rows[r].view(
            L, b, s, k)
    return out


def stm_gate_step(t, dev, batch, mesh, zero, attention, L):
    """One fp32 step from the seed's weights at ``mesh`` (gas 1): loss,
    norm, the whole gradient and update (``moe_ep_step``), the host
    step's first update landed; the routes over the global batch and the
    summed aux of a MoE model's first ``L`` routed calls; the card's peak
    bytes while the engine is built (above what was allocated before) and
    the master's elements."""
    micro = len(batch["tokens"]) // int(np.prod(
        [mesh.get(a, 1) for a in ("data", "zshard", "expert")]))
    base = dev_allocated(dev)
    dev_peak(dev, reset=True)
    engine = sp2_engine(dict(t, zero=zero, micro=micro), dev, "fp32",
                        attention, micro, 1, mesh=mesh)
    init = (dev_peak(dev) - base, engine.flat_master.numel())
    loss, norm, grad, upd, idx, aux = moe_ep_step(engine, batch, L, dev)
    if idx is not None:
        idx = stm_global_routes(engine, idx, dict(t, micro=micro))
    master = master_on(engine, dev) if t["way"] == "c" else None
    engine.close()
    del engine
    dev_free(dev)
    return loss, norm, grad, upd, idx, aux, master, init


@timed_part
def stm_gates(t, dev, seed):
    """The way's gate steps → {gate: metrics}: the way's fp32 step against
    its reference mesh's on one masked global batch (the training rule;
    routes and aux under MoE); (c): the host step's loss, master and peak
    while the engine is built against the device step's."""
    from deepspeed_tpu_torch.models import transformer as T

    if "ref_mesh" not in t:
        return {}
    gate = sp2_batch(t, seed, masked=True)
    cfg = T.get_model_config(t["model"], num_layers=t["layers"])
    L = cfg.num_layers if cfg.n_experts else 0
    ref_attention = "flash" if "seq" not in t["ref_mesh"] else \
        t["attention"]
    r = stm_gate_step(t, dev, gate, t["ref_mesh"], t["ref_zero"],
                      ref_attention, L)
    ref = dict(zip(("loss", "norm", "grad", "upd", "idx", "aux"), r[:6]))
    w = stm_gate_step(t, dev, gate, t["mesh"], t["zero"], t["attention"],
                      L)
    out = {"sc_fp32": step_metrics(*w[:6], ref)}
    if t["way"] == "c":
        out["sc_fp32"].update(
            loss_bit_equal=w[0] == r[0], master_rel_l2=rel_l2(w[6], r[6]),
            master_bit_equal=same_bits(w[6], r[6]),
            init_peak_bytes=w[7][0], ref_init_peak_bytes=r[7][0],
            master_elems=w[7][1])
    del ref, r, w
    dev_free(dev)
    return out


def train_sp_tp_moe_compose_rank(rank, world, seed, t):
    """One rank of way ``t["way"]`` of the composed seq / tensor phase: its
    main path (the received buffer captured under MoE), a profiled step on
    rank 0, then its gates."""
    import torch

    dev = torch.device(t["device"])
    w = t["way"]
    batch = sp2_batch(t, seed)
    out = {"rank": rank, "way": w}
    moe = bool(stm_n_experts(t)) and w != "e"
    with (ep_buffer_capture() if moe
          else contextlib.nullcontext({})) as cap:
        engine, data, m = sp2_run(t, dev, t["attention"], batch)
    if moe:
        out["ep_buffer"] = ep_buffer_gate(cap, dev)
    del cap
    m["peak_bytes"] = m["resident_bytes"] + m["fwd_bwd_peak_bytes"]
    m["host_s_per_step"] = {
        g: sum(v[2] for k, v in m["traffic"].items()
               if k.split("/")[0] == g) / t["steps"]
        for g in ("seq", "expert", "tensor", "batch", "zshard")}
    m["params_local"] = sum(s.numel for s in engine._slots)
    z = getattr(engine, "_zero3", None)
    if z is not None:
        m["zero3_counts"] = dict(z.counts)
        m["traffic_want"] = stm_hpz_traffic_want(engine, t,
                                                 engine.model_spec.config)
    if w == "d":
        m["tp_classes"] = sum(1 for key, _ in engine._norm_classes
                              if key[1])
    m["host_step"] = engine._host_runner is not None
    m["profile"] = zeropp_profile(
        engine, data, dev, profiled=rank == 0 and dev.type == "cuda")
    out["main"] = m
    engine.close()
    del engine, data
    dev_free(dev)
    out["gates"] = stm_gates(t, dev, seed)
    return out


def stm_problems(t, ranks, cfg, peak_e=None):
    """One way's verdicts, rank by rank."""
    w = t["way"]
    problems = []
    L = cfg.num_layers
    limits = dict(SP2_LIMITS) if cfg.n_experts == 0 else dict(
        SP2_LIMITS, route_miss=1 - ROUTE_AGREE_MIN, aux_rel=TRAIN_LOSS_REL)
    for r in ranks:
        m, tag = r["main"], f"({w}) rank {r['rank']}"
        if cfg.n_experts:
            launches = moe_ep_launches_want(L, t["gas"], t["steps"], 2,
                                            m["adam_per_step"])
        else:
            launches = sp2_want(t, L, t["attention"], cfg,
                                0 if m["host_step"]
                                else m["adam_per_step"])[0]
        keys = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rms_norm",
                "layer_norm", "fused_adam", "gmm", "tgmm", "quant_int8",
                "dequant_reduce")
        problems += [f"{tag}: {k} launched {m['launches'][k]} times, want "
                     f"{launches.get(k, 0)}" for k in keys
                     if m["launches"][k] != launches.get(k, 0)]
        if not all(np.isfinite(m["losses"])) or \
                m["losses"][-1] >= m["losses"][0]:
            problems.append(f"{tag}: losses {m['losses']}")
        g = r["gates"].get("sc_fp32")
        sc = {"a": "SC1", "b": "SC3", "c": "SC4", "d": "SC5"}.get(w)
        if g is not None and w != "c":
            problems += [f"{tag}: {sc} {k} {g[k]:.3g} > {v}"
                         for k, v in limits.items() if not g[k] <= v]
        if w == "c":
            if not g["loss_bit_equal"]:
                problems.append(f"{tag}: SC4 host-step loss {g['loss']!r} "
                                "not bit-equal to the device step's")
            if not g["master_rel_l2"] <= HOST_SYNC_VS_PLAIN:
                problems.append(f"{tag}: SC4 master rel L2 "
                                f"{g['master_rel_l2']:.3g} > "
                                f"{HOST_SYNC_VS_PLAIN}")
            if not m["host_step"]:
                problems.append(f"{tag}: SC4 the main path ran no host step")
            saved = HOST_INIT_SAVED * g["master_elems"]
            if t["device"].startswith("cuda") and not (
                    g["init_peak_bytes"] + saved <= g["ref_init_peak_bytes"]):
                problems.append(
                    f"{tag}: SC4 init peak {g['init_peak_bytes']} not "
                    f"{saved} below the device step's "
                    f"{g['ref_init_peak_bytes']}")
        if w == "a":
            got = {k: [int(v[0]), int(v[1])] for k, v in m["traffic"].items()
                   if int(v[0])}
            if got != m["traffic_want"]:
                keys = sorted(set(got) | set(m["traffic_want"]))
                problems.append(f"{tag}: SC2 " + "; ".join(
                    f"{k} {got.get(k)} want {m['traffic_want'].get(k)}"
                    for k in keys if got.get(k) != m["traffic_want"].get(k)))
        want = {}
        if w == "b":
            want = stm_moe_seq_traffic_want(t, cfg)
        if w == "d":
            want = stm_tensor_traffic_want(t, cfg, m["tp_classes"])
        for key, (calls, elems) in want.items():
            got = [int(x) for x in m["traffic"].get(key, [0, 0])[:2]]
            if got != [calls, elems]:
                problems.append(f"{tag}: {sc} {key} {got}, want "
                                f"{[calls, elems]}")
        if w in ("b", "d"):
            e = r["ep_buffer"]
            if not (e["gmm_close"] and e["tgmm_close"] and e["tail_zero"]):
                problems.append(f"{tag}: the received buffer's grouped GEMM "
                                f"against its plain version: {e}")
        if w == "d":
            T_ = t["mesh"]["tensor"]
            want_n = cfg.ffn_size // T_
            if r["ep_buffer"]["N"] != want_n:
                problems.append(f"{tag}: SC6 expert slice N "
                                f"{r['ep_buffer']['N']}, want {want_n}")
            if peak_e is not None and t["device"].startswith("cuda") and \
                    not m["peak_bytes"] < peak_e:
                problems.append(f"{tag}: SC6 peak {m['peak_bytes']} not "
                                f"below {{expert: 2}}'s {peak_e}")
    return problems


def mixed_tick_inputs(eng, uids, prompts, label):
    """Put the requests and step until a tick would mix decode rows with a
    prompt's chunk; that tick's inputs, scheduled and rolled back (the
    engine never ran it): tokens, positions, tables [T, mb] at its width
    tier, the heads, the real rows."""
    eng.put(uids, prompts)
    for _ in range(100):
        live = [s for s in eng.seqs.values() if not s.done]
        if any(s.prefill_remaining == 0 and s.last_tok is not None
               for s in live) and any(s.prefill_remaining > 0
                                      for s in live):
            break
        eng.step()
    else:
        raise AssertionError(f"{label}: no mixed tick in 100 steps")
    snap, rr = eng._snapshot_host(live), eng._decode_rr
    tokens, positions, tables, heads, row = eng._schedule_tick(live)
    eng._restore_host(snap)
    eng._decode_rr = rr
    mb = eng._mb_tier(int(positions[:row].max()) // eng.block_size + 1)
    return tokens, positions, tables[:, :mb], heads, row, mb


def compact_blocks(eng, tables):
    """The pool blocks a tick's tables name (block 0 first) and the tables
    renumbered into them."""
    used = np.unique(np.concatenate([[0], tables.ravel()]))
    remap = np.zeros(eng.allocator.n_blocks, np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    return used, remap[tables]


def upcast_tree(tree):
    return {k: upcast_tree(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def logit_gap(a, b):
    """(top-1 agreement, max |a − b| / max |b|) of two [rows, V] logits."""
    return (float((a.argmax(-1) == b.argmax(-1)).float().mean()),
            float((a - b).abs().max() / b.abs().max()))


def tp7b_reference(t, dev, seed, tmp):
    """T1's one-process side, in the parent before the spawn: a bf16
    engine of the phase's model and depth (the same seed's weights) steps
    TP7B_TICK's prompts to a mixed tick; that tick's inputs and the KV
    blocks it reads go to files in ``tmp``, with the fp32 plain path's
    logits; the bf16 engine's own (kernels) error against them."""
    import dataclasses

    import torch

    from deepspeed_tpu_torch.inference.fastgen import FastGenEngine
    from deepspeed_tpu_torch.models import paged as PG

    tick = t.get("tick", TP7B_TICK)
    eng = FastGenEngine(t["model"], device=dev, seed=seed, temperature=0.0,
                        num_layers=t["layers"],
                        **dict(t["engine"], n_blocks=tick["n_blocks"]))
    rng = np.random.default_rng(seed + 1)
    vocab = eng.cfg.vocab_size
    prompts = [rng.integers(0, vocab, n).tolist() for n in tick["lens"]]
    tokens, positions, tables, heads, row, mb = mixed_tick_inputs(
        eng, [0, 1], prompts, "llama2_7b_tp2")
    used, tb = compact_blocks(eng, tables)
    idx = torch.from_numpy(used).to(dev)
    pool = {k: v[:, idx].contiguous() for k, v in eng.pool.items()}
    paths = {"tick": os.path.join(tmp, "tick.npz"),
             "pool": os.path.join(tmp, "pool.pt"),
             "logits": os.path.join(tmp, "logits.pt")}
    np.savez(paths["tick"], tokens=tokens, positions=positions, tables=tb,
             row=row)
    torch.save({k: v.cpu() for k, v in pool.items()}, paths["pool"])
    tk, ps, tbd = (eng._to_dev(a) for a in (tokens, positions, tb))
    lg16, _ = PG.forward_paged(eng.params, tk, ps, tbd,
                               {k: v.clone() for k, v in pool.items()},
                               eng.cfg, use_kernels=True)
    lg16 = lg16[:row].float()
    cfg32 = dataclasses.replace(eng.cfg, dtype="float32")
    params32 = upcast_tree(eng.params)
    eng.flush([0, 1])
    del eng
    lg32, _ = PG.forward_paged(params32, tk, ps, tbd,
                               {k: v.float() for k, v in pool.items()},
                               cfg32, use_kernels=False)
    lg32 = lg32[:row]
    del params32, pool
    torch.save(lg32.cpu(), paths["logits"])
    top1, rel = logit_gap(lg16, lg32)
    out = dict(paths, rows=row, table_width=mb, blocks=len(used),
               decode_rows=sum(1 for h in heads if h[2]),
               bf16_top1=top1, bf16_rel=rel,
               finite=bool(torch.isfinite(lg16).all()
                           and torch.isfinite(lg32).all()))
    del lg16, lg32
    dev_free(dev)
    return out


def tp7b_traffic_want(cfg, tick_rows, T):
    """T3: the tensor group's calls and elements over ticks of
    ``tick_rows`` rows: a tick's 2L + 1 all-reduces of its [rows, H] (each
    layer's two row-parallel sums and the embedding's) and one gather of
    its [rows, V/T] logits."""
    L, H, n = cfg.num_layers, cfg.hidden_size, sum(tick_rows)
    return {"tensor/all_reduce": [(2 * L + 1) * len(tick_rows),
                                  (2 * L + 1) * H * n],
            "tensor/all_gather": [len(tick_rows), cfg.vocab_size // T * n]}


def tp7b_problems(ranks, t, ref, cfg, graphs=True):
    """The serving phase's verdicts, rank by rank: T2, the tokens, the
    launches, T3, the eager ticks (``graphs``: on a card, where
    ``graph_stats`` must say why), T1."""
    from deepspeed_tpu_torch.ops import paged_attention as PA

    m0 = ranks[0]["main"]
    rows = m0["tick_rows"]
    want = serving_launches_want(cfg.num_layers, rows,
                                 "rms_norm" if cfg.norm == "rmsnorm"
                                 else "layer_norm", PA.MIN_RUN)
    traffic = tp7b_traffic_want(cfg, rows, t["mesh"]["tensor"])
    problems = []
    for r in ranks:
        m, tag = r["main"], f"rank {r['rank']}"
        if m["tokens"] != m0["tokens"]:                              # T2
            problems.append(f"{tag}: T2 tokens differ from rank 0's")
        short = {u: len(v) for u, v in m["tokens"].items()
                 if len(v) != t["max_new"]}
        toks = [x for v in m["tokens"].values() for x in v]
        if short or min(toks) < 0 or max(toks) >= cfg.vocab_size:
            problems.append(f"{tag}: tokens {short or 'out of range'}")
        problems += [f"{tag}: {k} launched {m['launches'][k]} times, want "
                     f"{v}" for k, v in want.items()
                     if m["launches"][k] != v]
        for key, v in traffic.items():                              # T3
            if m["traffic"].get(key, [0, 0])[:2] != v:
                problems.append(f"{tag}: T3 {key} {m['traffic'].get(key)},"
                                f" want {v}")
        if m["tick_rows"] != rows or any(
                not k.startswith("eager") for k in m["device_ticks"]):
            problems.append(f"{tag}: ticks {m['device_ticks']}")
        if graphs and "eager" not in m["graphs"]:
            problems.append(f"{tag}: graph_stats {m['graphs']} does not "
                            "say the ticks run eagerly")
        g = r["t1"]                                                 # T1
        if not g["finite"] or g["fp32"]["top1"] < TOP1_MIN or \
                g["fp32"]["rel_err"] > LOGIT_REL_TOL_FP32:
            problems.append(f"{tag}: T1 fp32 {g['fp32']}")
        if g["bf16"]["rel_err"] > BF16_VS_PLAIN * ref["bf16_rel"]:
            problems.append(f"{tag}: T1 bf16 rel err "
                            f"{g['bf16']['rel_err']:.3g} > {BF16_VS_PLAIN} x "
                            f"one process's {ref['bf16_rel']:.3g}")
    return problems


def llama2_7b_tp2_rank(rank, world, seed, t):
    """One rank of the tensor-parallel serving phase: the main path
    (counts and traffic set to 0 just before, read just after), the decode
    rate with eager ticks, then T1's tick from the parent's files."""
    import dataclasses

    import torch

    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.inference.fastgen import FastGenEngine
    from deepspeed_tpu_torch.models import paged as PG

    dev = torch.device(t["device"])
    M.initialize_mesh(M.MeshConfig(**t["mesh"]))
    dev_peak(dev, reset=True)
    t0 = time.perf_counter()
    eng = FastGenEngine(t["model"], device=dev, seed=seed, temperature=0.0,
                        num_layers=t["layers"], **t["engine"])
    dev_sync(dev)
    init_s = time.perf_counter() - t0
    cfg = eng.cfg
    # the llama2_7b phase's requests (Smoke.serve with the same seed)
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(t["lo"], t["hi"] + 1, t["n_req"])]
    prompts = [rng.integers(0, min(cfg.vocab_size, 32000), n).tolist()
               for n in lens]
    uids = list(range(t["n_req"]))
    ticks0 = eng.device_ticks.copy()
    reset_counts()
    comm.reset_traffic()
    t0 = time.perf_counter()
    tokens = eng.generate_all(uids, prompts, max_new_tokens=t["max_new"])
    dev_sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    traffic = {k: list(v) for k, v in comm.traffic.items()}
    ran = eng.device_ticks - ticks0
    main = {"tokens": tokens, "generate_all_seconds": wall,
            "init_seconds": init_s, "launches": counts, "traffic": traffic,
            "tick_rows": [rows for (_, rows), n in sorted(ran.items())
                          for _ in range(n)],
            "device_ticks": {f"{how}[{rows}]": n
                             for (how, rows), n in sorted(ran.items())},
            "ttft_p50_s": float(np.median(list(eng.ttft_log)[-len(uids):])),
            "graphs": eng.graph_stats(), "prompt_lens": lens,
            "tp": (eng.tp.size, eng.tp.rank),
            "pool_heads": eng.pool["k"].shape[3],
            "peak_memory_bytes": dev_peak(dev)}
    # the decode rate: the prompts prefilled by step() ticks, a window of
    # 32 decode ticks warmed, then timed
    uids2 = [u + 100 for u in uids]
    eng.put(uids2, prompts)
    t0 = time.perf_counter()
    while any(eng.seqs[u].prefill_remaining > 0 for u in uids2):
        eng.step()
    dev_sync(dev)
    prefill_s = time.perf_counter() - t0
    eng.decode_steps(4)
    dev_sync(dev)
    t0 = time.perf_counter()
    got = eng.decode_steps(32)
    dev_sync(dev)
    w = time.perf_counter() - t0
    n_tok = sum(len(v) for v in got.values())
    decode = {"batch": len(uids2), "ticks": 32, "decode_tokens": n_tok,
              "decode_wall_s": w, "decode_tokens_per_s": n_tok / w,
              "decode_tick_ms": w / 32 * 1e3, "prefill_wall_s": prefill_s,
              "prefill_tokens_per_s": sum(lens) / prefill_s,
              "ttft_p50_s": float(np.median(
                  list(eng.ttft_log)[-len(uids2):]))}
    if rank == 0 and dev.type == "cuda":
        prof = profile_window(eng, 8, dev)
        dev_ms = prof.pop("device_ms_per_tick")
        decode.update(device_ms_per_tick=dev_ms or "not measured",
                      device_idle_share=(1 - dev_ms / decode["decode_tick_ms"]
                                         if dev_ms else "not measured"),
                      **prof)
    else:
        eng.decode_steps(8)
    eng.flush(uids2)
    # T1: the parent's tick on this rank's heads of its KV blocks
    ref = t["ref"]
    tick = np.load(ref["tick"])
    pool = torch.load(ref["pool"])
    want = torch.load(ref["logits"]).to(dev)
    row = int(tick["row"])
    tk, ps, tb = (eng._to_dev(tick[k]) for k in ("tokens", "positions",
                                                  "tables"))
    k_l = cfg.kv_heads // eng.tp.size
    heads = slice(rank * k_l, (rank + 1) * k_l)

    def run(params, cfg_, dt):
        mine = {k: v[..., heads, :].to(dev, dt).contiguous()
                for k, v in pool.items()}
        lg, _ = PG.forward_paged(params, tk, ps, tb, mine, cfg_,
                                 use_kernels=True, tp=eng.tp)
        return lg[:row].float()

    lg16 = run(eng.params, cfg, torch.bfloat16)
    params32 = upcast_tree(eng.params)
    lg32 = run(params32, dataclasses.replace(cfg, dtype="float32"),
               torch.float32)
    del params32
    top1_32, rel_32 = logit_gap(lg32, want)
    top1_16, rel_16 = logit_gap(lg16, want)
    t1 = {"fp32": {"top1": top1_32, "rel_err": rel_32},
          "bf16": {"top1": top1_16, "rel_err": rel_16},
          "finite": bool(torch.isfinite(lg16).all()
                         and torch.isfinite(lg32).all())}
    del lg16, lg32, want, pool, eng
    dev_free(dev)
    return {"rank": rank, "main": main, "decode": decode, "t1": t1}


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
# the main path runs at most max_layers of llama2_7b's 32 layers (the
# most the host's memory held, 20-21, before the expert-axis phase
# train_moe_350m_ep_zero came, 4 before the pipeline phase came: the cuts
# that keep the whole script within its time); the gates run gate_layers
# (4 before the pipeline phase came)
SUPER = dict(model="llama2_7b", micro=2, seq=2048, gas=4, overlap_steps=3,
             sync_steps=2, gate_layers=2, gate_micro=1, max_layers=2)
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
# (a)-(c) run OFFLOAD["layers"] of llama_750m's 20 layers (all 20 before
# the expert-axis phase train_moe_350m_ep_zero came, 8 before the
# pipeline phase came: the cuts that keep the whole script within its
# time)
OFFLOAD = dict(model="llama_750m", micro=4, seq=2048, gas=4, steps=2,
               gate_layers=4, gate_micro=1, param_layers=4, layers=4)
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
        self.phases = []             # the phases this run selected (main)
        self.current = None          # the phase running
        self._ran = set()            # the phases run so far
        self._prepared = {}          # phase → its jobs and inputs
        self._done = {}              # job key → (rank results, seconds)
        self.job_phase = {}          # job key → (its phase, its host phase)
        self.job_seconds = {}        # job key → its seconds in its spawn
        self.phase_parts = {}        # phase → prepare seconds

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
                del got, want
                exact = {}
                if label == "moe_350m_up" and dtype == "bfloat16":
                    exact = self.tgmm_unscaled(lhs, dy, gs, tag, tol)
                    errs["tgmm_unscaled"] = exact.pop("max_abs_err")
                    self.errs.update(gmm=max(errs["gmm"],
                                             errs["gmm_transpose_rhs"]),
                                     tgmm=errs["tgmm"])
                rows.append({"kernel": "grouped_gemm", "shape": label,
                             "M": M, "K": K, "N": N, "E": E,
                             "group_sizes": sizes.tolist(), "dtype": dtype,
                             "max_abs_err": errs, "tol": tol, **exact})
                del lhs, rhs, dy, dyt, gs
                self.torch.cuda.empty_cache()
        return rows

    def tgmm_unscaled(self, lhs, dy, gs, tag, tol):
        """tgmm at the E3 gate's scale (dy unscaled: outputs of O(100) over
        a group's up to 18,725 rows) against its plain version by ``tol``,
        and each one's largest distance from the fp64 sum."""
        torch = self.torch
        from deepspeed_tpu_torch.ops import grouped_gemm as GG

        got, want = GG.tgmm(lhs, dy, gs), GG.tgmm_ref(lhs, dy, gs)
        self.sync()
        err = self.close_tol("tgmm_unscaled" + tag, got, want, tol)
        dist = {"kernel": 0.0, "plain": 0.0}
        for e, (a, b) in enumerate(GG._bounds(gs, lhs.shape[0])):
            ex = lhs[a:b].double().t() @ dy[a:b].double()
            for k, v in (("kernel", got[e]), ("plain", want[e])):
                dist[k] = max(dist[k], float((v.double() - ex).abs().max()))
            del ex
        del got, want
        torch.cuda.empty_cache()
        return {"max_abs_err": err, "tgmm_unscaled_vs_fp64_sum": dist}

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

        tokens, positions, tables, heads, row, mb = mixed_tick_inputs(
            eng, uids, prompts, model)
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
        used, tables_c = compact_blocks(eng, tables)
        tk, ps, tb = (eng._to_dev(a) for a in (tokens, positions, tables_c))
        idx = torch.from_numpy(used).to(self.dev)
        cfg32 = dataclasses.replace(eng.cfg, dtype="float32")

        logits = {}
        for prec, cfg, params in (("bf16", eng.cfg, eng.params),
                                  ("fp32", cfg32, None)):
            if params is None:
                params = upcast_tree(eng.params)
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
            return logit_gap(logits[a], logits[b])

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

    def phase_checkpoint_llama_750m(self, t=None):
        """C1-C5 (see CKPT): save, load and resume on the training path,
        each tag's parts timed, the tags deleted at the end."""
        torch = self.torch
        import itertools

        import deepspeed_tpu_torch as dtt
        from deepspeed_tpu_torch.checkpoint import engine as CE
        from deepspeed_tpu_torch.checkpoint import fault_tolerance as ft
        from deepspeed_tpu_torch.checkpoint import universal as U
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.models.convert import load_master

        prep = self.prepared("checkpoint_llama_750m", t)
        t, root, free, tag_bytes = (prep["t"], prep["root"], prep["free"],
                                    prep["tag_bytes"])
        depth = {} if t["layers"] is None else {"num_layers": t["layers"]}
        cfg = T.get_model_config(t["model"], **depth)
        L = cfg.num_layers
        rng = np.random.default_rng(self.seed)
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (t["micro"], t["seq"]),
                                        dtype=np.int32)}
        data = itertools.repeat(batch)
        problems, res = [], {"disk_free_before_bytes": free,
                             "tag_bytes_predicted": tag_bytes,
                             "model": t["model"], "layers": L,
                             "micro": t["micro"], "seq": t["seq"],
                             "gas": t["gas"], "card": self.card}

        def build(seed):
            spec = dtt.causal_lm_spec(t["model"], attention="flash",
                                      remat="full", **depth)
            c = self.train_config(t["micro"], t["gas"], "bf16")
            c["seed"] = seed
            return dtt.initialize(model=spec, config=c, device=self.dev)[0]

        def step(engine):
            t0 = time.perf_counter()
            loss = float(engine.train_batch(data))
            return loss, time.perf_counter() - t0

        try:
            # ---- C1 / C2: one process, full width, CKPT["layers"] ------- #
            c1 = os.path.join(root, "c1")
            c2 = os.path.join(root, "c2")
            eng = build(self.seed)
            warm = step(eng)
            s2 = step(eng)
            with RssPeak() as rss:
                eng.save_checkpoint(c1, tag="c1")
            save1 = dict(eng.checkpoint_timings["save"])
            t0 = time.perf_counter()
            eng.save_checkpoint(c2, tag="c2", async_save=True)
            blocking_s = time.perf_counter() - t0
            thread = CE._async_thread
            in_flight = thread is not None and thread.is_alive()
            s3, s4 = step(eng), step(eng)
            want = state_fingerprints(eng)
            want_meta = (eng.get_lr(), eng.global_steps, eng.skipped_steps)
            save2 = eng.checkpoint_timings["save"]   # the thread adds to it
            eng.close()
            del eng
            dev_free(self.dev)
            # the fresh engine is built while C2's commit is in flight
            eng = build(self.seed + 1)
            t0 = time.perf_counter()
            CE.finalize_async()
            finalize_s = time.perf_counter() - t0
            save2 = dict(save2)
            eng.load_checkpoint(c1, tag="c1")
            load1 = dict(eng.checkpoint_timings["load"])
            loaded = state_fingerprints(eng)
            # the main path: counts to 0 just before the resumed steps
            self.reset_counts()
            r3, r4 = step(eng), step(eng)
            counts = self.read_counts()
            got = state_fingerprints(eng)
            got_meta = (eng.get_lr(), eng.global_steps, eng.skipped_steps)
            micros = 2 * t["gas"]
            want_counts = {"flash_fwd": 2 * L * micros,
                           "flash_bwd_dq": L * micros,
                           "flash_bwd_dkv": L * micros,
                           "rms_norm": (4 * L + 1) * micros,
                           "fused_adam": 2}
            if self.dev.type == "cuda":
                problems += [f"C1: {k} launched {counts[k]} times on the "
                             f"resumed steps, want {v}"
                             for k, v in want_counts.items()
                             if counts[k] != v]
            if [r3[0], r4[0]] != [s3[0], s4[0]]:
                problems.append(f"C1: resumed losses {[r3[0], r4[0]]} != "
                                f"{[s3[0], s4[0]]}")
            if got != want:
                problems.append(f"C1: state after the resumed steps {got} "
                                f"!= {want}")
            if got_meta != want_meta:
                problems.append(f"C1: lr / steps / skipped {got_meta} != "
                                f"{want_meta}")
            # C5: the 16-bit export against the compute params
            d16 = os.path.join(root, "c5")
            t0 = time.perf_counter()
            eng.save_16bit_model(d16)
            export_s = time.perf_counter() - t0
            flat = CE.load_16bit_model(d16)
            self.sync()
            bad16 = [k for k, slot in (("/".join(s.path), s)
                                       for s in eng._slots)
                     if flat[k].dtype != torch.bfloat16 or not torch.equal(
                         flat[k], eng._view(eng.flat_compute, slot).cpu())]
            if bad16 or len(flat) != len(eng._slots):
                problems.append(f"C5: 16-bit leaves differ from the compute "
                                f"params: {bad16[:4]}")
            c5 = {"leaves": len(flat), "export_seconds": export_s,
                  "bytes": os.path.getsize(os.path.join(
                      d16, "pytorch_model.npz")), "bit_equal": not bad16}
            del flat
            shutil.rmtree(d16, ignore_errors=True)
            # C2's tag verifies (the load's CRC pass over every file; a
            # named tag that fails raises) and loads to the bits C1's did,
            # into the same engine two steps on from them
            try:
                eng.load_checkpoint(c2, tag="c2")
                c2_ok = (True, "ok")
            except ft.CheckpointCorruptError as e:
                c2_ok = (False, str(e))
            load2 = dict(eng.checkpoint_timings.get("load", {}))
            c2_loaded = state_fingerprints(eng)
            eng.close()
            del eng
            dev_free(self.dev)
            shutil.rmtree(c1, ignore_errors=True)
            shutil.rmtree(c2, ignore_errors=True)
            if not in_flight:
                problems.append("C2: the async save's write had drained "
                                "before save_checkpoint returned")
            if c2_ok != (True, "ok"):
                problems.append(f"C2: tag does not verify: {c2_ok}")
            if c2_loaded != loaded:
                problems.append(f"C2: loaded state {c2_loaded} != C1's "
                                f"{loaded}")
            res["c1"] = dict(
                ckpt_rates(save1, load1), losses=[warm[0], s2[0], s3[0],
                                                  s4[0]],
                resumed_losses=[r3[0], r4[0]], fingerprints=got,
                lr=got_meta[0], global_steps=got_meta[1],
                skipped_steps=got_meta[2], launches=counts,
                launches_want=want_counts,
                host_rss_before_bytes=rss.before,
                host_rss_peak_bytes=rss.peak)
            res["c2"] = dict(
                ckpt_rates(save2, load2 if c2_ok[0] else None),
                blocking_s=blocking_s, in_flight_at_return=in_flight,
                finalize_wait_s=finalize_s, step_s_no_save=s2[1],
                step_s_save_in_flight=[s3[1], s4[1]])
            res["c5"] = c5
            for k, v in want_counts.items():
                self.launches.setdefault(k, {})[
                    "checkpoint_llama_750m"] = counts[k]
            self.steps["checkpoint_llama_750m"] = 2

            # ---- C3: two ranks, ZeRO-3 + qgZ + qwZ + LoCo -------------- #
            c3 = prep["c3"]
            ranks, c3_s = self.spawn_job(prep["jobs"][0])
            for r in ranks:
                if r["resumed"] != r["losses"][1:]:
                    problems.append(f"C3 rank {r['rank']}: resumed losses "
                                    f"{r['resumed']} != {r['losses'][1:]}")
                if r["got"] != r["want"]:
                    problems.append(f"C3 rank {r['rank']}: shards after the"
                                    f" resumed steps differ: {r['got']} != "
                                    f"{r['want']}")
                if r["wire"] != "qz+loco" or "loco_err" not in r["want"]:
                    problems.append(f"C3 rank {r['rank']}: wire {r['wire']}")
            uni = os.path.join(root, "c3_universal")
            t0 = time.perf_counter()
            U.convert_to_universal(c3, uni)
            convert_s = time.perf_counter() - t0
            native = CE.open_state(os.path.join(c3, "c3"))
            manifest = U.read_manifest(uni)
            zdepth = {"num_layers": t["zero3_layers"]}

            def one(seed):
                spec = dtt.causal_lm_spec(t["model"], attention="flash",
                                          remat="full", **zdepth)
                c = self.train_config(t["micro"], 1, "bf16")
                c["seed"] = seed
                return dtt.initialize(model=spec, config=c,
                                      device=self.dev)[0]

            u = one(self.seed + 3)
            t0 = time.perf_counter()
            u.load_universal_checkpoint(uni)
            uload_s = time.perf_counter() - t0
            self.sync()
            moments = manifest["optimizer_moments"]
            bad = []
            for slot in u._slots:
                p = "/".join(slot.path)
                for key, flat in [(f"master/{p}", u.flat_master)] + [
                        (f"opt/{m}/{p}", u.state["opt"][m]) for m in moments]:
                    if not torch.equal(u._view(flat, slot).cpu(),
                                       native[key]):
                        bad.append(key)
            folds = []
            for p in manifest["params"]:
                rows = U.load_atom(uni, p, "loco_err")
                folded = U.repartition_rank_rows(rows, 1)
                folds.append(bool(np.array_equal(folded[0],
                                                 rows[0] + rows[1])))
            first_u = float(u.train_batch(data))
            u.close()
            del u
            dev_free(self.dev)
            direct = one(self.seed + 4)
            tree = {}
            for p in manifest["params"]:
                node = tree
                keys = p.split("/")
                for k in keys[:-1]:
                    node = node.setdefault(k, {})
                node[keys[-1]] = native[f"master/{p}"]
            load_master(direct, tree)
            del tree
            for slot in direct._slots:
                p = "/".join(slot.path)
                for m in moments:
                    direct._view(direct.state["opt"][m], slot).copy_(
                        native[f"opt/{m}/{p}"])
            direct.state["opt"]["step"] = int(native["opt/step"])
            direct.state["step"] = int(native["step"])
            first_d = float(direct.train_batch(data))
            direct.close()
            del direct
            dev_free(self.dev)
            shutil.rmtree(c3, ignore_errors=True)
            shutil.rmtree(uni, ignore_errors=True)
            if bad:
                problems.append(f"C3: universal leaves differ from the "
                                f"gathered ones: {bad[:4]}")
            if not all(folds) or len(folds) != len(manifest["params"]):
                problems.append("C3: a LoCo fold does not keep the rows' sum")
            if first_u != first_d:
                problems.append(f"C3: universal first loss {first_u} != "
                                f"the direct engine's {first_d}")
            r0 = ranks[0]
            res["c3"] = dict(
                ckpt_rates(r0["save"], r0["load"]), world=2,
                layers=t["zero3_layers"], wire=r0["wire"],
                losses=[r["losses"] for r in ranks],
                resumed=[r["resumed"] for r in ranks],
                spawn_seconds=c3_s, convert_seconds=convert_s,
                universal_load_seconds=uload_s,
                universal_first_loss=first_u, direct_first_loss=first_d,
                loco_folds=len(folds))

            # ---- C4: the NVMe optimizer tier --------------------------- #
            path = os.path.join(nvme_dir(), "ckpt")
            shutil.rmtree(path, ignore_errors=True)
            c4 = os.path.join(root, "c4")
            tt = dict(OFFLOAD, micro=t["micro"], seq=t["seq"], gas=t["gas"],
                      model=t["model"])
            eng = offload_engine(tt, self.dev, {
                "stage": 1, "offload_optimizer": {"device": "nvme",
                                                  "nvme_path": path}},
                "bf16", layers=t["nvme_layers"])
            first = [step(eng)[0] for _ in range(2)]
            eng.save_checkpoint(c4, tag="c4")
            save4 = dict(eng.checkpoint_timings["save"])
            ran = [step(eng)[0] for _ in range(2)]
            eng.load_checkpoint(c4, tag="c4")
            load4 = dict(eng.checkpoint_timings["load"])
            swapped = eng._opt_swapper is not None and eng._opt_swapper.swapped
            again = [step(eng)[0] for _ in range(2)]
            eng.close()
            del eng
            dev_free(self.dev)
            shutil.rmtree(path, ignore_errors=True)
            if again != ran:
                problems.append(f"C4: losses after the load {again} != "
                                f"{ran}")
            if not swapped:
                problems.append("C4: the restored moments are not in their "
                                "files after the load")
            res["c4"] = dict(ckpt_rates(save4, load4),
                             layers=t["nvme_layers"], losses=first + ran,
                             after_load=again, swapped_after_load=swapped)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        emit("checkpoint_llama_750m", **res)
        if problems:
            raise AssertionError("checkpoint_llama_750m: "
                                 + "; ".join(problems))
        self.state["checkpoint"] = res

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
    # ------------------------------------------------------------------ #
    # spawns merged across phases (MERGED_SPAWNS)
    # ------------------------------------------------------------------ #
    def prepared(self, phase, *args):
        """``phase``'s spawn jobs and parent-side inputs (its
        ``prepare_<phase>(*args)``), prepared once: by the phase itself,
        or by an earlier phase whose merged spawn ran its jobs (with no
        arguments: the script's own settings)."""
        if phase not in self._prepared:
            t0 = time.perf_counter()
            self._prepared[phase] = getattr(self, f"prepare_{phase}")(*args)
            for j in self._prepared[phase]["jobs"]:
                self.job_phase[j.key] = (phase, self.current)
            self.phase_parts[phase] = {"prepare_s": time.perf_counter() - t0,
                                       "prepared_in": self.current}
        return self._prepared[phase]

    def phase_seconds(self, done):
        """Each phase's seconds with its jobs' seconds where they ran:
        ``done`` (the wall of each phase) less the jobs of other phases
        its spawn ran, plus its own jobs run in another phase's spawn (the
        spawn's fixed cost stays with the phase that started it)."""
        out = dict(done)
        moved = [(phase, host, self.job_seconds.get(key))
                 for key, (phase, host) in self.job_phase.items()]
        moved += [(phase, v["prepared_in"], v["prepare_s"])
                  for phase, v in self.phase_parts.items()]
        for phase, host, sec in moved:
            if sec is None or phase == host:
                continue
            if host in out:
                out[host] -= sec
            if phase in out:
                out[phase] += sec
        return out

    def cleanup(self, phase):
        """Remove the directories ``phase``'s preparation made."""
        for path in self._prepared.get(phase, {}).get("tmp", ()):
            shutil.rmtree(path, ignore_errors=True)

    def spawn_job(self, job):
        """``job``'s ranks' results and their seconds. The first job of a
        world in MERGED_SPAWNS starts one spawn for every job of that world
        of the phases selected in this run (this phase's and the later
        ones', prepared here); the later phases take their results."""
        if job.key not in self._done:
            jobs = [job]
            if job.world in MERGED_SPAWNS:
                for phase in self.phases:
                    if phase in MERGED_SPAWNS[job.world] and \
                            phase not in self._ran:
                        jobs += [j for j in self.prepared(phase)["jobs"]
                                 if j.world == job.world and j is not job
                                 and j.key not in self._done]
            t0 = time.perf_counter()
            ranks = spawn_ranks("jobs_rank", job.world, self.seed,
                                [(j.key, j.fn, j.args) for j in jobs])
            wall = time.perf_counter() - t0
            emit("spawn/jobs", world=job.world, keys=[j.key for j in jobs],
                 wall_s=wall, job_seconds={
                     j.key: max(r[j.key][1] for r in ranks) for j in jobs})
            for j in jobs:
                self._done[j.key] = ([r[j.key][0] for r in ranks],
                                     max(r[j.key][1] for r in ranks))
                self.job_seconds[j.key] = self._done[j.key][1]
                self.job_phase[j.key] = (self.job_phase[j.key][0],
                                         self.current)
        return self._done.pop(job.key)

    def prepare_train_llama_750m_zeropp_dp2(self):
        t = dict(ZEROPP, steps=ZEROPP_STEPS, gas=ZEROPP_GAS,
                 layers=ZEROPP_LAYERS, gate_layers=ZEROPP_GATE_LAYERS)
        return {"t": t, "jobs": [Job("zeropp", "train_llama_750m_zeropp_dp2_rank",
                                     t["world"], dict(t, device=str(self.dev)))]}

    def prepare_train_llama_750m_zero3_dp2(self):
        """The ZeRO-3 ranks' job and the MLP's reference (the same spec at
        world 1 without ZeRO), in a file the ranks read."""
        t = dict(ZERO3, layers=ZERO3_LAYERS, steps=ZERO3_STEPS,
                 baseline=True)
        mlp = dict(ZERO3_MLP, **t.get("mlp", {}))
        tmp = tempfile.mkdtemp(prefix="chip_smoke_mlp_")
        ref_path = os.path.join(tmp, "ref.pt")
        mlp_ref = mlp_run(self.dev, {"stage": 0}, mlp["micro"] * t["world"],
                          self.seed, mlp, path=ref_path)
        del mlp_ref["m0"], mlp_ref["m1"]
        dev_free(self.dev)
        return {"t": t, "mlp": mlp, "mlp_ref": mlp_ref, "tmp": [tmp],
                "jobs": [Job("zero3", "train_llama_750m_zero3_dp2_rank",
                             t["world"], dict(t, device=str(self.dev),
                                              mlp=mlp, mlp_ref=ref_path))]}

    def prepare_train_llama_750m_hpz_dp4(self):
        t = dict(HPZ, layers=HPZ_LAYERS, steps=HPZ_STEPS)
        return {"t": t, "jobs": [Job("hpz", "train_llama_750m_hpz_dp4_rank",
                                     t["world"], dict(t, device=str(self.dev)))]}

    def prepare_train_moe_350m_ep(self):
        """The one-process references of (a) and (b) (their whole fp32
        gradient and update in files the ranks map) and the two jobs."""
        ep_a = dict(MOE_EP, layers=MOE_EP_LAYERS)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ep_")
        refs = {"a": moe_ep_reference(ep_a, self.dev, self.seed,
                                      os.path.join(tmp, "a")),
                "b": moe_ep_reference(MOE_EP_B, self.dev, self.seed,
                                      os.path.join(tmp, "b"),
                                      plain_bf16=False)}
        return {"ep_a": ep_a, "refs": refs, "tmp": [tmp], "jobs": [
            Job(f"moe_ep/{label}", "train_moe_350m_ep_rank", t["world"],
                dict(t, device=str(self.dev), ref=refs[label]))
            for label, t in (("a", ep_a), ("b", MOE_EP_B))]}

    def prepare_train_moe_350m_ep_zero(self):
        """(g)'s one-process dense reference and the two jobs."""
        t = dict(MOE_EPZ)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_epz_")
        ref = moe_ep_reference(MOE_EPZ_DENSE, self.dev, self.seed,
                               os.path.join(tmp, "g"), plain_bf16=False)
        return {"t": t, "ref": ref, "tmp": [tmp], "jobs": [
            Job("moe_ep_zero/b-f", "train_moe_350m_ep_zero_rank", t["world"],
                dict(t, device=str(self.dev))),
            Job("moe_ep_zero/g", "train_moe_350m_ep_dense_rank",
                MOE_EPZ_DENSE["world"], dict(MOE_EPZ_DENSE,
                                             device=str(self.dev), ref=ref))]}

    def prepare_train_llama_750m_sp2(self):
        """The one-process reference (``sp2_reference``) and the job."""
        t = dict(SP2, layers=SP2_LAYERS)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_sp2_")
        ref = sp2_reference(t, self.dev, self.seed, os.path.join(tmp, "one"))
        return {"t": t, "ref": ref, "tmp": [tmp], "jobs": [
            Job("sp2", "train_llama_750m_sp2_rank", t["world"],
                dict(t, device=str(self.dev), ref=ref)),
            Job("sp2/c", "train_llama_750m_sp2_rank", SP2_C["world"],
                dict(sp2_c(t), device=str(self.dev), ref=ref))]}

    def phase_train_llama_750m_sp2(self):
        """Two ranks at mesh {seq: 2} (SP2): ways (a) ulysses_flash and (b)
        ring, gates SP1-SP5 (``train_llama_750m_sp2_rank``), then SP6 in
        this process; step ms, tokens/s, MFU (attention over the whole
        sequence), peak a rank, rank 0's idle share and the seq group's
        host seconds a step."""
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build

        build.build_all()
        dev_free(self.dev)
        prep = self.prepared("train_llama_750m_sp2")
        t, ref = prep["t"], prep["ref"]
        try:
            ranks, wall = self.spawn_job(prep["jobs"][0])
            ranks_c, wall_c = self.spawn_job(prep["jobs"][1])
        finally:
            self.cleanup("train_llama_750m_sp2")
        cfg = T.get_model_config(t["model"], num_layers=t["layers"])
        L = cfg.num_layers
        tokens = t["micro"] * t["seq"] * t["gas"]
        tc = sp2_c(t)
        problems, results = [], {}
        for label, attention, rs, tw in (
                [(lab, att, ranks, t) for lab, att in SP2_WAYS]
                + [(lab, att, ranks_c, tc) for lab, att in SP2_C["ways"]]):
            launches, traffic, shapes = sp2_want(
                tw, L, attention, cfg, rs[0][label]["adam_per_step"])
            for r in rs:
                m, tag = r[label], f"{label} rank {r['rank']}"
                problems += [f"{tag}: {k} launched {m['launches'][k]} "
                             f"times, want {v}" for k, v in launches.items()
                             if m["launches"][k] != v]
                for key, (calls, elems) in traffic.items():
                    got = m["traffic"].get(key, [0, 0])[:2]
                    if got != [calls, elems]:
                        problems.append(f"{tag}: {key} {got}, want "
                                        f"{[calls, elems]}")
                if shapes and any(m["flash_shapes"][k] != shapes
                                  for k in m["flash_shapes"]):
                    problems.append(f"{tag}: flash shapes "
                                    f"{m['flash_shapes']}, want {shapes}")
                if m["losses"][-1] >= m["losses"][0] or not all(
                        np.isfinite(m["losses"])):
                    problems.append(f"{tag}: losses {m['losses']}")
                # SP5: the forward-backward peak above the resident state
                if not m["fwd_bwd_peak_bytes"] < \
                        ref["one_process_fwd_bwd_peak_bytes"]:
                    problems.append(
                        f"{tag}: forward-backward peak "
                        f"{m['fwd_bwd_peak_bytes']} not below one "
                        f"process's {ref['one_process_fwd_bwd_peak_bytes']}")
            r0 = rs[0][label]
            step_s = r0["step_ms"] / 1e3
            results[label] = {
                "attention": attention, "mesh": tw["mesh"],
                "world": tw["world"], "micro_a_batch_rank": tw["micro"],
                "step_ms": r0["step_ms"],
                "step_ms_per_rank": [r[label]["step_ms"] for r in rs],
                "tokens_per_s": tokens / step_s,
                "mfu": tokens / step_s * flops_per_token(cfg, t["seq"])
                / PEAK_FLOPS["bfloat16"],
                "peak_bytes_per_rank": [r[label]["resident_bytes"]
                                        + r[label]["fwd_bwd_peak_bytes"]
                                        for r in rs],
                "fwd_bwd_peak_bytes_per_rank": [
                    r[label]["fwd_bwd_peak_bytes"] for r in rs],
                "fwd_bwd_peak_vs_one_process": [
                    r[label]["fwd_bwd_peak_bytes"]
                    / ref["one_process_fwd_bwd_peak_bytes"] for r in rs],
                "idle_share_rank0": r0["profile"].get("device_idle_share"),
                "seq_host_s_per_step": [r[label]["seq_host_s_per_step"]
                                        for r in rs],
                "launches_want": launches, "traffic_want": traffic,
                "flash_shape_want": shapes,
                "per_rank": [{k: v for k, v in r[label].items()
                              if k != "profile"} for r in rs],
                "profile_rank0": r0["profile"]}
        gates = dict(ranks[0]["gates"], **ranks_c[0]["gates"])
        for r in ranks + ranks_c:
            problems += [f"rank {r['rank']}: {p}"
                         for p in sp2_gate_problems(r["gates"], ref)]
        sp6, p6 = fpdt_gate(self.dev)
        problems += p6
        emit("train_llama_750m_sp2", model=t["model"], layers=L,
             reduced=f"{L} of 20 layers, for the script's time",
             mesh=t["mesh"], world=t["world"], micro=t["micro"],
             seq=t["seq"], gas=t["gas"], steps=t["steps"], zero=t["zero"],
             params=cfg.num_params(), phase_wall_s=wall,
             phase_wall_s_c=wall_c, card=self.card,
             wire_note="gloo through host memory, two ranks sharing one "
                       "card", one_process={
                 k: v for k, v in ref.items() if not k.endswith("_path")},
             **results)
        emit("train_llama_750m_sp2/gates", card=self.card, gates=gates,
             sp6=sp6, limits=SP2_LIMITS, bf16_vs_plain=BF16_VS_PLAIN)
        if problems:
            raise AssertionError("train_llama_750m_sp2: "
                                 + "; ".join(problems))
        name = "train_llama_750m_sp2"
        for label, res in results.items():
            for k, v in res["per_rank"][0]["launches"].items():
                if v and k.startswith("flash"):
                    self.launches.setdefault(k, {})[f"{name}/{label}"] = v
            self.steps[f"{name}/{label}"] = t["steps"]
        self.state["sp2"] = {
            label: dict(res["profile_rank0"], step_ms=res["step_ms"],
                        tokens_per_s=res["tokens_per_s"], mfu=res["mfu"])
            for label, res in results.items()}

    def prepare_train_llama_750m_tp2(self):
        """The one-process reference (``sp2_reference`` at TP2's depth and
        batch) and the two ways' jobs."""
        t = dict(TP2, layers=TP2_LAYERS, gates=tuple(TP2_GATES))
        tmp = tempfile.mkdtemp(prefix="chip_smoke_tp2_")
        ref = sp2_reference(t, self.dev, self.seed, os.path.join(tmp, "one"))
        return {"t": t, "ref": ref, "tmp": [tmp], "jobs": [
            Job("tp2", "train_llama_750m_tp2_rank", t["world"],
                dict(t, device=str(self.dev), ref=ref)),
            Job("tp2/b", "train_llama_750m_tp2_rank", TP2_B["world"],
                dict(tp2_b(t), device=str(self.dev), ref=ref))]}

    def phase_train_llama_750m_tp2(self):
        """Way (a) on two ranks at {tensor: 2} (ZeRO-1) and way (b) on four
        at {data: 2, tensor: 2} (ZeRO-3), gates TP1-TP4
        (``train_llama_750m_tp2_rank``); step ms, tokens/s, MFU, peak a
        rank, rank 0's idle share and the tensor group's host seconds a
        step."""
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build

        build.build_all()
        dev_free(self.dev)
        prep = self.prepared("train_llama_750m_tp2")
        t, ref = prep["t"], prep["ref"]
        try:
            ways = {"a": (t, self.spawn_job(prep["jobs"][0])),
                    "b": (tp2_b(t), self.spawn_job(prep["jobs"][1]))}
        finally:
            self.cleanup("train_llama_750m_tp2")
        cfg = T.get_model_config(t["model"], num_layers=t["layers"])
        tokens = t["micro"] * t["seq"] * t["gas"]
        params_want = tp_local_params(cfg, t["mesh"]["tensor"])
        problems, results, gates = [], {}, {}
        for label, (tw, (ranks, wall)) in ways.items():
            launches, shapes = tp2_want(tw, cfg,
                                        ranks[0]["main"]["adam_per_step"])
            traffic = tp2_traffic_want(tw, cfg)
            problems += tp2_problems(label, tw, ranks, ref, cfg)
            gates[label] = ranks[0]["gates"]
            r0 = ranks[0]["main"]
            step_s = r0["step_ms"] / 1e3
            results[label] = {
                "mesh": tw["mesh"], "world": tw["world"], "zero": tw["zero"],
                "micro_a_batch_rank": tw["micro"], "phase_wall_s": wall,
                "step_ms": r0["step_ms"],
                "step_ms_per_rank": [r["main"]["step_ms"] for r in ranks],
                "tokens_per_s": tokens / step_s,
                "mfu": tokens / step_s * flops_per_token(cfg, t["seq"])
                / PEAK_FLOPS["bfloat16"],
                "params_per_rank": r0["params_local"],
                "params_want": params_want,
                "state_bytes_rank0": r0["state_bytes"],
                "peak_bytes_per_rank": [r["main"]["resident_bytes"]
                                        + r["main"]["fwd_bwd_peak_bytes"]
                                        for r in ranks],
                "fwd_bwd_peak_vs_one_process": [
                    r["main"]["fwd_bwd_peak_bytes"]
                    / ref["one_process_fwd_bwd_peak_bytes"] for r in ranks],
                "idle_share_rank0": r0["profile"].get("device_idle_share"),
                "tensor_host_s_per_step": [r["main"]["tensor_host_s_per_step"]
                                           for r in ranks],
                "launches_want": launches, "traffic_want": traffic,
                "flash_shape_want": shapes,
                "per_rank": [{k: v for k, v in r["main"].items()
                              if k != "profile"} for r in ranks],
                "profile_rank0": r0["profile"]}
        emit("train_llama_750m_tp2", model=t["model"], layers=t["layers"],
             reduced=f"{t['layers']} of 20 layers, for the script's time",
             micro_global=t["micro"], seq=t["seq"], gas=t["gas"],
             steps=t["steps"], params=cfg.num_params(), card=self.card,
             wire_note="gloo through host memory, the ranks sharing one "
                       "card", one_process={
                 k: v for k, v in ref.items() if not k.endswith("_path")},
             **results)
        emit("train_llama_750m_tp2/gates", card=self.card, gates=gates,
             limits=SP2_LIMITS, bf16_vs_plain=BF16_VS_PLAIN)
        if problems:
            raise AssertionError("train_llama_750m_tp2: "
                                 + "; ".join(problems))
        name = "train_llama_750m_tp2"
        for label, res in results.items():
            for k, v in res["per_rank"][0]["launches"].items():
                if v and k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                               "rms_norm", "fused_adam"):
                    self.launches.setdefault(k, {})[f"{name}/{label}"] = v
            self.steps[f"{name}/{label}"] = t["steps"]
        self.state["tp2"] = {
            label: dict(res["profile_rank0"], step_ms=res["step_ms"],
                        tokens_per_s=res["tokens_per_s"], mfu=res["mfu"])
            for label, res in results.items()}

    def prepare_train_llama_750m_pp2(self):
        """The one-process reference (``pp2_reference``: PP1's gate step,
        PP2's first losses) and the two ways' jobs."""
        t = dict(PP2, layers=PP2_LAYERS, gates=tuple(PP2_GATES),
                 seed=self.seed)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_pp2_")
        ref = pp2_reference(t, self.dev, self.seed, os.path.join(tmp, "one"))
        return {"t": t, "ref": ref, "tmp": [tmp], "jobs": [
            Job("pp2", "train_llama_750m_pp2_rank", t["world"],
                dict(t, device=str(self.dev), ref=ref, pp4=True,
                     pp2_gate=True)),
            Job("pp2/b", "train_llama_750m_pp2_rank", PP2_B["world"],
                dict(pp2_b(t), device=str(self.dev), ref=ref))]}

    def phase_train_llama_750m_pp2(self):
        """Way (a) on two ranks at {pipe: 2} (ZeRO-1, 1F1B) and way (b) on
        four at {pipe: 2, tensor: 2}, gates PP1-PP4
        (``train_llama_750m_pp2_rank``); step ms, tokens/s, MFU, peak a
        rank, rank 0's idle share, the bubble share (formula and measured)
        and the pipe group's host seconds a step."""
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build

        build.build_all()
        dev_free(self.dev)
        prep = self.prepared("train_llama_750m_pp2")
        t, ref = prep["t"], prep["ref"]
        try:
            ways = {"a": (t, self.spawn_job(prep["jobs"][0])),
                    "b": (pp2_b(t), self.spawn_job(prep["jobs"][1]))}
        finally:
            self.cleanup("train_llama_750m_pp2")
        problems, results, gates = [], {}, {}
        for label, (tw, (ranks, wall)) in ways.items():
            cfg = T.get_model_config(tw["model"], num_layers=tw["layers"])
            tw = dict(tw, pp2_gate=label == "a")
            problems += pp2_problems(label, tw, ranks, ref, cfg)
            gates[label] = {f"rank {r['rank']}": r["gates"] for r in ranks}
            r0 = ranks[0]["main"]
            step_s = r0["step_ms"] / 1e3
            P, M = tw["mesh"]["pipe"], tw["spec"]["pipeline_micro_batches"]
            tokens = tw["micro"] * tw["seq"] * tw["gas"]
            results[label] = {
                "mesh": tw["mesh"], "world": tw["world"], "zero": tw["zero"],
                "layers": tw["layers"], "schedule": "1f1b",
                "pipeline_micro_batches": M,
                "pipeline_micro_batch_rows": tw["micro"] // M,
                "phase_wall_s": wall, "step_ms": r0["step_ms"],
                "step_ms_per_rank": [r["main"]["step_ms"] for r in ranks],
                "tokens_per_s": tokens / step_s,
                "mfu": tokens / step_s * flops_per_token(cfg, tw["seq"])
                / PEAK_FLOPS["bfloat16"],
                "bubble_formula": (P - 1) / (M + P - 1),
                "bubble_measured_per_rank": [r["main"]["bubble_measured"]
                                             for r in ranks],
                "params_per_rank": [r["main"]["params_local"]
                                    for r in ranks],
                "params_want": pp_local_params(
                    cfg, P, tw["mesh"].get("tensor", 1)),
                "state_bytes_rank0": r0["state_bytes"],
                "peak_bytes_per_rank": [r["main"]["resident_bytes"]
                                        + r["main"]["fwd_bwd_peak_bytes"]
                                        for r in ranks],
                "pp4_fwd_bwd_peak_bytes": {f"rank {r['rank']}": r["pp4"]
                                           for r in ranks if r["pp4"]},
                "idle_share_rank0": r0["profile"].get("device_idle_share"),
                "pipe_host_s_per_step": [r["main"]["pipe_host_s_per_step"]
                                         for r in ranks],
                "launches_want": {f"stage {s}": pp2_want(
                    tw, cfg, s, r0["adam_per_step"])[0] for s in range(P)},
                "traffic_want": {f"stage {s}": pp2_traffic_want(tw, cfg, s)
                                 for s in range(P)},
                "per_rank": [{k: v for k, v in r["main"].items()
                              if k != "profile"} for r in ranks],
                "profile_rank0": r0["profile"]}
            if label == "a":
                d, limit = pp2_distance(r0["losses"][0], ref)
                results[label]["pp2"] = {
                    "first_loss": r0["losses"][0], "distance": d,
                    "limit": limit, "one_process": {
                        k: v for k, v in ref.items()
                        if k.startswith("first_loss")}}
        emit("train_llama_750m_pp2", model=t["model"],
             reduced=f"(a) {t['layers']} of 20 layers; (b) and the gates "
                     f"{PP2_GATE_LAYERS}",
             micro_global=t["micro"], seq=t["seq"], gas=t["gas"],
             steps=t["steps"], card=self.card,
             wire_note="gloo through host memory, the ranks sharing one "
                       "card", one_process={
                 k: v for k, v in ref.items() if not k.endswith("_path")},
             **results)
        emit("train_llama_750m_pp2/gates", card=self.card, gates=gates,
             limits=PP1_LIMITS, bf16_vs_plain=BF16_VS_PLAIN,
             pp4_growth=PP4_GROWTH)
        if problems:
            raise AssertionError("train_llama_750m_pp2: "
                                 + "; ".join(problems))
        name = "train_llama_750m_pp2"
        for label, res in results.items():
            for r in res["per_rank"]:
                for k, v in r["launches"].items():
                    if v and k in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "rms_norm",
                                   "fused_adam"):
                        by = self.launches.setdefault(k, {})
                        key = f"{name}/{label}"
                        by[key] = by.get(key, 0) + v
            self.steps[f"{name}/{label}"] = t["steps"] * res["world"]
        self.state["pp2"] = {
            label: dict(res["profile_rank0"], step_ms=res["step_ms"],
                        tokens_per_s=res["tokens_per_s"], mfu=res["mfu"])
            for label, res in results.items()}

    def prepare_train_llama_750m_pp_compose(self):
        """The four ways' jobs: (a)-(c) in the world-4 spawn, (d) in the
        world-2 spawn."""
        t = dict(PPC, layers=PPC_LAYERS, device=str(self.dev))
        return {"t": t, "jobs": [
            Job(f"ppc/{w}", "train_llama_750m_pp_compose_rank",
                ppc_way(t, w)["world"], ppc_way(t, w)) for w in PPC_WAYS]}

    def phase_train_llama_750m_pp_compose(self):
        """The pipe axis beside ZeRO-3 (a), seq (b), expert (c) and the
        offload tier (d), gates PC1-PC7 (``train_llama_750m_pp_compose_
        rank``); step ms, tokens/s, MFU, peak a rank, rank 0's idle share
        and the pipe, seq and expert groups' host seconds a step."""
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build

        build.build_all()
        dev_free(self.dev)
        prep = self.prepared("train_llama_750m_pp_compose")
        t = prep["t"]
        ways = {j.args["way"]: (j.args, self.spawn_job(j))
                for j in prep["jobs"]}
        problems, results, gates = [], {}, {}
        for w, (tw, (ranks, wall)) in ways.items():
            cfg = T.get_model_config(tw["model"], num_layers=tw["layers"])
            problems += ppc_problems(tw, ranks, cfg)
            gates[w] = {f"rank {r['rank']}": r["gates"] for r in ranks}
            r0 = ranks[0]["main"]
            step_s = r0["step_ms"] / 1e3
            rows = tw["micro"] * int(np.prod([tw["mesh"].get(a, 1) for a in
                                              ("data", "zshard", "expert")]))
            tokens = rows * tw["seq"] * tw["gas"]
            res = {
                "mesh": tw["mesh"], "world": tw["world"], "zero": tw["zero"],
                "model": tw["model"], "layers": tw["layers"],
                "attention": tw.get("attention", "flash"),
                "schedule": "1f1b",
                "pipeline_micro_batches": tw["spec"][
                    "pipeline_micro_batches"],
                "rows_global": rows, "seq": tw["seq"], "phase_wall_s": wall,
                "step_ms": r0["step_ms"],
                "step_ms_per_rank": [r["main"]["step_ms"] for r in ranks],
                "tokens_per_s": tokens / step_s,
                "mfu": tokens / step_s * flops_per_token(cfg, tw["seq"])
                / PEAK_FLOPS["bfloat16"],
                "peak_bytes_per_rank": [r["main"]["peak_bytes"]
                                        for r in ranks],
                "idle_share_rank0": r0["profile"].get("device_idle_share"),
                "host_s_per_step_per_rank": [r["main"]["host_s_per_step"]
                                             for r in ranks],
                "params_per_rank": [r["main"]["params_local"]
                                    for r in ranks],
                "per_rank": [{k: v for k, v in r["main"].items()
                              if k != "profile"} for r in ranks],
                "profile_rank0": r0["profile"]}
            if tw.get("baseline"):
                res["baseline"] = {
                    "zero": tw["baseline"],
                    "step_ms": ranks[0]["baseline"]["step_ms"],
                    "peak_bytes_per_rank": [r["baseline"]["peak_bytes"]
                                            for r in ranks],
                    "losses_per_rank": [r["baseline"]["losses"]
                                        for r in ranks],
                    "state_bytes_rank0": ranks[0]["baseline"]["state_bytes"]}
            if w == "a":
                P = tw["mesh"]["pipe"]
                res["zero3"] = {
                    "counts_per_rank": [r["main"]["zero3_counts"]
                                        for r in ranks],
                    "want_by_stage": [ppc_zero3_want(tw, r0["chunks"], s)
                                      for s in range(P)],
                    "chunks_a_stage": r0["chunks"],
                    "n_local": r0["n_local"],
                    "margin_reckoned_bytes": ppc_memory_margin(
                        cfg, P, cfg.num_layers // P // r0["chunks"]),
                    "peak_saved_bytes_per_rank": [
                        r["baseline"]["peak_bytes"] - r["main"]["peak_bytes"]
                        for r in ranks]}
            if w == "b":
                res["seq_traffic_want_by_stage"] = [
                    ppc_seq_want(tw, cfg, s)
                    for s in range(tw["mesh"]["pipe"])]
            if w == "c":
                res["ep_buffer_per_rank"] = [r["ep_buffer"] for r in ranks]
            if w == "d":
                res["fingerprints"] = {
                    f"rank {r['rank']}": {"offload": r["main"][
                        "fingerprints"], "none": r["baseline"][
                        "fingerprints"]} for r in ranks}
            results[w] = res
        emit("train_llama_750m_pp_compose", reduced=(
            f"{t['layers']} of 20 layers (moe_350m: of 12), for the "
            "script's time"), micro_a_batch_rank=t["micro"], gas=t["gas"],
            steps=t["steps"], card=self.card,
            wire_note="gloo through host memory, the ranks sharing one "
                      "card", **results)
        emit("train_llama_750m_pp_compose/gates", card=self.card,
             gates=gates, limits=SP2_LIMITS, bf16_vs_plain=BF16_VS_PLAIN,
             route_agree_min=ROUTE_AGREE_MIN,
             memory_share=PPC_MEMORY_SHARE)
        if problems:
            raise AssertionError("train_llama_750m_pp_compose: "
                                 + "; ".join(problems))
        name = "train_llama_750m_pp_compose"
        for w, res in results.items():
            for r in res["per_rank"]:
                for k, v in r["launches"].items():
                    if v and k in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "rms_norm", "layer_norm",
                                   "fused_adam", "gmm", "tgmm"):
                        by = self.launches.setdefault(k, {})
                        key = f"{name}/{w}"
                        by[key] = by.get(key, 0) + v
            self.steps[f"{name}/{w}"] = t["steps"] * res["world"]
        self.state["pp_compose"] = {
            "zero3_n_local": results["a"]["zero3"]["n_local"],
            "ep_buffer": results["c"]["ep_buffer_per_rank"][0],
            "steps": {w: dict(res["profile_rank0"], step_ms=res["step_ms"],
                              tokens_per_s=res["tokens_per_s"],
                              mfu=res["mfu"]) for w, res in results.items()}}

    def prepare_train_sp_tp_moe_compose(self):
        """The five ways' jobs: (a), (b), (d) in the world-4 spawn, (c)
        and (e) in the world-2 spawn."""
        t = dict(STM, layers=STM_LAYERS, device=str(self.dev))
        return {"t": t, "jobs": [
            Job(f"stm/{w}", "train_sp_tp_moe_compose_rank",
                stm_way(t, w)["world"], stm_way(t, w)) for w in STM_WAYS]}

    def phase_train_sp_tp_moe_compose(self):
        """The seq axis beside hpZ (a), MoE and the expert axis (b) and the
        host step (c), and MoE under the tensor axis (d) against {expert:
        2} (e): gates SC1-SC6 (``train_sp_tp_moe_compose_rank``); step ms,
        tokens/s, MFU, peak a rank, rank 0's idle share and the groups'
        host seconds a step."""
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build

        build.build_all()
        dev_free(self.dev)
        prep = self.prepared("train_sp_tp_moe_compose")
        t = prep["t"]
        ways = {j.args["way"]: (j.args, self.spawn_job(j))
                for j in prep["jobs"]}
        peak_e = max(r["main"]["peak_bytes"] for r in ways["e"][1][0])
        problems, results, gates = [], {}, {}
        for w, (tw, (ranks, wall)) in ways.items():
            cfg = T.get_model_config(tw["model"], num_layers=tw["layers"])
            problems += stm_problems(tw, ranks, cfg, peak_e)
            gates[w] = {f"rank {r['rank']}": r["gates"] for r in ranks}
            r0 = ranks[0]["main"]
            step_s = r0["step_ms"] / 1e3
            rows = tw["micro"] * stm_batch_ranks(tw)
            tokens = rows * tw["seq"] * tw["gas"]
            res = {
                "mesh": tw["mesh"], "world": tw["world"], "zero": tw["zero"],
                "model": tw["model"], "layers": tw["layers"],
                "attention": tw["attention"], "rows_global": rows,
                "seq": tw["seq"], "phase_wall_s": wall,
                "step_ms": r0["step_ms"],
                "step_ms_per_rank": [r["main"]["step_ms"] for r in ranks],
                "tokens_per_s": tokens / step_s,
                "mfu": tokens / step_s * flops_per_token(cfg, tw["seq"])
                / PEAK_FLOPS["bfloat16"],
                "peak_bytes_per_rank": [r["main"]["peak_bytes"]
                                        for r in ranks],
                "idle_share_rank0": r0["profile"].get("device_idle_share"),
                "host_s_per_step_per_rank": [r["main"]["host_s_per_step"]
                                             for r in ranks],
                "params_per_rank": [r["main"]["params_local"]
                                    for r in ranks],
                "per_rank": [{k: v for k, v in r["main"].items()
                              if k != "profile"} for r in ranks],
                "profile_rank0": r0["profile"]}
            if w == "b":
                res["traffic_want"] = stm_moe_seq_traffic_want(tw, cfg)
            if w == "d":
                res["traffic_want"] = stm_tensor_traffic_want(
                    tw, cfg, r0["tp_classes"])
                res["peak_below_expert2_bytes"] = [
                    peak_e - r["main"]["peak_bytes"] for r in ranks]
            if w in ("b", "d"):
                res["ep_buffer_per_rank"] = [r["ep_buffer"] for r in ranks]
            results[w] = res
        emit("train_sp_tp_moe_compose", reduced=(
            f"{t['layers']} of 20 layers (moe_350m: of 12), for the "
            "script's time"), micro_a_batch_rank=t["micro"], gas=t["gas"],
            steps=t["steps"], card=self.card,
            wire_note="gloo through host memory, the ranks sharing one "
                      "card", **results)
        emit("train_sp_tp_moe_compose/gates", card=self.card, gates=gates,
             limits=SP2_LIMITS, route_agree_min=ROUTE_AGREE_MIN,
             host_sync_vs_plain=HOST_SYNC_VS_PLAIN)
        if problems:
            raise AssertionError("train_sp_tp_moe_compose: "
                                 + "; ".join(problems))
        name = "train_sp_tp_moe_compose"
        for w, res in results.items():
            for r in res["per_rank"]:
                for k, v in r["launches"].items():
                    if v and k in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "rms_norm", "layer_norm",
                                   "fused_adam", "gmm", "tgmm"):
                        by = self.launches.setdefault(k, {})
                        key = f"{name}/{w}"
                        by[key] = by.get(key, 0) + v
            self.steps[f"{name}/{w}"] = t["steps"] * res["world"]
        self.state["sp_tp_moe_compose"] = {
            "seq_expert_buffer": results["b"]["ep_buffer_per_rank"][0],
            "tensor_expert_slice": results["d"]["ep_buffer_per_rank"][0],
            "steps": {w: dict(res["profile_rank0"], step_ms=res["step_ms"],
                              tokens_per_s=res["tokens_per_s"],
                              mfu=res["mfu"]) for w, res in results.items()}}

    def prepare_llama2_7b_tp2(self):
        """T1's one-process tick (``tp7b_reference``) and the job."""
        t = dict(TP7B, layers=TP7B_LAYERS)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_tp7b_")
        ref = tp7b_reference(t, self.dev, self.seed, tmp)
        return {"t": t, "ref": ref, "tmp": [tmp], "jobs": [
            Job("tp7b", "llama2_7b_tp2_rank", t["world"],
                dict(t, device=str(self.dev), ref=ref))]}

    def phase_llama2_7b_tp2(self):
        """Two ranks serve llama2_7b at {tensor: 2} (TP7B): the main path
        with its launches, eager ticks, T1-T3; decode tokens/s, TTFT p50
        and rank 0's idle share."""
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build
        from deepspeed_tpu_torch.ops import paged_attention as PA

        build.build_all()
        dev_free(self.dev)
        prep = self.prepared("llama2_7b_tp2")
        t, ref = prep["t"], prep["ref"]
        try:
            ranks, wall = self.spawn_job(prep["jobs"][0])
        finally:
            self.cleanup("llama2_7b_tp2")
        cfg = T.get_model_config(t["model"], num_layers=t["layers"])
        L = cfg.num_layers
        m0 = ranks[0]["main"]
        rows = m0["tick_rows"]
        want = serving_launches_want(L, rows, "rms_norm", PA.MIN_RUN)
        traffic = tp7b_traffic_want(cfg, rows, t["mesh"]["tensor"])
        problems = tp7b_problems(ranks, t, ref, cfg,
                                 graphs=self.dev.type == "cuda")
        d0 = ranks[0]["decode"]
        emit("llama2_7b_tp2", layers=L, mesh=t["mesh"], requests=t["n_req"],
             prompt_lens=m0["prompt_lens"], max_new_tokens=t["max_new"],
             reduced=(None if L == 32 else
                      f"{L} of 32 layers, for the script's time"),
             ticks=len(rows), tick_rows=sorted(set(rows)),
             launches=m0["launches"], launches_want=want,
             traffic=m0["traffic"], traffic_want=traffic,
             init_seconds=m0["init_seconds"],
             generate_all_seconds=m0["generate_all_seconds"],
             ttft_p50_s=m0["ttft_p50_s"], decode=d0,
             decode_tokens_per_s=d0["decode_tokens_per_s"],
             decode_tick_ms=d0["decode_tick_ms"],
             idle_share_rank0=d0.get("device_idle_share", "not measured"),
             peak_memory_bytes_per_rank=[r["main"]["peak_memory_bytes"]
                                         for r in ranks],
             pool_heads_per_rank=m0["pool_heads"], graphs=m0["graphs"],
             t1={"one_process": {k: v for k, v in ref.items()
                                 if k not in ("tick", "pool", "logits")},
                 "ranks": [r["t1"] for r in ranks]},
             phase_wall_s=wall, card=self.card,
             first_tokens={u: m0["tokens"][u][:4] for u in (0, 1)})
        if problems:
            raise AssertionError("llama2_7b_tp2: " + "; ".join(problems))
        for k in want:
            self.launches.setdefault(k, {})["llama2_7b_tp2"] = \
                m0["launches"][k]
        self.ticks["llama2_7b_tp2"] = len(rows)

    def prepare_train_llama_750m_offload(self, t=None):
        """The NVMe directory (emptied, its disk checked) and (d)'s int8
        job at world 2 (ZeRO-3 + qgZ + qwZ with and without offload_param
        cpu: no file of the directory is used)."""
        t = dict(OFFLOAD, **(t or {}))
        path = os.path.join(nvme_dir(), "750m")
        shutil.rmtree(path, ignore_errors=True)
        facts = host_facts(path)
        if facts["disk_free_bytes"] < NVME_MIN_FREE:
            raise RuntimeError(f"{path}: {facts['disk_free_bytes']} bytes "
                               f"free, the NVMe runs need {NVME_MIN_FREE}")
        return {"t": t, "path": path, "facts": facts, "tmp": [path],
                "jobs": [
            Job("offload/d_int8", "train_llama_750m_offload_param_rank", 2,
                dict(t, device=str(self.dev), nvme_path=path,
                     wire=OFFLOAD_INT8, runs=("none", "cpu")))]}

    def prepare_checkpoint_llama_750m(self, t=None):
        """The tags' root (emptied, its disk checked for CKPT_TAGS_FREE
        tags of C1's size) and C3's job at world 2, which writes under
        it."""
        from deepspeed_tpu_torch.models import transformer as T

        t = dict(CKPT, **(t or {}))
        depth = {} if t["layers"] is None else {"num_layers": t["layers"]}
        cfg = T.get_model_config(t["model"], **depth)
        root = ckpt_root()
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        tag_bytes = 12 * cfg.num_params()
        free = shutil.disk_usage(root).free
        if free < CKPT_TAGS_FREE * tag_bytes:
            raise RuntimeError(
                f"{root}: {free} bytes free, the checkpoint phase needs "
                f"{CKPT_TAGS_FREE} tags of {tag_bytes} bytes")
        c3 = os.path.join(root, "c3")
        return {"t": t, "root": root, "free": free, "tag_bytes": tag_bytes,
                "c3": c3, "tmp": [root], "jobs": [
                    Job("checkpoint/c3", "checkpoint_zero3_rank", 2,
                        dict(t, device=str(self.dev), root=c3))]}

    def prepare_quantized_reduce_scatter(self):
        return {"jobs": [Job(f"qrs/{w}", "quantized_reduce_scatter_rank", w,
                             dict(QRS, device=str(self.dev)))
                         for w in QRS["worlds"]]}

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
        prep = self.prepared("train_llama_750m_zeropp_dp2")
        t = prep["t"]
        world, gas, steps = t["world"], t["gas"], t["steps"]
        cfg = T.get_model_config(t["model"], num_layers=t["layers"])
        ranks, wall = self.spawn_job(prep["jobs"][0])
        L = cfg.num_layers
        micros = gas * steps
        # the publish's groups: the head group and one a chunk when the
        # plan has more than one chunk, else one group of every leaf
        groups = 1 + len(ZEROPP_CHUNKS) if len(ZEROPP_CHUNKS) > 1 else 1
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
                  "layers": L, "reduced": f"{L} of "
                  f"{T.get_model_config(t['model']).num_layers} layers, to "
                  "keep the whole script within its time",
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
        prep = self.prepared("train_llama_750m_zero3_dp2")
        t, mlp, mlp_ref = prep["t"], prep["mlp"], prep["mlp_ref"]
        world, gas, steps = t["world"], t["gas"], t["steps"]
        cfg = T.get_model_config(t["model"], num_layers=t["layers"])
        L = cfg.num_layers
        try:
            ranks, wall = self.spawn_job(prep["jobs"][0])
        finally:
            self.cleanup("train_llama_750m_zero3_dp2")
        baselines = [r["baseline"] for r in ranks]
        bounds = [list(b) for b in even_chunk_bounds(L, ZERO3_CHUNKS)]
        want = {run: zero3_launches_want(
            L, gas, steps, len(bounds), wire=run == "wire",
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
                    m["zero3_counts"], gas, len(bounds), run == "wire")]
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
        prep = self.prepared("train_llama_750m_hpz_dp4")
        t = prep["t"]
        world, gas, steps = t["world"], t["gas"], t["steps"]
        cfg = T.get_model_config(t["model"], num_layers=t["layers"])
        L = cfg.num_layers
        ranks, wall = self.spawn_job(prep["jobs"][0])
        bounds = [list(b) for b in even_chunk_bounds(L, ZERO3_CHUNKS)]
        want = {"trio": zero3_launches_want(
                    L, gas, steps, len(bounds), wire=True, loco=False,
                    replica=True,
                    adam_per_step=ranks[0]["trio"]["adam_per_step"]),
                "mics": zero3_launches_want(
                    L, gas, steps, len(bounds), wire=False,
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
                    m["zero3_counts"], gas, len(bounds), run == "trio")]
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
        prep = self.prepared("train_moe_350m_ep")
        ep_a, refs = prep["ep_a"], prep["refs"]
        try:
            runs = {label: self.spawn_job(job)
                    for label, job in zip("ab", prep["jobs"])}
        finally:
            self.cleanup("train_moe_350m_ep")
        problems, results = [], {}
        for label, t in (("a", ep_a), ("b", MOE_EP_B)):
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

    def phase_train_moe_350m_ep_zero(self):
        """The expert axis on every engine (MOE_EPZ, MOE_EPZ_WAYS,
        MOE_EPZ_DENSE): (g)'s one-process dense reference first, then
        the four ranks' ways (b)-(f) with their gates, then (g)'s two
        ranks; E6-E10, the launches, step ms, tokens/s, MFU by active
        parameters, peak a rank, the idle share of rank 0."""
        torch = self.torch
        from deepspeed_tpu_torch.models import transformer as T
        from deepspeed_tpu_torch.ops import build

        build.build_all()
        dev_free(self.dev)
        prep = self.prepared("train_moe_350m_ep_zero")
        t, ref = prep["t"], prep["ref"]
        walls = {}
        try:
            ranks, walls["b-f"] = self.spawn_job(prep["jobs"][0])
            dense, walls["g"] = self.spawn_job(prep["jobs"][1])
        finally:
            self.cleanup("train_moe_350m_ep_zero")
        problems = epz_problems(ranks, dense, t)
        cfg = T.get_model_config(t["model"], num_layers=t["layers"])
        L = cfg.num_layers
        n_w = 3 if cfg.activation == "swiglu" else 2
        runs = {label: [r["main"][label] for r in ranks]
                for label, _, _ in MOE_EPZ_WAYS}
        runs["g_dense"] = [r["main"] for r in dense]
        results = {}
        for label, per_rank in runs.items():
            world = len(per_rank)
            r0 = per_rank[0]
            want = moe_ep_launches_want(L, t["gas"], t["steps"], n_w,
                                        r0["adam_per_step"])
            if label == "g_dense":
                want.update(gmm=0, tgmm=0)
            int8 = label in ("d_zero2_int8_loco", "e_zero3_int8")
            for i, m in enumerate(per_rank):
                for k, v in want.items():
                    got = m["launches"][k]
                    if k in ("quant_int8", "dequant_reduce") and int8:
                        bad = got < 1
                    else:
                        bad = got != v
                    if bad:
                        problems.append(f"{label} rank {i}: {k} launched "
                                        f"{got} times, want "
                                        f"{'> 0' if int8 else v}")
            tokens = t["micro"] * t["seq"] * t["gas"] * world
            flops = flops_per_token(cfg, t["seq"]) * tokens
            step_s = r0["step_ms"] / 1e3
            peaks = [m["peak_memory_bytes"] for m in per_rank]
            if sum(peaks) > r0["card_bytes"]:
                problems.append(f"{label}: the ranks' peaks {sum(peaks)} "
                                f"past the card's {r0['card_bytes']}")
            mesh = (MOE_EPZ_DENSE["mesh"] if label == "g_dense"
                    else epz_way(label)[1])
            prof = r0["profile"]
            results[label] = {
                "mesh": mesh, "world": world,
                "zero": ({"stage": 2} if label == "g_dense"
                         else epz_way(label)[2]),
                "wire": r0["wire"], "step_ms": r0["step_ms"],
                "step_ms_per_rank": [m["step_ms"] for m in per_rank],
                "tokens_per_s": tokens / step_s,
                "model_tflops_per_s": flops / step_s / 1e12,
                "mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
                "peak_memory_bytes_per_rank": peaks,
                "device_idle_share_rank0": prof.get("device_idle_share",
                                                    "not measured"),
                "profile_rank0": prof, "losses_rank0": r0["losses"],
                "local_experts": r0["local_experts"],
                "n_sharded": r0["n_sharded"],
                "n_replicated": r0["n_replicated"],
                "launches_rank0": r0["launches"],
                "launches_want_per_rank": want,
                "traffic_rank0": r0["traffic"],
                "traffic_want_rank0": r0["traffic_want"],
                "wire_host_s_by_group_per_step": {
                    g: v / t["steps"] for g, v in
                    hpz_wire_seconds(r0["traffic"]).items()}}
            if "e7_wire" in r0:
                results[label]["e7_wire"] = [m["e7_wire"] for m in per_rank]
            name = f"train_moe_350m_ep_zero/{label}"
            for k, v in want.items():
                if v or (int8 and k in ("quant_int8", "dequant_reduce")):
                    self.launches.setdefault(k, {})[name] = \
                        r0["launches"][k]
            self.steps[name] = t["steps"]
        m2, m3 = runs["b_zero2"][0], runs["c_zero3"][0]
        margin = epz_memory_margin(m2, m3)
        emit("train_moe_350m_ep_zero", model=t["model"], layers=L,
             reduced=f"{L} of {T.get_model_config(t['model']).num_layers} "
                     "layers, for the script's time",
             micro=t["micro"], seq=t["seq"], gas=t["gas"], steps=t["steps"],
             params=cfg.num_params(), active_params=active_params(cfg),
             phase_wall_s=walls, card=self.card,
             wire_note="gloo through host memory, the ranks sharing one "
                       "card: the wires' time, not NVLink's",
             e10={"peak_zero3": m3["peak_memory_bytes"],
                  "peak_zero2": m2["peak_memory_bytes"],
                  "reckoned_margin": margin,
                  "gate": MOE_EPZ_MEMORY_SHARE * margin},
             **results)
        emit("train_moe_350m_ep_zero/gates", card=self.card,
             gate_depth=f"{L} layers, full width, gate_micro "
                        f"{t['gate_micro']}, gas 1",
             e6_e7=[r["gates"] for r in ranks],
             e9=[r["gates"] for r in dense],
             bounds={"training_rule": MOE_EP_LIMITS,
                     "bf16_vs_zero2": BF16_VS_PLAIN,
                     "wire_noise_share": WIRE_NOISE_SHARE,
                     "memory_share": MOE_EPZ_MEMORY_SHARE})
        if problems:
            raise AssertionError("train_moe_350m_ep_zero: "
                                 + "; ".join(problems))
        self.state["moe_ep_zero"] = {
            k: {"step_ms": v["step_ms"], "tokens_per_s": v["tokens_per_s"],
                "mfu": v["mfu"], "idle": v["device_idle_share_rank0"]}
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

        if self.dev.type == "cuda":
            build.build_all()
        dev_free(self.dev)
        prep = self.prepared("train_llama_750m_offload", t)
        t, path, facts = prep["t"], prep["path"], prep["facts"]
        cfg = T.get_model_config(t["model"], **(
            {"num_layers": t["layers"]} if t.get("layers") else {}))
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
                t, self.dev, zero, batch, layers=t.get("layers"),
                after_step=check,
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
        int8, int8_s = self.spawn_job(prep["jobs"][0])
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
        result = {"model": t["model"], "layers": L, "micro": t["micro"],
                  "seq": t["seq"], "gas": t["gas"], "steps": t["steps"],
                  "nvme_path": path,
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
        for job in self.prepared("quantized_reduce_scatter")["jobs"]:
            world = job.world
            ranks, _ = self.spawn_job(job)
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
        return profile_window(eng, n_ticks, self.dev)

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
                           ("rms_norm", 1536, 8192), ("rms_norm", 1536, 2048),
                           ("layer_norm", 768, 8),
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
        if "sp2" in self.state:
            # the kernels on Ulysses' head-sharded blocks (SP2's way (a))
            B, S, sp = SP2["micro"], SP2["seq"], SP2["mesh"]["seq"]
            fl["llama_750m_ulysses"] = self.flash_times(
                "llama_750m_ulysses", B, S, 12 // sp, 12 // sp, 128, flush)
        if "tp2" in self.state:
            # a tensor rank's heads (TP2's way (a)): the Ulysses blocks'
            # shape, timed once
            B, S, tp = TP2["micro"], TP2["seq"], TP2["mesh"]["tensor"]
            fl["llama_750m_tp2"] = fl.get("llama_750m_ulysses") or \
                self.flash_times("llama_750m_tp2", B, S, 12 // tp, 12 // tp,
                                 128, flush)
        if "pp2" in self.state:
            # a pipeline micro-batch (PP2's way (a)): one row, every head
            fl["llama_750m_pp2"] = self.flash_times(
                "llama_750m_pp2", PP2["micro"] // PP2["spec"][
                    "pipeline_micro_batches"], PP2["seq"], 12, 12, 128, flush)
        if "pp_compose" in self.state:
            # Ulysses' head shard of a pipeline micro-batch (PPC's way (b)):
            # one row, 6 of 12 heads
            b = PPC["micro"] // PPC["spec"]["pipeline_micro_batches"]
            fl["llama_750m_pp_seq2"] = self.flash_times(
                "llama_750m_pp_seq2", b, PPC["seq"], 6, 6, 128, flush)
        adam = (self.adam_times(flush) if "train_gpt2_125m" in self.state
                else None)
        if adam is not None and "pp_compose" in self.state:
            # a ZeRO-3 rank's local buffer at {pipe: 2, data: 2} (PPC (a))
            adam["zero3_stage_shard"] = self.adam_times(
                flush, self.state["pp_compose"]["zero3_n_local"])
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
        if "sp2" in self.state:
            for label, row in self.state["sp2"].items():
                steps[f"llama_750m_sp2_{label}"] = row
        if "tp2" in self.state:
            for label, row in self.state["tp2"].items():
                steps[f"llama_750m_tp2_{label}"] = row
        if "pp2" in self.state:
            for label, row in self.state["pp2"].items():
                steps[f"llama_750m_pp2_{label}"] = row
        if "pp_compose" in self.state:
            for label, row in self.state["pp_compose"]["steps"].items():
                steps[f"pp_compose_{label}"] = row
        if "sp_tp_moe_compose" in self.state:
            for label, row in self.state["sp_tp_moe_compose"][
                    "steps"].items():
                steps[f"sp_tp_moe_compose_{label}"] = row
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
        # the same tick at a tensor rank's heads (llama2_7b_tp2: 16 of 32)
        q, kp, vp, tables_m, lengths_m = ticks["mixed"]
        pa["mixed_tp2"] = self.pa_case(
            "paged_attention[mixed_tp2]",
            *(x[..., :16, :].contiguous() for x in (q, kp, vp)), tables_m,
            lengths_m, flush)
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

    def adam_times(self, flush, n=None):
        """Fused Adam over gpt2_125m's flat buffer (the main path's, with
        the bf16 compute copy written), or over ``n`` elements: kernel,
        plain, and ``torch.optim.AdamW(fused=True).step()`` as the
        yardstick (no compute copy)."""
        torch = self.torch
        from deepspeed_tpu_torch.ops import fused_adam as FA

        n = n or self.state["train_gpt2_125m"]["flat_n"]
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
        # MoE serving's decode tick (the kernel's serving role): 8 rows,
        # top-k choices each, over the up projection's [E, H, Fe] weights,
        # the routed rows spread evenly over the experts
        M = 8 * cfg.moe_top_k
        sizes = np.full(E, M // E, np.int32)
        sizes[:M % E] += 1
        gs = torch.from_numpy(sizes).to(self.dev)
        offs = torch.cumsum(gs, 0).to(torch.int32)
        x = torch.randn(M, H, generator=g, device=self.dev).to(bf)
        w = (torch.randn(E, H, Fe, generator=g, device=self.dev)
             / H ** 0.5).to(bf)
        nbytes = 2 * (x.numel() + w.numel() + M * Fe) + 4 * E
        row = out["gmm[serving_decode]"] = dict(
            self.bound(nbytes, 2.0 * M * H * Fe),
            ms=self.time_ms(lambda: GG.gmm(x, w, gs), flush=flush),
            plain_ms=self.time_ms(lambda: GG.gmm_ref(x, w, gs), iters=5,
                                  flush=flush),
            library_ms=self.time_ms(
                lambda: torch._grouped_mm(x, w, offs=offs), flush=flush),
            library="torch._grouped_mm",
            shape={"M": M, "K": H, "N": Fe, "E": E, "decode_rows": 8,
                   "group_sizes": sizes.tolist(), "dtype": "bfloat16"})
        row["tflops_per_s"] = row["flops"] / row["ms"] / 1e9
        del x, w
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
        if "pp2" in self.state:
            # train_llama_750m_pp2's role: a pipeline micro-batch's rows
            timed["rms_norm"]["pipeline"] = nm["rms_norm[R=2048]"]
        if pa is not None:
            # the wrapper's call at the tick each kernel serves (CUDA events,
            # as every row); the kernel's own profiler time beside it
            for name, case in (("paged_attention_decode", "decode"),
                               ("paged_attention_prefill", "prefill")):
                timed[name] = dict(pa[case], library_ms=None,
                                   kernel_ms=pa[case]["kernel_ms"][name])
                # llama2_7b_tp2's role: the mixed tick at a rank's 16 heads
                tp = pa["mixed_tp2"]
                timed[name]["tensor_parallel"] = {
                    "tick": "mixed, N = K = 16", "ms": tp["ms"],
                    "kernel_ms": tp["kernel_ms"][name],
                    "plain_ms": tp["plain_ms"], "bound_ms": tp["bound_ms"],
                    "max_abs_err": tp["max_abs_err"]}
            timed["paged_attention_plan"] = dict(pa["plan"], library_ms=None)
        if adam is not None and "fused_adam" in self.errs:
            timed["fused_adam"] = dict(adam,
                                       max_abs_err=self.errs["fused_adam"])
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            if name in self.errs:
                timed[name] = dict(fl["gpt2_125m"][name],
                                   max_abs_err=self.errs[name])
                if "llama_750m_ulysses" in fl:
                    timed[name]["ulysses"] = fl["llama_750m_ulysses"][name]
                if "llama_750m_tp2" in fl:
                    # train_llama_750m_tp2's role: a rank's 6 heads
                    timed[name]["tensor_parallel"] = \
                        fl["llama_750m_tp2"][name]
                if "llama_750m_pp2" in fl:
                    # train_llama_750m_pp2's role: a pipeline micro-batch
                    timed[name]["pipeline"] = fl["llama_750m_pp2"][name]
                if "llama_750m_pp_seq2" in fl:
                    # train_llama_750m_pp_compose (b): Ulysses' head shard
                    # of a pipeline micro-batch
                    timed[name]["pipe_seq"] = fl["llama_750m_pp_seq2"][name]
        for name, key in (("gmm", "gmm[up]"), ("tgmm", "tgmm[up]")):
            if gg is not None and name in self.errs:
                timed[name] = dict(gg[key], max_abs_err=self.errs[name])
                if "moe_ep" in self.state and name == "gmm":
                    # the kernel on a rank's real received buffer (E3)
                    e3 = self.state["moe_ep"]["a"]["e3"]
                    timed[name]["ep_buffer"] = {
                        k: e3.get(k) for k in (
                            "rows", "routed_rows", "group_sizes",
                            "gmm_max_abs_err", "gmm_ms", "gmm_plain_ms",
                            "gmm_library_ms", "gmm_library")}
                if name == "gmm":
                    timed[name]["serving_decode"] = gg["gmm[serving_decode]"]
                if "sp_tp_moe_compose" in self.state and name == "gmm":
                    # an {expert: 2, seq: 2} rank's received buffer (STM
                    # b) and an {expert: 2, tensor: 2} rank's over its
                    # experts' mlp slices (STM d)
                    for role in ("seq_expert_buffer",
                                 "tensor_expert_slice"):
                        e = self.state["sp_tp_moe_compose"][role]
                        routed, K, N = e["routed_rows"], e["K"], e["N"]
                        E = len(e["group_sizes"])
                        timed[name][role] = dict(
                            {k: e.get(k) for k in (
                                "rows", "routed_rows", "group_sizes", "K",
                                "N", "gmm_max_abs_err", "gmm_ms",
                                "gmm_plain_ms", "gmm_library_ms",
                                "gmm_library")},
                            **self.bound(2 * (routed * K + E * K * N
                                              + e["rows"] * N),
                                         2 * routed * K * N))
                if "pp_compose" in self.state and name == "gmm":
                    # a {pipe: 2, expert: 2} rank's received buffer (PPC c)
                    e = self.state["pp_compose"]["ep_buffer"]
                    routed, K, N = e["routed_rows"], e["K"], e["N"]
                    E = len(e["group_sizes"])
                    timed[name]["pipe_expert_buffer"] = dict(
                        {k: e.get(k) for k in (
                            "rows", "routed_rows", "group_sizes",
                            "gmm_max_abs_err", "gmm_ms", "gmm_plain_ms",
                            "gmm_library_ms", "gmm_library")},
                        **self.bound(2 * (routed * K + E * K * N
                                          + e["rows"] * N),
                                     2 * routed * K * N))
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
                          "replica_hop", "ep_buffer", "serving_decode",
                          "ulysses", "tensor_parallel", "pipeline",
                          "pipe_seq", "pipe_expert_buffer",
                          "seq_expert_buffer", "tensor_expert_slice",
                          "zero3_stage_shard"):
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
    smoke.phases = phases
    t_start = time.perf_counter()
    timed = None
    done = {}
    try:
        for phase in phases:
            t0 = time.perf_counter()
            smoke.current = phase
            try:
                res = getattr(smoke, f"phase_{phase}")()
            except Exception as e:
                emit(phase, error=f"{type(e).__name__}: {e}")
                print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
                raise
            smoke._ran.add(phase)
            if phase == "times":
                timed = res
            done[phase] = time.perf_counter() - t0
            emit(f"{phase}/done", seconds=done[phase])
    finally:
        for phase in list(smoke._prepared):
            smoke.cleanup(phase)
    emit("phase_seconds", merged=MERGED_SPAWNS, prepared=smoke.phase_parts,
         by_phase=smoke.phase_seconds(done))
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
