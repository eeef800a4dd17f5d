#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

Drives the port's serving and training paths on the card and holds every
kernel on them against its plain PyTorch version:

1. card      — nvidia-smi name and power limit, torch device name and count;
2. build     — nvcc builds of ``ops/csrc/*.cu`` (one process per source,
               started together) and Triton's first compile, timed;
3. kernels   — paged attention, RMSNorm/LayerNorm, flash attention
               (forward, dq, dkv), fused Adam and the grouped GEMM (gmm,
               gmm with the rhs transposed, tgmm) against their plain
               versions, bf16 and fp32, at the main-path shapes and edge
               cases (unaligned S, GQA, non-causal; ragged groups, an empty
               group, moe_1b's width);
4. llama2_7b — ``FastGenEngine`` at full width and depth (random weights
               from a seed, bf16) serves 8 requests through ``generate_all``;
               launch counters prove every tick went through the kernels;
               one mixed tick's logits on the kernel path vs the plain path;
5. gpt2_125m — the LayerNorm / learned-position / GELU path, same checks;
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
9. times     — kernels vs plain vs library calls vs their bounds (CUDA
               events), decode tokens/s, TTFT, training step time, tokens/s,
               MFU (active parameters), idle share, the profiler's split of
               a step, peak memory.

Prints one JSON line per phase, then the nvidia-smi line, then the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero without the last line. It needs one CUDA device
and the repository beside it, and does not import jax.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases card,build,kernels
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
PHASES = ("card", "build", "kernels", "llama2_7b", "gpt2_125m",
          "train_gpt2_125m", "train_llama_750m", "train_moe_350m", "times")

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
# (label, B, S, N, K, D, causal): the two main-path shapes, then edges
FLASH_CASES = (("gpt2_125m", 32, 1024, 12, 12, 64, True),
               ("llama_750m", 4, 2048, 12, 12, 128, True),
               ("moe_350m", 16, 1024, 12, 12, 64, True),
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
# then the training main path's, micro x seq rows (llama_750m's H 1536 is
# a masked BLOCK_H 2048 program)
NORM_CASES = (("rms_norm", 4096, (1, 37, 256)), ("rms_norm", 1536, (8192,)),
              ("layer_norm", 768, (1, 37, 256, 32768)))
# Training runs: the repo's headline settings (bench.py train_bench), the
# zero3_llama_750m_bf16 row's shape and the moe_ulysses_moe_350m_bf16 row's
# (bench.py), at ZeRO stage 1 (one process partitions nothing), flash
# attention (ulysses_flash at sequence world 1) and remat full
TRAIN = {"gpt2_125m": dict(micro=32, seq=1024, gas=4, steps=4,
                           norm="layer_norm", gate_micro=2),
         "llama_750m": dict(micro=4, seq=2048, gas=4, steps=3,
                            norm="rms_norm", gate_micro=1),
         "moe_350m": dict(micro=16, seq=1024, gas=4, steps=3,
                          norm="layer_norm", gate_micro=2)}
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


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, torch, seed: int):
        self.torch = torch
        self.seed = seed
        self.dev = torch.device("cuda:0")
        self.card = ""
        self.launches = {}       # kernel → {model: launches on its run}
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

        t0 = time.perf_counter()
        build.build_all()
        nvcc_s = time.perf_counter() - t0
        ptxas = {name: [ln.strip() for ln in str(log["ptxas"]).splitlines()
                        if "Used" in ln or "spill" in ln
                        or "entry function" in ln]
                 for name, log in build.build_log.items()}
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
        emit("kernels", checks=rows)

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
                o, lse = PF.flash_fwd(q, k, v, causal)
                ro, rlse = PF.flash_fwd_ref(q, k, v, causal)
                self.sync()
                tag = f"[{label},{dtype}]"
                errs = {"o": self.close_tol("flash_fwd.o" + tag, o, ro,
                                            FLASH_TOL[dtype]),
                        "lse": self.close_tol("flash_fwd.lse" + tag, lse,
                                              rlse, FLASH_TOL["float32"])}
                del ro, rlse
                grads = PF.flash_bwd(q, k, v, o, lse, do, causal)
                refs = PF.flash_bwd_ref(q, k, v, o, lse, do, causal)
                self.sync()
                for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
                    errs[name] = self.close_tol(f"flash_bwd.{name}{tag}",
                                                got, want, FLASH_TOL[dtype])
                if label == "gpt2_125m" and dtype == "bfloat16":
                    self.errs.update(flash_fwd=max(errs["o"], errs["lse"]),
                                     flash_bwd_dq=errs["dq"],
                                     flash_bwd_dkv=max(errs["dk"],
                                                       errs["dv"]))
                rows.append({"kernel": "flash_attention", "shape": label,
                             "B": B, "S": S, "N": N, "K": K, "D": D,
                             "causal": causal, "dtype": dtype,
                             "max_abs_err": errs, "tol": FLASH_TOL[dtype]})
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
        for model in TRAIN:
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

    # ------------------------------------------------------------------ #
    def counters(self):
        from deepspeed_tpu_torch.ops import flash_attention as PF
        from deepspeed_tpu_torch.ops import fused_adam as FA
        from deepspeed_tpu_torch.ops import grouped_gemm as GG
        from deepspeed_tpu_torch.ops import norms
        from deepspeed_tpu_torch.ops import paged_attention as PA

        return (PA.launches, norms.launches, PF.launches, FA.launches,
                GG.launches)

    def reset_counts(self):
        from deepspeed_tpu_torch.ops import norms

        for d in self.counters() + (norms.backward_calls,):
            for k in d:
                d[k] = 0

    def read_counts(self):
        out = {}
        for d in self.counters():
            out.update(d)
        return out

    def serve(self, model, n_req, lo, hi, max_new, norm_kind, **engine_kw):
        """One model's main-path run + checks + a mixed-tick comparison."""
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
        cfg = eng.cfg
        vocab = min(cfg.vocab_size, 32000)
        rng = np.random.default_rng(self.seed)
        lens = [int(n) for n in rng.integers(lo, hi + 1, n_req)]
        prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
        uids = list(range(n_req))
        free0 = eng.allocator.free_blocks
        ticks = telemetry.get_registry().counter("fastgen_ticks_total")

        # ---- the main path: counts to 0 just before, read just after ---- #
        ticks0 = ticks.total()
        self.reset_counts()
        t0 = time.perf_counter()
        out = eng.generate_all(uids, prompts, max_new_tokens=max_new)
        self.sync()
        wall = time.perf_counter() - t0
        counts = self.read_counts()
        n_ticks = int(ticks.total() - ticks0)
        # ----------------------------------------------------------------- #
        L = cfg.num_layers
        want = {"paged_attention": L * n_ticks,
                norm_kind: (2 * L + 1) * n_ticks}
        problems = []
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
             ticks=n_ticks, launches=counts, launches_want=want,
             init_seconds=init_s, generate_all_seconds=wall,
             ttft_p50_s=float(np.median(ttft)), peak_memory_bytes=peak,
             card=self.card, first_tokens={u: out[u][:4] for u in uids[:2]})

        self.mixed_tick(model, eng, uids, prompts)
        self.state[model] = {"engine": eng, "prompts": prompts, "lens": lens}
        return eng

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
        n_dec = sum(1 for h in heads if h[2])
        emit(f"{model}/mixed_tick", rows=row, decode_rows=n_dec,
             prefill_rows=row - n_dec, table_width=mb, blocks=len(used),
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
        torch.cuda.reset_peak_memory_stats(self.dev)
        base = torch.cuda.memory_allocated(self.dev)   # earlier phases' engines
        t0 = time.perf_counter()
        spec = dtt.causal_lm_spec(model, attention="flash", remat="full")
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
        want = {"flash_fwd": 2 * L * micros,     # remat: forward runs twice
                "flash_bwd_dq": L * micros, "flash_bwd_dkv": L * micros,
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
        result = {"micro": micro, "seq": seq, "gas": gas, "steps": steps,
                  "params": cfg.num_params(),
                  "active_params": active_params(cfg), "init_seconds": init_s,
                  "warmup_step_seconds": warm_s, "losses": [first] + losses,
                  "step_walls_s": walls, "step_ms": step_s * 1e3,
                  "tokens_per_s": tokens / step_s,
                  "model_tflops_per_s": flops / step_s / 1e12,
                  "mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
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
            result["launches_per_step"] = {
                k: counts[k] / steps for k in ("gmm", "tgmm")}
        emit(f"train_{model}", **result)
        self.state[f"train_{model}"] = dict(result, engine=engine,
                                            data=data, batch=batch)
        self.train_gate(model, engine, batch)

    def train_gate(self, model, main, batch):
        """One optimizer step, four ways ({fp32, bf16} x {kernels, plain}),
        from the main path's fp32 master on the first ``gate_micro`` rows of
        its batch; each against the fp32 plain step. Every way runs the
        config's Adam (the kernel, held against its plain version in the
        kernels phase), so the paths differ only in the model's kernels;
        each way's update is also held against step 1 of Adam computed here
        from its own gradient."""
        torch = self.torch
        import deepspeed_tpu_torch as dtt
        from deepspeed_tpu_torch.models.convert import load_master

        t = TRAIN[model]
        tokens = batch["tokens"][:t["gate_micro"]]
        moe = main.model_spec.config.n_experts > 0
        L = main.model_spec.config.num_layers
        ref = None
        res = {}
        for prec, path in (("fp32", "plain"), ("fp32", "kernels"),
                           ("bf16", "plain"), ("bf16", "kernels")):
            spec = dtt.causal_lm_spec(
                model, attention="flash", remat="full",
                use_kernels=path == "kernels",
                dtype="float32" if prec == "fp32" else "bfloat16")
            engine, *_ = dtt.initialize(model=spec, config=self.train_config(
                t["gate_micro"], 1, prec))
            load_master(engine, main.state["master"])
            before = engine.flat_master.clone()
            # routes: the forward's L layers, then the recompute's
            with recorded_routes() as routes:
                loss = float(engine.train_batch(iter([{"tokens": tokens}])))
            norm = engine.get_global_grad_norm()
            grad = engine.flat_grad_acc.float()     # unscaled, gas 1
            update = engine.flat_master - before
            del before
            # step 1 of Adam, no weight decay: m̂ = g, v̂ = g²
            adam = -TRAIN_LR * grad / (grad.abs() + 1e-8)
            row = {"loss": loss, "grad_norm": norm,
                   "adam_rel": float((update - adam).norm() / adam.norm())}
            del adam
            if moe:
                idx = torch.stack([r[0] for r in routes[:L]])
                aux = float(sum(r[1] for r in routes[:L]))
                row["aux_loss"] = aux
            if ref is None:
                ref = {"loss": loss, "norm": norm, "grad": grad.clone(),
                       "update": update.clone()}
                if moe:
                    ref.update(idx=idx, aux=aux)
                    row["routed_pairs"] = idx.numel()
            else:
                if moe:
                    row.update(
                        route_agree=float((idx == ref["idx"]).float().mean()),
                        aux_rel=abs(aux - ref["aux"]) / abs(ref["aux"]))
                    row["route_miss"] = 1.0 - row["route_agree"]
                row.update(
                    loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                    norm_rel=abs(norm - ref["norm"]) / ref["norm"],
                    grad_rel=float((grad - ref["grad"]).norm()
                                   / ref["grad"].norm()),
                    update_rel=float((update - ref["update"]).norm()
                                     / ref["update"].norm()),
                    sign_miss=float((torch.sign(update)
                                     != torch.sign(ref["update"]))
                                    .float().mean()))
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
        emit(f"train_{model}/step_gate", micro=t["gate_micro"],
             seq=t["seq"], fp32_plain=res[("fp32", "plain")],
             fp32_kernels=k32, bf16_plain=pb, bf16_kernels=kb,
             bounds=dict(limits, bf16_vs_plain=BF16_VS_PLAIN,
                         bf16_floored=BF16_FLOORED, adam_rel=TRAIN_ADAM_REL),
             card=self.card)
        if problems:
            raise AssertionError(f"train {model}: step kernel vs plain: "
                                 + "; ".join(problems))

    def phase_train_gpt2_125m(self):
        self.train("gpt2_125m")

    def phase_train_llama_750m(self):
        self.train("llama_750m")

    def phase_train_moe_350m(self):
        self.train("moe_350m")

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
        """Kernel / plain / bound / SDPA-on-pre-gathered-KV times."""
        torch = self.torch
        import torch.nn.functional as F
        from deepspeed_tpu_torch.ops import paged_attention as PA

        Tn, N, D = q.shape
        _, bs, K, _ = kp.shape
        elt = q.element_size()
        got = PA.paged_attention(q, kp, vp, tables, lengths)
        want = PA.paged_attention_reference(q, kp, vp, tables, lengths)
        err = self.close(name, got, want, str(q.dtype).split(".")[-1])
        tb, ln = tables.cpu().numpy(), lengths.cpu().numpy()
        blocks = {int(tb[t, j]) for t in range(Tn)
                  for j in range(-(-int(ln[t]) // bs))}
        kv_bytes = len(blocks) * bs * K * D * 2 * elt
        io_bytes = 2 * q.numel() * elt + tables.numel() * 4 + Tn * 4
        flops = float(4 * N * D * ln.astype(np.int64).sum())
        t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
        ms = self.time_ms(lambda: PA.paged_attention(q, kp, vp, tables,
                                                     lengths), flush=flush)
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
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "unique_kv_bytes": kv_bytes, "rows": Tn,
                "sdpa_pregathered_ms": sdpa}

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
        """Prefill the main path's prompts with step() ticks, then time one
        fused decode window of 32 ticks (host clock around synchronised
        work), and profile one more window of 8 for the device's share."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        st = self.state[model]
        eng, prompts = st["engine"], st["prompts"]
        uids = list(range(100, 100 + len(prompts)))
        eng.put(uids, prompts)
        self.sync()
        t0 = time.perf_counter()
        n_steps = 0
        while not all(s.prefill_remaining == 0 and s.last_tok is not None
                      for s in eng.seqs.values()):
            eng.step()
            n_steps += 1
        self.sync()
        prefill_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = eng.decode_steps(32)
        self.sync()
        wall = time.perf_counter() - t0
        n_tok = sum(len(v) for v in got.values())

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got2 = eng.decode_steps(8)
            self.sync()
        n_ticks = 8 if got2 else 0
        spans = {"decode_window", "decode_tick", "schedule_tick"}
        dev_us = {}     # kernels only: ops and span ranges would double count
        n_kernels = 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.key in spans \
                    or getattr(e, "is_user_annotation", False):
                continue
            t = float(getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
            if t:
                dev_us[e.key] = dev_us.get(e.key, 0.0) + t
                n_kernels += e.count
        total_us = sum(dev_us.values())
        by_kind = {}
        for key, us in dev_us.items():
            low = key.lower()
            kind = ("paged_attention" if "paged_attention" in low
                    else "rms_norm" if "rms_norm" in low
                    else "layer_norm" if "layer_norm" in low
                    else "gemm" if any(w in low for w in (
                        "gemm", "nvjet", "cutlass", "matmul", "sm90_xmma"))
                    else "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / max(n_ticks, 1)
        eng.flush(uids)
        tick_ms = wall / 32 * 1e3
        dev_ms = total_us / 1e3 / n_ticks if total_us and n_ticks else None
        return {"batch": len(prompts), "prefill_steps": n_steps,
                "prefill_wall_s": prefill_wall,
                "prefill_tokens_per_s": sum(st["lens"]) / prefill_wall,
                "decode_tokens": n_tok, "decode_wall_s": wall,
                "decode_tokens_per_s": n_tok / wall, "decode_tick_ms": tick_ms,
                "profiled_ticks": n_ticks,
                "kernels_per_tick": (n_kernels / n_ticks if n_kernels
                                     else "not measured"),
                "device_ms_per_tick": dev_ms or "not measured",
                "device_ms_per_tick_by_kind": by_kind or "not measured",
                "device_idle_share": (1 - dev_ms / tick_ms if dev_ms
                                      else "not measured"),
                "top_kernels_us": {k[:90]: v for k, v in sorted(
                    dev_us.items(), key=lambda kv: -kv[1])[:8]}}

    def phase_times(self):
        torch = self.torch
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=self.dev)
        llama = self.state.get("llama2_7b")
        gpt2 = self.state.get("gpt2_125m")
        if llama is None or gpt2 is None or any(
                f"train_{m}" not in self.state for m in TRAIN):
            raise RuntimeError("times: run the serving and training phases "
                               "first")
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
        pa["prefill"] = self.pa_case(
            "paged_attention[prefill]", q, kp, vp, tables.expand(256, -1)
            .contiguous(), torch.tensor(chunk, dtype=torch.int32,
                                        device=self.dev), flush)
        del q, kp, vp, tables, args
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
        rates = {m: self.decode_rate(m) for m in ("llama2_7b", "gpt2_125m")}
        emit("times", card=self.card, paged_attention=pa, norms=nm,
             decode=rates, peak_memory_bytes=torch.cuda.max_memory_allocated(
                 self.dev))
        del eng, llama, gpt2                     # free the serving engines
        for m in ("llama2_7b", "gpt2_125m"):
            self.state.pop(m)
        torch.cuda.empty_cache()
        fl = {label: self.flash_times(label, B, S, N, K, D, flush)
              for label, B, S, N, K, D, _ in FLASH_CASES[:3]}
        adam = self.adam_times(flush)
        gg = self.gmm_times(flush)
        nb = self.norm_bwd_times(flush)
        steps = {m: self.train_profile(m) for m in TRAIN}
        emit("times/train", card=self.card, flash=fl, fused_adam=adam,
             grouped_gemm=gg, norm_backward=nb, steps=steps)
        return pa, nm, fl, adam, gg

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
        del q, k, v, do, o, lse, delta, qr, kr, vr, fo
        torch.cuda.empty_cache()
        return out

    def adam_times(self, flush):
        """Fused Adam over gpt2_125m's flat buffer (the main path's, with
        the bf16 compute copy written): kernel, plain, and
        ``torch.optim.AdamW(fused=True).step()`` as the yardstick (no
        compute copy)."""
        torch = self.torch
        from deepspeed_tpu_torch.ops import fused_adam as FA

        n = self.state["train_gpt2_125m"]["engine"].flat_master.numel()
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
        cfg = st["engine"].model_spec.config
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
                out[f"{op}[{proj}]"] = dict(
                    self.bound(nbytes, 2.0 * M * K * N),
                    ms=self.time_ms(kern, flush=flush),
                    plain_ms=self.time_ms(plain, iters=5, flush=flush),
                    library_ms=self.time_ms(lib, flush=flush),
                    library="torch._grouped_mm",
                    shape={"M": M, "K": K, "N": N, "E": E,
                           "group_sizes": sizes.tolist(),
                           "dtype": "bfloat16"})
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
        """One more step of the main-path engine under torch.profiler: the
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
            low = e.key.lower()
            kind = ("moe_tgmm" if "gmm_kernel<" in low and ", 2>" in low
                    else "moe_gmm" if "gmm_kernel<" in low
                    else "flash_fwd" if "flash_fwd_kernel" in low
                    else "flash_bwd_dq" if "flash_bwd_dq_kernel" in low
                    else "flash_bwd_dkv" if "flash_bwd_dkv_kernel" in low
                    else "fused_adam" if "fused_adam_kernel" in low
                    else "norm_fwd" if "norm_fwd" in low
                    else "gemm" if any(w in low for w in (
                        "gemm", "nvjet", "cutlass", "matmul", "sm90_xmma"))
                    else "other")
            kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
            n_kernels += e.count
        device_ms = sum(kinds.values())
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
                "annotated_device_ms": spans or "not measured",
                "moe_device_ms": moe or None,
                "kernels_per_step": n_kernels or "not measured",
                "profiled_step_ms": wall_ms,
                "device_idle_share": (1 - device_ms / wall_ms
                                      if device_ms else "not measured")}

    def kernels_line(self, pa, nm, fl, adam, gg):
        src = {"paged_attention": ("cuda",
                                   "deepspeed_tpu_torch/ops/csrc/"
                                   "paged_attention.cu",
                                   "deepspeed_tpu/ops/pallas/"
                                   "paged_attention.py:40"),
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
                     "deepspeed_tpu/moe/layer.py:185")})
        timed = {"paged_attention": dict(pa["decode"], library_ms=None),
                 "rms_norm": nm["rms_norm[R=8]"],
                 "layer_norm": nm["layer_norm[R=8]"],
                 "fused_adam": dict(adam, max_abs_err=self.errs["fused_adam"])}
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            timed[name] = dict(fl["gpt2_125m"][name],
                               max_abs_err=self.errs[name])
        for name, key in (("gmm", "gmm[up]"), ("tgmm", "tgmm[up]")):
            timed[name] = dict(gg[key], max_abs_err=self.errs[name])
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
            if "sdpa_fwd_bwd_ms" in t:
                out[-1]["sdpa_fwd_bwd_ms"] = t["sdpa_fwd_bwd_ms"]
        return {"kernels": out}


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
        print(json.dumps(smoke.kernels_line(*timed)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
