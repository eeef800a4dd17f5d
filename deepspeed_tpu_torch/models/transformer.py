"""Model zoo subset of the port: config, presets, init, the layer pieces the
paged serving forward uses, and the training forward (``forward_hidden``,
``forward``, the LM losses) with their gradients.

Parity: ``deepspeed_tpu/models/transformer.py``. ``TransformerConfig`` is
copied field for field with the same defaults, and ``PRESETS`` with the same
values, so the two packages' presets compare equal (``dataclasses.asdict``).
Parameters keep the JAX pytree's keys and shapes (per-layer weights stacked
on a leading layer dim: ``blocks.wq [L, H, N*D]``), so weights carry across
as plain tensors.

Numerics follow the JAX package: matmuls in the compute dtype, fp32 norm
statistics, fp32 softmax, fp32 logits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.ops import norms

Params = Dict[str, Any]

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # None → MHA; < num_heads → GQA
    ffn_hidden_size: Optional[int] = None
    max_seq_len: int = 1024
    pos_emb: str = "learned"            # learned | rope | alibi | none
    norm: str = "layernorm"             # layernorm | rmsnorm
    activation: str = "gelu"            # gelu | swiglu | relu
    use_bias: bool = True
    qkv_bias: bool = False              # bias on q/k/v only (Qwen2-style)
    parallel_block: bool = False        # attn + FFN in parallel (Falcon/NeoX/Phi)
    shared_parallel_norm: bool = False  # parallel block, ONE norm feeds both
                                        # branches (Falcon new-arch, Phi)
    emb_norm: bool = False              # layernorm after embedding (BLOOM)
    alibi_bias_scale: float = 1.0       # Falcon folds 1/sqrt(d) into the bias
    lm_head_bias: bool = False          # bias on the LM head (Phi)
    rope_fraction: float = 1.0          # partial rotary (NeoX 0.25, Phi-2 0.4)
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    init_std: float = 0.02
    dtype: str = "bfloat16"             # compute dtype
    remat: str = "none"   # none | full (= save_nothing) | dots_saveable |
    #                         selective (save attn_out+ffn_act) |
    #                         offload_dots (selective saves live on pinned host)
    causal: bool = True                 # False → bidirectional encoder (BERT)
    # QAT activation quantization (reference compression/basic_layer.py
    # QuantAct): fake-quantize the normed hidden stream feeding each
    # block's linears (STE backward). 0 = off; set via the
    # compression_training "activation_quantization" config section.
    act_quant_bits: int = 0
    # MoE (reference deepspeed/moe/; 0 experts → dense FFN)
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_min_capacity: int = 4
    moe_aux_coef: float = 0.01
    moe_dispatch: str = "auto"  # auto | ragged (dropless) | dense (GShard)
    # MoE routing/arch variants (AutoEP presets: mixtral/qwen-moe/deepseek)
    moe_ffn_size: Optional[int] = None  # routed-expert intermediate (≠ dense ffn)
    moe_shared_size: int = 0            # shared-expert intermediate; 0 = none
    moe_shared_gate: bool = False       # sigmoid gate on shared out (Qwen2-MoE)
    moe_score_func: str = "softmax"     # softmax | sigmoid (DeepSeek-V3)
    moe_route_norm: bool = True         # renormalize top-k weights to sum 1
    moe_route_scale: float = 1.0        # routed_scaling_factor (DeepSeek)
    qk_norm: bool = False               # RMSNorm on q/k head dim (Qwen3)
    attn_head_dim: Optional[int] = None  # explicit head dim (Qwen3 ≠ H/N)
    # MLA — Multi-head Latent Attention (DeepSeek V2/V3): queries and KV are
    # projected through low-rank latents; only the latent c_kv (+ the shared
    # rope key) is cached at decode — the 93%-smaller-KV-cache trick.
    mla: bool = False
    q_lora_rank: Optional[int] = None   # None → direct q projection (V2-lite)
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_interleave: bool = True        # DeepSeek stores rope pairs interleaved
    # HF rope_scaling dict, canonicalized to a sorted tuple of items so the
    # frozen config stays hashable (None = unscaled)
    rope_scaling: Optional[Tuple[Tuple[str, Any], ...]] = None
    # DeepSeek-V3 router extras (moe/gating.py)
    moe_gate_bias: bool = False         # e_score_correction_bias parameter
    moe_n_group: int = 1                # node-limited routing groups
    moe_topk_group: int = 1
    # compute-time QKV fusion: one [H, q+k+v] matmul instead of three (the
    # reference's fused-QKV transformer kernels, csrc/transformer
    # attn_quantizer/transform kernels). Params stay separate (importers,
    # TP axes unchanged); the concat happens per layer inside the step and
    # XLA materializes it once per weight version.
    fuse_qkv: bool = False
    # overlap scheduler (parallel/overlap.py; reference stage3 prefetch +
    # IPG buckets): split the layer scan into this many sequential chunk
    # scans so ZeRO-3 gathers one chunk ahead of compute and each chunk's
    # gradient sync is final mid-backward. 0/1 = single scan (today's
    # program). Numerics are identical either way; the engine sets this
    # from stage3_prefetch_bucket_size / reduce_bucket_size.
    scan_chunks: int = 0

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        if self.attn_head_dim is not None:
            return self.attn_head_dim
        return self.hidden_size // self.num_heads

    @property
    def moe_ffn(self) -> int:
        """Routed-expert intermediate size."""
        return self.moe_ffn_size if self.moe_ffn_size is not None else self.ffn_size

    @property
    def ffn_size(self) -> int:
        if self.ffn_hidden_size is not None:
            return self.ffn_hidden_size
        if self.activation == "swiglu":
            # Llama sizing: 2/3 * 4H rounded to multiple of 256
            raw = int(8 * self.hidden_size / 3)
            return 256 * ((raw + 255) // 256)
        return 4 * self.hidden_size

    @property
    def compute_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def attn_bias_enabled(self) -> bool:
        return self.use_bias or self.qkv_bias

    @property
    def rope_scaling_dict(self) -> Optional[Dict[str, Any]]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def mla_scale_mult(self) -> float:
        """DeepSeek yarn: softmax scale gains mscale(factor, mscale_all_dim)²
        on top of the cos/sin attention factor (HF DeepseekV3Attention)."""
        sc = self.rope_scaling_dict
        if not sc or not self.mla:
            return 1.0
        mall = sc.get("mscale_all_dim", 0)
        factor = float(sc.get("factor", 1.0))
        if mall and factor > 1:
            m = 0.1 * float(mall) * math.log(factor) + 1.0
            return m * m
        return 1.0

    @property
    def rope_dim(self) -> int:
        """Rotary dims (even), = head_dim * rope_fraction."""
        d = int(self.head_dim * self.rope_fraction)
        return d - (d % 2)

    @property
    def has_ln2(self) -> bool:
        return not (self.parallel_block and self.shared_parallel_norm)

    def num_params(self) -> int:
        h, f, v, l = self.hidden_size, self.ffn_size, self.vocab_size, self.num_layers
        if self.mla:
            dn, dr, dv = (self.qk_nope_head_dim, self.qk_rope_head_dim,
                          self.v_head_dim)
            kvr, N = self.kv_lora_rank, self.num_heads
            qout = N * (dn + dr)
            if self.q_lora_rank:
                per_layer = (h * self.q_lora_rank + self.q_lora_rank
                             + self.q_lora_rank * qout)
            else:
                per_layer = h * qout
            per_layer += (h * (kvr + dr) + kvr + kvr * N * (dn + dv)
                          + N * dv * h)
        else:
            kv = self.kv_heads * self.head_dim
            qdim = self.num_heads * self.head_dim
            per_layer = h * qdim + 2 * h * kv + qdim * h  # q, k, v, o
        ffn_mats = 3 if self.activation == "swiglu" else 2
        if self.n_experts > 0:
            per_layer += self.n_experts * ffn_mats * h * self.moe_ffn + h * self.n_experts
            per_layer += ffn_mats * h * self.moe_shared_size  # shared expert
            if self.moe_shared_gate:
                per_layer += h
            if self.moe_gate_bias:
                per_layer += self.n_experts
        else:
            per_layer += ffn_mats * h * f
        per_layer += (2 * h if self.has_ln2 else h)  # norms
        if self.qk_norm:
            per_layer += 2 * self.head_dim
        total = l * per_layer + v * h + 2 * h
        if self.emb_norm:
            total += 2 * h
        if not self.tie_embeddings:
            total += v * h
        if self.pos_emb == "learned":
            total += self.max_seq_len * h
        return total


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #

def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: Optional[torch.device] = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Parameters with the JAX ``init_params`` scheme (std ``init_std``,
    output projections ``std / sqrt(2L)``, norms at scale 1 / bias 0,
    biases 0), drawn from ``generator`` (on ``device``, resolved as
    :func:`resolve_device` does: ``None`` is the first GPU and raises
    without one; tests pass ``"cpu"``).

    ``dtype`` is the storage type (default float32, the JAX master
    precision). Values are drawn in float32 one layer slice at a time and
    cast into a preallocated tensor of ``dtype``, so the peak stays near the
    size of the result (llama2_7b in bf16: 2 bytes a parameter, not the 6
    of an fp32 tensor beside its bf16 copy). The two
    frameworks' generators give different numbers from one seed: tests
    carry the JAX weights across with ``models/convert.py`` instead."""
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    h, f, L = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.kv_heads * cfg.head_dim
    std = cfg.init_std
    out_std = std / math.sqrt(2 * L)

    def dense(shape, s, stacked=True):
        out = torch.empty(shape, dtype=dtype, device=device)
        for sl in (out if stacked else [out]):
            sl.copy_(torch.randn(sl.shape, generator=generator,
                                 device=device, dtype=torch.float32) * s)
        return out

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def norm_init(shape):
        p = {"scale": const(shape, 1.0)}
        if cfg.norm == "layernorm":
            p["bias"] = const(shape, 0.0)
        return p

    block: Params = {"ln1": norm_init((L, h)),
                     "wq": dense((L, h, qdim), std),
                     "wk": dense((L, h, kvdim), std),
                     "wv": dense((L, h, kvdim), std),
                     "wo": dense((L, qdim, h), out_std)}
    if cfg.has_ln2:
        block["ln2"] = norm_init((L, h))
    E = cfg.n_experts
    if E > 0:
        # MoE FFN: per-expert weights (no biases), a router gate per layer
        fe = cfg.moe_ffn
        block["gate_w"] = dense((L, h, E), std)
        block["w_up"] = dense((L, E, h, fe), std)
        block["w_down"] = dense((L, E, fe, h), out_std)
        if cfg.activation == "swiglu":
            block["w_gate"] = dense((L, E, h, fe), std)
        fs = cfg.moe_shared_size
        if fs > 0:
            block["sw_up"] = dense((L, h, fs), std)
            block["sw_down"] = dense((L, fs, h), out_std)
            if cfg.activation == "swiglu":
                block["sw_gate"] = dense((L, h, fs), std)
            if cfg.moe_shared_gate:
                block["shared_gate_w"] = dense((L, h, 1), std)
        if cfg.moe_gate_bias:
            block["gate_bias"] = const((L, E), 0.0)
    else:
        block["w_up"] = dense((L, h, f), std)
        block["w_down"] = dense((L, f, h), out_std)
        if cfg.activation == "swiglu":
            block["w_gate"] = dense((L, h, f), std)
    if cfg.attn_bias_enabled:
        block["bq"] = const((L, qdim), 0.0)
        block["bk"] = const((L, kvdim), 0.0)
        block["bv"] = const((L, kvdim), 0.0)
    if cfg.use_bias:
        block["bo"] = const((L, h), 0.0)
        block["b_up"] = const((L, f), 0.0)
        block["b_down"] = const((L, h), 0.0)
    params: Params = {"tok_emb": dense((cfg.vocab_size, h), std, False),
                      "blocks": block,
                      "final_norm": norm_init((h,))}
    if cfg.pos_emb == "learned":
        params["pos_emb"] = dense((cfg.max_seq_len, h), std, False)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((h, cfg.vocab_size), std, False)
    return params


def param_logical_axes(cfg: TransformerConfig) -> Dict[str, Any]:
    """Logical axis names per parameter dim, the tree of
    :func:`init_params` (JAX ``param_logical_axes``, transformer.py:382,
    for the options this port runs): the ZeRO layout reads them."""
    _check_supported(cfg)

    def norm_axes(prefix):
        p = {"scale": prefix + ("embed",)}
        if cfg.norm == "layernorm":
            p["bias"] = prefix + ("embed",)
        return p

    lyr = ("layers",)
    block: Dict[str, Any] = {"ln1": norm_axes(lyr),
                             "wq": lyr + ("embed", "heads"),
                             "wk": lyr + ("embed", "kv_heads"),
                             "wv": lyr + ("embed", "kv_heads"),
                             "wo": lyr + ("heads", "embed")}
    if cfg.has_ln2:
        block["ln2"] = norm_axes(lyr)
    if cfg.n_experts > 0:
        block["gate_w"] = lyr + ("embed", None)
        block["w_up"] = lyr + ("expert", "embed", "mlp")
        block["w_down"] = lyr + ("expert", "mlp", "embed")
        if cfg.activation == "swiglu":
            block["w_gate"] = lyr + ("expert", "embed", "mlp")
        if cfg.moe_shared_size > 0:
            block["sw_up"] = lyr + ("embed", "mlp")
            block["sw_down"] = lyr + ("mlp", "embed")
            if cfg.activation == "swiglu":
                block["sw_gate"] = lyr + ("embed", "mlp")
            if cfg.moe_shared_gate:
                block["shared_gate_w"] = lyr + ("embed", None)
        if cfg.moe_gate_bias:
            block["gate_bias"] = lyr + (None,)
    else:
        block["w_up"] = lyr + ("embed", "mlp")
        block["w_down"] = lyr + ("mlp", "embed")
        if cfg.activation == "swiglu":
            block["w_gate"] = lyr + ("embed", "mlp")
    if cfg.attn_bias_enabled:
        block.update({"bq": lyr + ("heads",), "bk": lyr + ("kv_heads",),
                      "bv": lyr + ("kv_heads",)})
    if cfg.use_bias:
        block.update({"bo": lyr + ("embed",), "b_up": lyr + ("mlp",),
                      "b_down": lyr + ("embed",)})
    axes: Dict[str, Any] = {"tok_emb": ("vocab", "embed"), "blocks": block,
                            "final_norm": norm_axes(())}
    if cfg.pos_emb == "learned":
        axes["pos_emb"] = ("seq", "embed")
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def _check_supported(cfg: TransformerConfig) -> None:
    """Options of the JAX model that this slice of the port does not run."""
    unsupported = [name for name, on in (
        ("mla", cfg.mla), ("alibi", cfg.pos_emb == "alibi"),
        ("qk_norm", cfg.qk_norm), ("parallel_block", cfg.parallel_block),
        ("emb_norm", cfg.emb_norm), ("lm_head_bias", cfg.lm_head_bias))
        if on]
    if unsupported:
        raise NotImplementedError(
            f"{', '.join(unsupported)}: not supported by deepspeed_tpu_torch "
            "yet; it comes in a later slice of the port")


# --------------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------------- #

def _norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str, eps: float,
          use_kernel: bool = True) -> torch.Tensor:
    """``transformer._norm``: the Triton kernel for a CUDA tensor (the
    wrapper runs the plain version for a CPU tensor); ``use_kernel=False``
    takes the plain version everywhere."""
    if kind == "rmsnorm":
        fn = norms.rms_norm if use_kernel else norms.rms_norm_ref
        return fn(x, p["scale"], eps)
    fn = norms.layer_norm if use_kernel else norms.layer_norm_ref
    return fn(x, p["scale"], p["bias"], eps)


def _lm_head_of(params: Params, cfg: TransformerConfig) -> torch.Tensor:
    """LM head matrix [H, V]."""
    if cfg.tie_embeddings:
        return params["tok_emb"].t()
    return params["lm_head"]


def _scaled_inv_freq(head_dim: int, theta: float,
                     scaling: Optional[Dict[str, Any]]):
    """Inverse rope frequencies with HF-compatible scaling (numpy):
    'default', 'linear', 'llama3', 'yarn'. A copy of the JAX package's
    function (importing it would import jax).

    → (inv_freq [D/2] np.float32, attention_factor float — multiplies the
    cos/sin tables, HF convention)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                           / head_dim))
    if not scaling:
        return inv.astype(np.float32), 1.0
    sc = dict(scaling)
    rtype = sc.get("rope_type", sc.get("type", "default"))
    factor = float(sc.get("factor", 1.0))
    if rtype == "default":
        return inv.astype(np.float32), 1.0
    if rtype == "linear":
        return (inv / factor).astype(np.float32), 1.0
    if rtype == "llama3":
        low_f = float(sc["low_freq_factor"])
        high_f = float(sc["high_freq_factor"])
        old_ctx = float(sc["original_max_position_embeddings"])
        wavelen = 2 * math.pi / inv
        out = np.where(wavelen > old_ctx / low_f, inv / factor, inv)
        smooth = (old_ctx / wavelen - low_f) / (high_f - low_f)
        smoothed = (1 - smooth) * out / factor + smooth * out
        medium = (wavelen >= old_ctx / high_f) & (wavelen <= old_ctx / low_f)
        out = np.where(medium, smoothed, out)
        return out.astype(np.float32), 1.0
    if rtype == "yarn":
        d2 = head_dim // 2
        old_ctx = float(sc.get("original_max_position_embeddings") or 0) or None
        max_pos = old_ctx if old_ctx else float(sc.get("max_position_embeddings", 2048))
        mscale = sc.get("mscale")
        mscale_all = sc.get("mscale_all_dim")

        def get_mscale(scale, m=1.0):
            return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

        att = sc.get("attention_factor")
        if att is None:
            if mscale and mscale_all:
                att = get_mscale(factor, mscale) / get_mscale(factor, mscale_all)
            else:
                att = get_mscale(factor)
        beta_fast = float(sc.get("beta_fast") or 32)
        beta_slow = float(sc.get("beta_slow") or 1)

        def corr_dim(rot):
            return (head_dim * math.log(max_pos / (rot * 2 * math.pi))
                    ) / (2 * math.log(theta))

        low = max(math.floor(corr_dim(beta_fast)), 0)
        high = min(math.ceil(corr_dim(beta_slow)), head_dim - 1)
        if low == high:
            high += 0.001
        ramp = np.clip((np.arange(d2, dtype=np.float64) - low)
                       / (high - low), 0, 1)
        extrap_mask = 1 - ramp
        out = (inv / factor) * (1 - extrap_mask) + inv * extrap_mask
        return out.astype(np.float32), float(att)
    raise NotImplementedError(
        f"rope_scaling type {rtype!r} is not implemented "
        "(supported: default, linear, llama3, yarn)")


_ROPE_CACHE: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def rope_table(seq_len: int, head_dim: int, theta: float,
               scaling: Optional[Dict[str, Any]] = None,
               device: Optional[torch.device] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [seq_len, head_dim/2] fp32 on ``device`` (resolved as
    :func:`resolve_device` does: ``None`` is the first GPU). Cached per
    arguments and device: the JAX program folded it into a constant; eager
    PyTorch would otherwise rebuild it every tick."""
    device = resolve_device(device)
    key = (seq_len, head_dim, theta,
           tuple(sorted(scaling.items())) if scaling else None, str(device))
    hit = _ROPE_CACHE.get(key)
    if hit is None:
        inv_freq, att = _scaled_inv_freq(head_dim, theta, scaling)
        t = torch.arange(seq_len, dtype=torch.float32)
        freqs = torch.outer(t, torch.from_numpy(inv_freq))   # [S, D/2]
        hit = ((torch.cos(freqs) * att).to(device),
               (torch.sin(freqs) * att).to(device))
        _ROPE_CACHE[key] = hit
    return hit


def apply_rope_at(x: torch.Tensor, cos_table: torch.Tensor,
                  sin_table: torch.Tensor, positions: torch.Tensor
                  ) -> torch.Tensor:
    """Rotate x [B, T, N, D] at absolute ``positions`` [B, T] (halves
    convention); partial rotary (tables narrower than D/2) passes trailing
    dims through."""
    rot = 2 * cos_table.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    d2 = rot // 2
    cos = cos_table[positions][:, :, None, :].to(x.dtype)    # [B,T,1,rot/2]
    sin = sin_table[positions][:, :, None, :].to(x.dtype)
    x1, x2 = x_rot[..., :d2], x_rot[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


def _ffn(h: torch.Tensor, lp: Dict[str, torch.Tensor],
         cfg: TransformerConfig, use_kernels: bool = True
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense or MoE FFN on normed input → (output, aux loss: fp32 0 for a
    dense block). ``use_kernels=False`` runs the grouped GEMMs' plain
    versions."""
    if cfg.n_experts > 0:
        from deepspeed_tpu_torch.moe.layer import moe_ffn

        if h.dim() == 2:
            # a serving tick's flat token rows [T, H]: one row batch of T
            # (JAX's paged forward hands moe_ffn the [T, H] rows, which its
            # [B, S, H] unpacking refuses)
            y, aux = _ffn(h[None], lp, cfg, use_kernels)
            return y[0], aux

        experts = {k_: lp[k_] for k_ in ("w_up", "w_down", "w_gate")
                   if k_ in lp}
        shared = {k_: lp[k_] for k_ in ("sw_up", "sw_down", "sw_gate",
                                        "shared_gate_w") if k_ in lp}
        return moe_ffn(
            h, lp["gate_w"], experts, activation=cfg.activation,
            k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
            min_capacity=cfg.moe_min_capacity, score_func=cfg.moe_score_func,
            route_norm=cfg.moe_route_norm,
            route_scale=cfg.moe_route_scale, shared=shared or None,
            gate_bias=lp.get("gate_bias"), n_group=cfg.moe_n_group,
            topk_group=cfg.moe_topk_group, dispatch=cfg.moe_dispatch,
            use_kernels=use_kernels)
    up = h @ lp["w_up"]
    if cfg.use_bias:
        up = up + lp["b_up"]
    if cfg.activation == "swiglu":
        act = F.silu(h @ lp["w_gate"]) * up
    elif cfg.activation == "relu":
        act = F.relu(up)
    else:
        act = F.gelu(up, approximate="tanh")
    down = act @ lp["w_down"]
    if cfg.use_bias:
        down = down + lp["b_down"]
    return down, torch.zeros((), dtype=torch.float32, device=h.device)


def _head_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda" and x.dtype != torch.float32:
        return torch.mm(x, w, out_dtype=torch.float32)
    return torch.mm(x.float(), w.float())


class _HeadMatmul(torch.autograd.Function):
    """The JAX ``head_matmul`` custom VJP: the fp32 cotangent is cast to the
    compute dtype, so both backward products run in it (tensor cores for
    bf16), each summed in fp32 and rounded once to its input's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _head_product(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gl = g.to(x.dtype)
        dx = torch.matmul(gl, w.t().to(x.dtype))
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                          gl.reshape(-1, gl.shape[-1]))
        return dx.to(x.dtype), dw.to(w.dtype)


def head_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """LM-head projection ``x [..., H] @ w [H, V]`` with fp32 logits (the
    JAX ``head_matmul``).

    The JAX product takes bf16 inputs and returns fp32
    (``preferred_element_type=jnp.float32``); ``torch.matmul`` of bf16
    returns bf16, rounding every logit to 8 mantissa bits. Greedy decoding
    takes the argmax, and at bf16 resolution distinct logits tie (argmax then
    picks the lowest index) — tokens would diverge from the reference. So
    the products are summed and written in fp32: on a GPU by one cuBLAS
    tensor-core product with an fp32 output (``out_dtype``), on the CPU,
    which has no such product, by upcasting both operands first (a bf16
    value is exact in fp32, so the products are the same). Differentiable
    through :class:`_HeadMatmul` when autograd needs it."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _HeadMatmul.apply(x, w)
    if x.dim() == 2:
        return _head_product(x, w)
    return _head_product(x.reshape(-1, x.shape[-1]), w).reshape(
        *x.shape[:-1], w.shape[-1])


# --------------------------------------------------------------------------- #
# training forward (the JAX forward_hidden / forward / losses)
# --------------------------------------------------------------------------- #

REMAT_POLICIES = ("none", "full", "save_nothing")


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, N, D]; rotates the halves (tables [S, rot/2]); trailing dims
    past the tables pass through (partial rotary)."""
    rot = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    d2 = rot // 2
    x1, x2 = x_rot[..., :d2], x_rot[..., d2:]
    cos = cos[None, :, None, :].to(x.dtype)
    sin = sin[None, :, None, :].to(x.dtype)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          segment_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The plain ("xla") attention with the JAX numerics: scores in the
    input dtype, then fp32 and scaled; fp32 softmax; probabilities cast to
    q's dtype before P·V. q [B,S,N,D], k/v [B,S,K,D]; ``segment_mask``
    [B, S, S] bool (True = attend)."""
    B, S, N, D = q.shape
    K = k.shape[2]
    if K != N:
        k = k.repeat_interleave(N // K, dim=2)
        v = v.repeat_interleave(N // K, dim=2)
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bsnd,btnd->bnst", q, k).float() * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -1e30)
    if segment_mask is not None:
        scores = scores.masked_fill(~segment_mask[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)


def _block_forward(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                   cfg: TransformerConfig, cos: Optional[torch.Tensor],
                   sin: Optional[torch.Tensor], attention_fn,
                   use_kernels: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sequential (GPT/Llama) block on x [B, S, H], dense or MoE FFN;
    ``lp`` holds this layer's parameters. Returns (x, MoE aux loss). The
    parallel and MLA blocks come in a later slice (``_check_supported``).
    ``use_kernels=False`` takes the norms' and grouped GEMMs' plain
    versions."""
    B, S, _ = x.shape
    dt = cfg.compute_dtype
    lp = _cast_tree(lp, dt)      # a no-op for the engine's compute params

    def proj(name, inp, heads):
        out = inp @ lp[f"w{name}"].to(dt)
        if cfg.attn_bias_enabled if name in ("q", "k", "v") else cfg.use_bias:
            out = out + lp[f"b{name}"].to(dt)
        return out if heads is None else out.reshape(B, S, heads,
                                                     cfg.head_dim)

    h = _norm(x, lp["ln1"], cfg.norm, cfg.norm_eps, use_kernels)
    q = proj("q", h, cfg.num_heads)
    k = proj("k", h, cfg.kv_heads)
    v = proj("v", h, cfg.kv_heads)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    attn = attention_fn(q, k, v, causal=cfg.causal)
    x = x + proj("o", attn.reshape(B, S, cfg.num_heads * cfg.head_dim), None)
    h2 = _norm(x, lp["ln2"], cfg.norm, cfg.norm_eps, use_kernels)
    down, aux = _ffn(h2, lp, cfg, use_kernels)
    return x + down, aux


def _cast_tree(tree, dtype):
    """Floating leaves cast to ``dtype`` (``.to`` returns the tensor itself
    when it already has that dtype)."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _remat_wrap(body, remat: Optional[str]):
    """The layer remat policy: ``none`` runs the body as is; ``full`` (=
    ``save_nothing``) saves only the layer's input and recomputes the rest
    in backward (``jax.checkpoint``), here
    ``torch.utils.checkpoint(use_reentrant=False)``. Other JAX policies
    come in a later slice; unknown names raise, as in JAX."""
    if remat in ("none", None):
        return body
    if remat in ("full", "save_nothing"):
        from torch.utils.checkpoint import checkpoint

        def wrapped(x):
            return checkpoint(body, x, use_reentrant=False,
                              preserve_rng_state=False)

        return wrapped
    raise NotImplementedError(
        f"remat policy {remat!r} is not supported by deepspeed_tpu_torch "
        "yet (none|full); it comes in a later slice of the port")


class ParamHook:
    """Parameters handed out per use: the counterpart of the JAX engine's
    ``scan_chunks`` / ``param_sync_fn`` injection (``models/api.py``
    :131-150, ``models/transformer.py:962-1016``), through which a ZeRO-3
    engine gathers each layer chunk where it is used
    (``parallel/stage3.Stage3Params``). :func:`forward_hidden` takes one in
    place of the parameter tree: :meth:`head` at the start (every leaf
    outside ``blocks``), :meth:`layer` for layer l INSIDE the layer's remat
    body, so the backward's recompute asks for it again."""

    def head(self) -> Dict[str, Any]:
        raise NotImplementedError

    def layer(self, layer: int) -> Dict[str, Any]:
        raise NotImplementedError


def layer_params(blocks, layer: int) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s parameters from ``params["blocks"]``: a dict of
    stacked [L, ...] tensors (the JAX layout) or a list of per-layer dicts
    (the engine's leaves, each a view into its flat buffers)."""
    if isinstance(blocks, (list, tuple)):
        return blocks[layer]
    return {k: layer_params(v, layer) if isinstance(v, dict) else v[layer]
            for k, v in blocks.items()}


def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: TransformerConfig, attention_fn=None,
                   use_kernels: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens [B, S] → (final hidden [B, S, H], LM head [H, V], MoE aux
    loss summed over layers, fp32 — 0 for dense models). The JAX
    ``forward_hidden`` without PLD, random-LTD or chunked scans (a later
    slice); the layer scan is a Python loop, each layer wrapped by the
    config's remat policy. ``use_kernels=False`` takes the norms' and
    grouped GEMMs' plain versions (the card's kernel-vs-plain checks).
    ``params`` may be a :class:`ParamHook`; without one the layers take
    :func:`layer_params`."""
    _check_supported(cfg)
    attention_fn = attention_fn or dot_product_attention
    dt = cfg.compute_dtype
    B, S = tokens.shape
    hook = params if isinstance(params, ParamHook) else None
    if hook is not None:
        params = hook.head()
    x = F.embedding(tokens.long(), params["tok_emb"].to(dt))
    if cfg.pos_emb == "learned":
        x = x + params["pos_emb"].to(dt)[:S][None]
    cos = sin = None
    if cfg.pos_emb == "rope":
        cos, sin = rope_table(S, cfg.rope_dim, cfg.rope_theta,
                              cfg.rope_scaling_dict, device=x.device)
    auxes = []
    for layer in range(cfg.num_layers):
        if hook is None:
            lp = layer_params(params["blocks"], layer)

            def body(h, lp=lp):
                return _block_forward(h, lp, cfg, cos, sin, attention_fn,
                                      use_kernels)
        else:
            def body(h, layer=layer):
                return _block_forward(h, hook.layer(layer), cfg, cos, sin,
                                      attention_fn, use_kernels)

        x, aux = _remat_wrap(body, cfg.remat)(x)
        auxes.append(aux)
    x = _norm(x, params["final_norm"], cfg.norm, cfg.norm_eps, use_kernels)
    return x, _lm_head_of(params, cfg), torch.stack(auxes).sum()


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            attention_fn=None, use_kernels: bool = True) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] in fp32."""
    x, head, _ = forward_hidden(params, tokens, cfg, attention_fn,
                                use_kernels)
    return head_matmul(x, head.to(x.dtype))


def _loss_rows(n_rows: int, vocab: int) -> int:
    """Rows of [rows, V] fp32 temporaries taken at once by the fused loss
    (~1 GiB each): the whole [B·S, V] fp32 would be 6.6 GB at GPT-2's
    headline shape. Chunking changes no arithmetic."""
    return max(1, min(n_rows, (1 << 28) // max(vocab, 1)))


class _FusedLMLoss(torch.autograd.Function):
    """The JAX ``fused_lm_loss`` custom VJP: logits in the compute dtype
    (fp32 sums, one rounding), fp32 softmax statistics; the backward writes
    ONE compute-dtype grad-logits array — into the saved logits' own
    storage — that feeds both backward products. Single use: the saved
    logits are overwritten by the backward."""

    @staticmethod
    def forward(ctx, x, w, tokens, mask):
        with record_function("fused_lm_loss"):
            return _FusedLMLoss._forward(ctx, x, w, tokens, mask)

    @staticmethod
    def _forward(ctx, x, w, tokens, mask):
        dt = x.dtype
        B, S, H = x.shape
        wc = w.to(dt)
        xs = x[:, :-1]
        tgt = tokens[:, 1:].long().reshape(-1)
        logits = torch.matmul(xs, wc)                       # [B, S-1, V] dt
        lg = logits.reshape(-1, logits.shape[-1])
        R = lg.shape[0]
        logz = torch.empty(R, dtype=torch.float32, device=x.device)
        picked = torch.empty(R, dtype=torch.float32, device=x.device)
        step = _loss_rows(R, lg.shape[1])
        for a in range(0, R, step):
            lf = lg[a:a + step].float()
            logz[a:a + step] = torch.logsumexp(lf, dim=-1)
            picked[a:a + step] = lf.gather(1, tgt[a:a + step, None])[:, 0]
        m = (torch.ones(B, S - 1, device=x.device) if mask is None
             else mask[:, 1:].float()).reshape(-1)
        cnt = torch.clamp(m.sum(), min=1.0)
        loss = ((logz - picked) * m).sum() / cnt
        ctx.save_for_backward(logits, logz, xs, wc, tgt, m, cnt)
        ctx.w_dtype = w.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        with record_function("fused_lm_loss_backward"):
            return _FusedLMLoss._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        logits, logz, xs, wc, tgt, m, cnt = ctx.saved_tensors
        dt = xs.dtype
        lg = logits.reshape(-1, logits.shape[-1])
        coef = m * (g / cnt)
        R = lg.shape[0]
        step = _loss_rows(R, lg.shape[1])
        for a in range(0, R, step):
            rows = torch.arange(lg[a:a + step].shape[0], device=lg.device)
            p = torch.exp(lg[a:a + step].float() - logz[a:a + step, None])
            p[rows, tgt[a:a + step]] -= 1.0
            lg[a:a + step] = (p * coef[a:a + step, None]).to(dt)
        dx = torch.matmul(logits, wc.t())                   # [B, S-1, H]
        dw = torch.matmul(xs.reshape(-1, xs.shape[-1]).t(), lg)
        B, S1, H = dx.shape
        dx_full = torch.zeros(B, S1 + 1, H, dtype=dt, device=dx.device)
        dx_full[:, :-1] = dx
        return dx_full, dw.to(ctx.w_dtype), None, None


def fused_lm_loss(hidden: torch.Tensor, head: torch.Tensor,
                  tokens: torch.Tensor,
                  loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Head projection + next-token cross entropy with the compute-dtype
    logits of the JAX ``fused_lm_loss`` (torch-autocast semantics)."""
    return _FusedLMLoss.apply(hidden, head, tokens, loss_mask)


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy on fp32 logits (logsumexp − picked)."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets[..., None])[..., 0]
    nll = logz - picked
    if loss_mask is not None:
        mask = loss_mask[:, 1:].float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# --------------------------------------------------------------------------- #
# presets (the JAX package's, value for value)
# --------------------------------------------------------------------------- #

PRESETS: Dict[str, TransformerConfig] = {
    "tiny": TransformerConfig(vocab_size=512, hidden_size=64, num_layers=2,
                              num_heads=4, max_seq_len=128),
    "tiny_llama": TransformerConfig(vocab_size=512, hidden_size=64, num_layers=2,
                                    num_heads=4, num_kv_heads=2, max_seq_len=128,
                                    pos_emb="rope", norm="rmsnorm",
                                    activation="swiglu", use_bias=False,
                                    tie_embeddings=False),
    "gpt2_125m": TransformerConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                                   num_heads=12, max_seq_len=1024),
    "gpt2_350m": TransformerConfig(vocab_size=50304, hidden_size=1024, num_layers=24,
                                   num_heads=16, max_seq_len=1024),
    "gpt2_1p5b": TransformerConfig(vocab_size=50304, hidden_size=1600, num_layers=48,
                                   num_heads=25, max_seq_len=1024),
    "bert_large": TransformerConfig(vocab_size=30528, hidden_size=1024, num_layers=24,
                                    num_heads=16, max_seq_len=512, causal=False),
    # llama-style model sized so fp32 master + Adam moments + fp32 grads fit a
    # single 16G-HBM chip (ZeRO-3 single-host bench; ~665M params ≈ 12G state)
    "llama_750m": TransformerConfig(vocab_size=32000, hidden_size=1536,
                                    num_layers=20, num_heads=12,
                                    ffn_hidden_size=4096, max_seq_len=2048,
                                    pos_emb="rope", norm="rmsnorm",
                                    activation="swiglu", use_bias=False,
                                    tie_embeddings=False),
    # mixtral-style MoE sized for one chip (4 experts, top-2)
    "moe_350m": TransformerConfig(vocab_size=32000, hidden_size=768,
                                  num_layers=12, num_heads=12, max_seq_len=1024,
                                  use_bias=False, n_experts=4, moe_top_k=2),
    # larger-expert MoE (~2B total / ~0.7B active): hidden 1536 (head_dim
    # 128) and expert-ffn 6144 put the grouped GEMM at shapes where it
    # matches dense matmul throughput (46-55 TF/s grouped vs 52 dense at
    # [32k,1536]x[8,1536,6144], same-harness A/B) — at moe_350m's K=768
    # shapes grouped and dense measure in the SAME low band, i.e. the
    # contraction itself is the ceiling; full rung table in PROFILE.md r5
    "moe_1b": TransformerConfig(vocab_size=32000, hidden_size=1536,
                                num_layers=12, num_heads=12, max_seq_len=1024,
                                ffn_hidden_size=6144, use_bias=False,
                                n_experts=8, moe_top_k=2),
    # north-star-scale single-chip model (BASELINE.md): ~3.1B params with
    # MXU-aligned shapes — head_dim 128, ffn 8192 (the open-llama-3B layout's
    # head_dim 100 wastes MXU lanes; this keeps every contraction 128-tiled)
    "llama_3b": TransformerConfig(vocab_size=32000, hidden_size=3072,
                                  num_layers=26, num_heads=24,
                                  ffn_hidden_size=8192, max_seq_len=2048,
                                  pos_emb="rope", norm="rmsnorm",
                                  activation="swiglu", use_bias=False,
                                  tie_embeddings=False),
    "llama2_7b": TransformerConfig(vocab_size=32000, hidden_size=4096, num_layers=32,
                                   num_heads=32, ffn_hidden_size=11008,
                                   max_seq_len=4096, pos_emb="rope", norm="rmsnorm",
                                   activation="swiglu", use_bias=False,
                                   tie_embeddings=False),
    "llama2_13b": TransformerConfig(vocab_size=32000, hidden_size=5120, num_layers=40,
                                    num_heads=40, ffn_hidden_size=13824,
                                    max_seq_len=4096, pos_emb="rope", norm="rmsnorm",
                                    activation="swiglu", use_bias=False,
                                    tie_embeddings=False),
    "tiny_moe": TransformerConfig(vocab_size=512, hidden_size=64, num_layers=2,
                                  num_heads=4, max_seq_len=128, use_bias=False,
                                  n_experts=4, moe_top_k=2),
    "mixtral_8x7b": TransformerConfig(vocab_size=32000, hidden_size=4096,
                                      num_layers=32, num_heads=32, num_kv_heads=8,
                                      ffn_hidden_size=14336, max_seq_len=4096,
                                      pos_emb="rope", norm="rmsnorm",
                                      activation="swiglu", use_bias=False,
                                      tie_embeddings=False,
                                      n_experts=8, moe_top_k=2),
}


def get_model_config(name: str, **overrides) -> TransformerConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown model preset {name!r}; available: {sorted(PRESETS)}")
    return dataclasses.replace(PRESETS[name], **overrides)
