"""AutoSP: automatic sequence-parallel detection, planning and spec
rewriting.

Ports ``deepspeed_tpu/sequence/auto_sp.py`` value for value: the
architecture registry and ``detect_sp_info`` (:89), the analytic
comm-volume model ``_comm_cost`` (:132), ``plan_sp`` (:151),
``apply_sp_plan`` (:197) and ``auto_sp`` (:215), which the engine runs at
initialize under ``{"sequence_parallel": {"auto": true}}``. The model is
declarative (a ``TransformerConfig`` and a named attention), so AutoSP is
a planning pass: detect the attention site's shape (a zoo config, a
``ModelSpec``, or an HF-style config object — read by attribute, nothing
downloaded; a multimodal config planned over its ``text_config``), choose
Ulysses or the K/V ring by feasibility and then by per-layer comm volume
(Ulysses moves q, k, v and o through all-to-alls, the ring rotates k and v
through sp − 1 hops), tile the loss of long sequences, and rebuild the
spec through its own ``builder``. The sp size is the installed mesh's
``seq`` axis (1 without a mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from deepspeed_tpu_torch.comm.mesh import (
    SEQ_AXIS,
    get_mesh_manager,
    mesh_is_initialized,
)
from deepspeed_tpu_torch.runtime.config_utils import logger

# sequences at or beyond this many tokens get tiled loss by default
TILED_LOSS_SEQ_THRESHOLD = 16_384

# HF model_types whose text trunk follows the Llama attribute schema
# (reference _LLM_ATTN_CLASSNAMES, autosp_detector.py:45 — class-name
# detection becomes model_type detection in a functional world)
_LLM_SCHEMA_TYPES = {
    "llama", "mistral", "mixtral", "qwen2", "qwen2_moe", "qwen3", "qwen3_moe",
    "gemma", "phi", "phi3", "falcon", "gpt_neox", "internlm2", "mpt",
}

# multimodal wrappers: plan over .text_config, flag the vision tower
# (reference _VIT_ATTN_CLASSNAMES + fusion adapters, autosp_fusion.py)
_MULTIMODAL_TYPES = {
    "llava", "llava_next", "qwen2_vl", "internvl_chat", "idefics2",
    "paligemma",
}


@dataclasses.dataclass(frozen=True)
class SPSiteInfo:
    """Detected attention-site shape (reference ``SPModelInfo``,
    ``autosp_detector.py:73``)."""
    num_heads: int
    kv_heads: int
    head_dim: int
    seq_len: Optional[int] = None
    causal: bool = True
    arch: str = "unknown"
    vision_tower: bool = False   # multimodal: vision encoder present,
    #                              planned over the LLM trunk only


@dataclasses.dataclass(frozen=True)
class SPPlan:
    enabled: bool
    sp_size: int = 1
    mechanism: str = "none"     # none | ulysses | ring
    loss_tiles: int = 0
    reason: str = ""

    def describe(self) -> str:
        if not self.enabled:
            return f"AutoSP: disabled ({self.reason})"
        return (f"AutoSP: {self.mechanism} over seq={self.sp_size}"
                + (f", loss tiled x{self.loss_tiles}" if self.loss_tiles > 1
                   else "") + f" ({self.reason})")


def detect_sp_info(model_or_config: Any) -> SPSiteInfo:
    """Zoo TransformerConfig / ModelSpec / HF config → :class:`SPSiteInfo`.

    Raises ValueError for shapes it cannot read (the reference detector
    returns an empty SPModelInfo; an explicit error is more useful here).
    """
    cfg = getattr(model_or_config, "config", model_or_config)
    vision = False
    # multimodal: descend into the text trunk
    mt = getattr(cfg, "model_type", None)
    if mt in _MULTIMODAL_TYPES:
        text = getattr(cfg, "text_config", None)
        if text is None:
            raise ValueError(
                f"multimodal config {mt!r} has no text_config to plan over")
        cfg, vision = text, True
        mt = getattr(cfg, "model_type", mt)

    # zoo TransformerConfig
    if hasattr(cfg, "num_heads") and hasattr(cfg, "kv_heads"):
        return SPSiteInfo(
            num_heads=cfg.num_heads, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, seq_len=cfg.max_seq_len,
            causal=getattr(cfg, "causal", True), arch="zoo",
            vision_tower=vision)

    # HF llama-schema config
    heads = getattr(cfg, "num_attention_heads", None)
    if heads:
        hidden = getattr(cfg, "hidden_size", 0)
        kv = getattr(cfg, "num_key_value_heads", None) or heads
        head_dim = getattr(cfg, "head_dim", None) or (
            hidden // heads if hidden else 0)
        arch = mt if mt in _LLM_SCHEMA_TYPES else (mt or "hf")
        return SPSiteInfo(
            num_heads=int(heads), kv_heads=int(kv), head_dim=int(head_dim),
            seq_len=getattr(cfg, "max_position_embeddings", None),
            causal=not getattr(cfg, "is_encoder", False), arch=arch,
            vision_tower=vision)
    raise ValueError(
        f"cannot detect attention shape from {type(cfg).__name__}")


def _comm_cost(mechanism: str, info: SPSiteInfo, sp: int) -> float:
    """Per-device, per-layer attention comm volume (elements) under SP=sp.

    Ulysses (``sequence/ulysses.py``): 2 all-to-alls in (q,k,v) + 1 out —
    each moves that tensor's local shard once: (2·H_q + 2·H_kv)·(S/sp)·D
    scaled by the (sp-1)/sp non-local fraction. KV ring
    (``sequence/ring.py``): sp-1 ppermute hops each carrying the local
    K and V blocks: 2·H_kv·(S/sp)·D·(sp-1).
    """
    S = info.seq_len or 1
    seq_shard = S / sp
    D = info.head_dim
    if mechanism == "ulysses":
        # kv replicated up to sp when kv_heads < sp (ulysses.py:116)
        kv = max(info.kv_heads, sp)
        return (2 * info.num_heads + 2 * kv) * seq_shard * D * (sp - 1) / sp
    return 2 * info.kv_heads * seq_shard * D * (sp - 1)


def plan_sp(num_heads: Optional[int] = None, seq_len: Optional[int] = None,
            sp_size: Optional[int] = None,
            info: Optional[SPSiteInfo] = None) -> SPPlan:
    """Decide mechanism by feasibility then analytic comm cost.

    Callable either with a detected ``info`` or bare ``num_heads``/``seq_len``
    (back-compat; kv_heads then assumed == num_heads)."""
    if info is None:
        info = SPSiteInfo(num_heads=num_heads or 0, kv_heads=num_heads or 0,
                          head_dim=64, seq_len=seq_len)
    if sp_size is None:
        sp_size = (get_mesh_manager().axis_size(SEQ_AXIS)
                   if mesh_is_initialized() else 1)
    if sp_size <= 1:
        return SPPlan(False, 1, "none", 0, "mesh has no 'seq' axis > 1")
    if info.num_heads <= 0:
        return SPPlan(False, sp_size, "none", 0, "no attention sites detected")

    seq_len = seq_len or info.seq_len
    tiles = 0
    if seq_len and seq_len >= TILED_LOSS_SEQ_THRESHOLD:
        tiles = max(2, seq_len // (TILED_LOSS_SEQ_THRESHOLD // 2))

    # both mechanisms shard the sequence dim (ulysses re-shards it around the
    # all-to-all), so seq divisibility gates everything when seq is known
    seq_ok = seq_len is None or seq_len % sp_size == 0
    feasible = []
    if seq_ok and info.num_heads % sp_size == 0:
        feasible.append("ulysses")
    if seq_ok:
        feasible.append("ring")
    if not feasible:
        return SPPlan(False, sp_size, "none", 0,
                      f"neither heads {info.num_heads} nor seq {seq_len} "
                      f"divisible by sp {sp_size}")

    costs = {m: _comm_cost(m, info, sp_size) for m in feasible}
    best = min(feasible, key=lambda m: costs[m])  # ties → ulysses (listed first)
    why = (f"heads {info.num_heads}/kv {info.kv_heads} over sp {sp_size}; "
           + ", ".join(f"{m} comm {costs[m]:.3g}" for m in feasible))
    if info.vision_tower:
        why += ("; multimodal: LLM trunk sharded, vision tower replicated "
                "(fusion adapters not implemented)")
    return SPPlan(True, sp_size, best, tiles, why)


def apply_sp_plan(spec, plan: SPPlan):
    """Rewrite a ModelSpec according to the plan (the fusion-pass analog:
    swaps the attention callable, retiles the loss) through the spec's own
    ``builder`` — customizations (LoRA adapters, imported weights, trainable
    masks, pipeline schedule) survive the rewrite."""
    if not plan.enabled:
        return spec
    builder = getattr(spec, "builder", None)
    if builder is None:
        raise ValueError(
            "apply_sp_plan needs a rebuildable spec (ModelSpec.builder); "
            "specs from causal_lm_spec/spec_from_hf/lora_causal_lm_spec "
            "carry one")
    attention = "ulysses" if plan.mechanism == "ulysses" else "ring"
    if attention == "ulysses" and getattr(spec, "attention", None) in (
            "flash", "ulysses_flash"):
        # the flash kernels stay, inside Ulysses (JAX rebuilds with
        # 'ulysses', whose inner attention is its plain one)
        attention = "ulysses_flash"
    new = builder(attention=attention, loss_tiles=plan.loss_tiles)
    return dataclasses.replace(new, name=spec.name + f"+autosp:{plan.mechanism}")


def auto_sp(spec, seq_len: Optional[int] = None, sp_size: Optional[int] = None):
    """One-call AutoSP: detect + plan from the live mesh + rewrite. Returns
    (new_spec, plan). Specs whose shape can't be read or that can't rebuild
    themselves get a DISABLED plan (and the spec back unchanged) rather than
    a crash — the engine hook must be safe on any spec."""
    try:
        info = detect_sp_info(spec)
    except ValueError as e:
        plan = SPPlan(False, 1, "none", 0, f"detection failed: {e}")
        logger.info(plan.describe())
        return spec, plan
    plan = plan_sp(info.num_heads, seq_len or info.seq_len, sp_size, info=info)
    if plan.enabled and getattr(spec, "builder", None) is None:
        plan = SPPlan(False, plan.sp_size, "none", 0,
                      "spec has no builder (cannot be rewritten); construct "
                      "it with causal_lm_spec or set ModelSpec.builder")
    logger.info(plan.describe())
    if not plan.enabled:
        return spec, plan
    return apply_sp_plan(spec, plan), plan
