"""AutoEP model-family presets and expert-parallel topology math.

The port's own copy of ``deepspeed_tpu/moe/presets.py`` (:28-190; pure
Python and numpy, so it is copied rather than imported): ``MoEPreset`` and
the ``PRESETS`` registry (per-family routing knobs read from an HF config),
``preset_for_model_type`` / ``resolve_preset``, and ``EPTopology`` /
``ep_topology`` / ``fold_group_tables`` (the rank groups of each parallel
dimension over the mesh's axes, axis order data, expert, tensor). As in
JAX, the experts are "folded" by stacking them into [L, E, in, out] leaves
whose ``expert`` logical axis the engine shards over the ``expert`` mesh
axis; the group tables are pure math for tooling and tests.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MoEPreset:
    """Routing + schema description for one MoE model family.

    Reference ``MoEModelPreset`` (``auto_ep_presets/base.py:27``); fields the
    CUDA version needs for module surgery (regex patterns, storage flags)
    collapse into ``importable`` + the importer's schema knowledge.
    """
    name: str
    hf_model_types: Tuple[str, ...]
    num_experts_attr: str
    top_k_attr: str
    score_func: str = "softmax"           # softmax | sigmoid
    route_norm_attr: Optional[str] = "norm_topk_prob"
    route_norm_default: bool = True
    route_scale_attr: Optional[str] = None  # e.g. routed_scaling_factor
    moe_ffn_attr: Optional[str] = "moe_intermediate_size"
    shared_size_attr: Optional[str] = None
    shared_gate: bool = False
    first_dense_attr: Optional[str] = None  # first_k_dense_replace (DeepSeek)
    importable: bool = True
    unsupported_note: str = ""

    def describe_config(self, hf_config) -> Dict[str, object]:
        """Extract this family's MoE knobs from an HF config object."""
        def attr(name, default=None):
            return getattr(hf_config, name, default) if name else default

        return {
            "n_experts": int(attr(self.num_experts_attr, 0) or 0),
            "top_k": int(attr(self.top_k_attr, 2) or 2),
            "score_func": self.score_func,
            "route_norm": bool(attr(self.route_norm_attr,
                                    self.route_norm_default)),
            "route_scale": float(attr(self.route_scale_attr, 1.0) or 1.0),
            "moe_ffn_size": attr(self.moe_ffn_attr),
            "shared_size": int(attr(self.shared_size_attr, 0) or 0),
            "shared_gate": self.shared_gate,
            "first_dense": int(attr(self.first_dense_attr, 0) or 0),
        }


# Registry (reference ``auto_ep_presets/{mixtral,qwen3_moe,...}.py``).
PRESETS: Dict[str, MoEPreset] = {
    "mixtral": MoEPreset(
        name="mixtral", hf_model_types=("mixtral",),
        num_experts_attr="num_local_experts",
        top_k_attr="num_experts_per_tok",
        route_norm_attr=None, route_norm_default=True,
        moe_ffn_attr="intermediate_size"),
    "qwen2_moe": MoEPreset(
        name="qwen2_moe", hf_model_types=("qwen2_moe",),
        num_experts_attr="num_experts", top_k_attr="num_experts_per_tok",
        route_norm_default=False,
        shared_size_attr="shared_expert_intermediate_size", shared_gate=True),
    "qwen3_moe": MoEPreset(
        name="qwen3_moe", hf_model_types=("qwen3_moe", "qwen3_5_moe"),
        num_experts_attr="num_experts", top_k_attr="num_experts_per_tok"),
    "deepseek_v2": MoEPreset(
        name="deepseek_v2", hf_model_types=("deepseek_v2",),
        num_experts_attr="n_routed_experts", top_k_attr="num_experts_per_tok",
        score_func="softmax", route_scale_attr="routed_scaling_factor",
        shared_size_attr="n_shared_experts",  # count ×moe_intermediate_size
        first_dense_attr="first_k_dense_replace",
        importable=True,
        unsupported_note=(
            "importable with MLA attention (models/transformer.py _mla_qkv); "
            "constraints: first_k_dense_replace=0 and topk_method='greedy' "
            "(the importer raises otherwise)")),
    "deepseek_v3": MoEPreset(
        name="deepseek_v3", hf_model_types=("deepseek_v3",),
        num_experts_attr="n_routed_experts", top_k_attr="num_experts_per_tok",
        score_func="sigmoid", route_scale_attr="routed_scaling_factor",
        shared_size_attr="n_shared_experts",
        first_dense_attr="first_k_dense_replace",
        importable=True,
        unsupported_note=(
            "importable with MLA attention + sigmoid grouped routing with "
            "e_score_correction_bias; constraint: first_k_dense_replace=0 "
            "(the importer raises otherwise)")),
}


def preset_for_model_type(model_type: Optional[str]) -> Optional[MoEPreset]:
    """model_type → preset (reference ``preset_name_for_hf_model_type``)."""
    if not model_type:
        return None
    for preset in PRESETS.values():
        if model_type in preset.hf_model_types:
            return preset
    return None


def resolve_preset(hf_config) -> Optional[Tuple[MoEPreset, Dict[str, object]]]:
    """HF config → (preset, extracted knobs) when the family is known and the
    config actually carries experts; None for dense models."""
    preset = preset_for_model_type(getattr(hf_config, "model_type", None))
    if preset is None:
        return None
    knobs = preset.describe_config(hf_config)
    if knobs["n_experts"] <= 0:
        return None
    return preset, knobs


# --------------------------------------------------------------------------- #
# EP topology math (reference auto_ep_folding.py ParallelFoldingSpec /
# FoldingGroupTables — pure math, no runtime handles)
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class EPTopology:
    """Resolved expert-parallel topology over a named mesh.

    world = data × expert × tensor (the MoE-relevant axes); edp (expert-data
    parallel — replicas of each expert shard) = data; etp (expert tensor
    parallel) = tensor. Mirrors reference ``ParallelFoldingSpec`` fields.
    """
    world_size: int
    ep_size: int
    edp_size: int
    etp_size: int

    def validate(self, n_experts: int) -> None:
        if self.ep_size > 1 and n_experts % self.ep_size != 0:
            raise ValueError(
                f"ep_size {self.ep_size} does not divide num_experts "
                f"{n_experts}; choose an 'expert' mesh axis that divides the "
                "expert count")
        if self.ep_size * self.edp_size * self.etp_size != self.world_size:
            raise ValueError(
                f"ep {self.ep_size} × edp {self.edp_size} × etp "
                f"{self.etp_size} != world {self.world_size}")


def ep_topology(mesh_shape: Dict[str, int]) -> EPTopology:
    """Mesh axis sizes → EPTopology. Axes default to 1."""
    data = int(mesh_shape.get("data", 1)) * int(mesh_shape.get("zshard", 1))
    ep = int(mesh_shape.get("expert", 1))
    tp = int(mesh_shape.get("tensor", 1))
    return EPTopology(world_size=data * ep * tp, ep_size=ep, edp_size=data,
                      etp_size=tp)


def fold_group_tables(mesh_shape: Dict[str, int]
                      ) -> Dict[str, Tuple[Tuple[int, ...], ...]]:
    """Rank groups for each parallel dimension, axis order (data, expert,
    tensor) — reference ``FoldingGroupTables`` (tp/dense-dp/ep/edp). On TPU
    these are implied by the mesh (XLA lowers collectives per axis); the
    explicit tables exist for checkpoint-layout tooling and tests.
    """
    topo = ep_topology(mesh_shape)
    d, e, t = topo.edp_size, topo.ep_size, topo.etp_size
    grid = np.arange(topo.world_size).reshape(d, e, t)
    tp_groups = tuple(tuple(grid[i, j, :].tolist())
                      for i, j in itertools.product(range(d), range(e)))
    ep_groups = tuple(tuple(grid[i, :, k].tolist())
                      for i, k in itertools.product(range(d), range(t)))
    edp_groups = tuple(tuple(grid[:, j, k].tolist())
                       for j, k in itertools.product(range(e), range(t)))
    dense_dp = tuple(tuple(grid[:, :, k].reshape(-1).tolist())
                     for k in range(t))
    return {"tp": tp_groups, "ep": ep_groups, "edp": edp_groups,
            "dense_dp": dense_dp}
