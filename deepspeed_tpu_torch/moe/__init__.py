"""Mixture of experts (the JAX package's ``deepspeed_tpu/moe/``).

* :mod:`gating` — top-1 / 2 / k gates with capacity and the load-balancing
  loss, and the index-form gate of the dropless dispatch.
* :mod:`layer` — the dropless ragged dispatch (counting sort, grouped
  GEMMs of ``ops/grouped_gemm.py``, gather-only combine; the fixed-capacity
  all-to-all under expert parallelism) and the dense GShard dispatch (its
  [E, C, H] buffers by all-to-all across the experts under expert
  parallelism).
* :mod:`presets`, :mod:`auto_ep` — AutoEP's model-family presets,
  topology math, planning and ``auto_ep`` of a model spec.

Model integration: ``n_experts > 0`` on a ``TransformerConfig`` (the
``tiny_moe`` and ``moe_350m`` presets).
"""
from deepspeed_tpu_torch.moe.gating import (
    GateOutput,
    IndexGateOutput,
    gate_capacity,
    top1_gating,
    top2_gating,
    topk_gating,
    topk_gating_indices,
)
from deepspeed_tpu_torch.moe.layer import (
    ep_shard_capacity,
    moe_ffn,
    ragged_expert_ffn,
    resolve_dispatch,
)
from deepspeed_tpu_torch.moe.presets import (EPTopology, MoEPreset, PRESETS,
                                             ep_topology, fold_group_tables,
                                             preset_for_model_type,
                                             resolve_preset)

__all__ = [
    "GateOutput",
    "IndexGateOutput",
    "gate_capacity",
    "top1_gating",
    "top2_gating",
    "topk_gating",
    "topk_gating_indices",
    "moe_ffn",
    "ragged_expert_ffn",
    "ep_shard_capacity",
    "resolve_dispatch",
    "MoEPreset",
    "PRESETS",
    "EPTopology",
    "ep_topology",
    "fold_group_tables",
    "preset_for_model_type",
    "resolve_preset",
]
