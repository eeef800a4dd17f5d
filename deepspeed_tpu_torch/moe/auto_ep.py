"""AutoEP: expert-parallel detection and planning.

Ports ``deepspeed_tpu/moe/auto_ep.py``: ``EPPlan``, ``detect_moe`` (:72:
the preset registry first, then a sweep of generic HF attribute names, or a
zoo ``TransformerConfig``) and ``plan_ep`` (:91: the largest divisor of the
device count that also divides the expert count, capped by ``max_ep``; the
rest of the width is expert-data parallelism). Here the "devices" are the
processes of the default process group.

``auto_ep`` (:125) imports the model through the HF importer
(``models/hf_import.py``), a later slice: it raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from deepspeed_tpu_torch.moe.presets import (EPTopology,
                                             preset_for_model_type,
                                             resolve_preset)
from deepspeed_tpu_torch.runtime.config_utils import later_slice

# Generic HF config attribute names marking MoE archs (the fallback when no
# preset matches the model_type)
_MOE_ATTRS = (
    ("num_local_experts", "num_experts_per_tok"),      # mixtral-like
    ("num_experts", "num_experts_per_tok"),            # qwen-moe-like
    ("n_routed_experts", "num_experts_per_tok"),       # deepseek-like
    ("moe_num_experts", "moe_top_k"),                  # misc
)


@dataclasses.dataclass(frozen=True)
class EPPlan:
    enabled: bool
    n_experts: int = 0
    top_k: int = 0
    ep_size: int = 1
    edp_size: int = 1
    etp_size: int = 1
    preset: Optional[str] = None
    reason: str = ""

    def describe(self) -> str:
        if not self.enabled:
            return f"AutoEP: disabled ({self.reason})"
        fam = f" [{self.preset}]" if self.preset else ""
        return (f"AutoEP{fam}: {self.n_experts} experts top-{self.top_k} over "
                f"ep={self.ep_size}×edp={self.edp_size}×etp={self.etp_size} "
                f"({self.reason})")

    def topology(self) -> EPTopology:
        return EPTopology(
            world_size=self.ep_size * self.edp_size * self.etp_size,
            ep_size=self.ep_size, edp_size=self.edp_size,
            etp_size=self.etp_size)


def detect_moe(config: Any) -> Tuple[int, int]:
    """→ (n_experts, top_k); (0, 0) for a dense model. An HF config or a
    zoo TransformerConfig: the preset registry first, then the generic
    attribute sweep."""
    n = getattr(config, "n_experts", 0)
    if n:
        return int(n), int(getattr(config, "moe_top_k", 2))
    resolved = resolve_preset(config)
    if resolved is not None:
        knobs = resolved[1]
        return knobs["n_experts"], knobs["top_k"]
    for n_attr, k_attr in _MOE_ATTRS:
        n = getattr(config, n_attr, 0) or 0
        if n:
            return int(n), int(getattr(config, k_attr, 2) or 2)
    return 0, 0


def plan_ep(config: Any, n_devices: Optional[int] = None,
            max_ep: Optional[int] = None, etp_size: int = 1) -> EPPlan:
    """The expert-parallel width: the largest divisor of the device count
    that also divides the expert count (capped by ``max_ep``); the rest of
    the width becomes expert-data parallelism. ``n_devices`` defaults to
    the processes of the default process group."""
    n_experts, top_k = detect_moe(config)
    preset = preset_for_model_type(getattr(config, "model_type", None))
    pname = preset.name if preset else None
    if not n_experts:
        return EPPlan(False, reason="no MoE layers detected")
    if n_devices is None:
        from deepspeed_tpu_torch.comm.mesh import process_world_size

        n_devices = process_world_size()
    if n_devices % etp_size != 0:
        raise ValueError(f"etp_size {etp_size} does not divide device count "
                         f"{n_devices}")
    avail = n_devices // etp_size
    ep = 1
    for cand in range(1, min(n_experts, avail, max_ep or n_experts) + 1):
        if avail % cand == 0 and n_experts % cand == 0:
            ep = cand
    edp = avail // ep
    if ep == 1:
        return EPPlan(True, n_experts, top_k, 1, edp, etp_size, pname,
                      "no common divisor > 1 of devices and experts; "
                      "experts replicated")
    plan = EPPlan(True, n_experts, top_k, ep, edp, etp_size, pname,
                  f"{n_experts} experts over {n_devices} devices")
    plan.topology().validate(n_experts)
    return plan


def auto_ep(model_or_spec, n_devices: Optional[int] = None,
            max_ep: Optional[int] = None, etp_size: int = 1,
            **spec_kwargs) -> Tuple[Any, Dict[str, int], EPPlan]:
    """JAX's detect + plan + inject (:125): it imports the model through
    the HF importer (``models/hf_import.py``), a later slice."""
    raise later_slice("auto_ep (it imports the model through "
                      "models/hf_import.py)")
