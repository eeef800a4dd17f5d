"""Carry parameters across from the JAX package.

``params_from_numpy(jax.tree.map(np.asarray, init_params(cfg, key)), cfg)``
turns a JAX parameter pytree (nested dicts of numpy arrays, same keys and
shapes as the port's) into a :class:`~deepspeed_tpu_torch.models.paged.
PagedTransformer`. Floating leaves are cast to the compute dtype, as the JAX
``FastGenEngine`` casts them; integer leaves keep theirs.

``load_master(engine, jax.tree.map(np.asarray, jax_engine.state["master"]))``
copies a JAX fp32 master tree into a training engine's master state, so both
engines start from the same weights.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.models.paged import PagedTransformer


def _to_tensor(x: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":      # ml_dtypes: no torch.from_numpy
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr))      # a writable copy
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def tree_from_numpy(tree: Dict[str, Any], dtype: torch.dtype,
                    device: torch.device) -> Dict[str, Any]:
    """Nested dict of numpy arrays (or tensors) → the same dict of tensors
    on ``device``, floating leaves cast to ``dtype``."""
    return {k: tree_from_numpy(v, dtype, device) if isinstance(v, dict)
            else _to_tensor(v, dtype, device) for k, v in tree.items()}


def params_from_numpy(tree: Dict[str, Any], cfg: T.TransformerConfig,
                      device=None, dtype: Optional[torch.dtype] = None
                      ) -> PagedTransformer:
    """``device`` as in :func:`resolve_device` (``None`` = the first GPU;
    tests pass ``"cpu"``); ``dtype`` defaults to ``cfg.compute_dtype``."""
    dev = resolve_device(device)
    return PagedTransformer(
        cfg, tree_from_numpy(tree, dtype or cfg.compute_dtype, dev))


def load_master(engine, tree: Dict[str, Any]) -> None:
    """Copy the fp32 master tree ``tree`` (numpy arrays or tensors, the JAX
    keys and shapes) into ``engine``'s master and refresh its compute copy.
    Keys or shapes that differ raise ``ValueError``."""
    have = engine.state["master"]

    def copy(dst: Dict[str, Any], src: Dict[str, Any], path: str) -> None:
        if sorted(dst) != sorted(src):
            raise ValueError(f"master keys differ at {path or '/'}: "
                             f"{sorted(dst)} vs {sorted(src)}")
        for k, d in dst.items():
            if isinstance(d, dict):
                copy(d, src[k], f"{path}/{k}")
                continue
            t = _to_tensor(src[k], torch.float32, d.device)
            if tuple(t.shape) != tuple(d.shape):
                raise ValueError(f"master {path}/{k}: shape "
                                 f"{tuple(t.shape)}, want {tuple(d.shape)}")
            with torch.no_grad():
                d.copy_(t)

    copy(have, tree, "")
    engine._compute_params()
