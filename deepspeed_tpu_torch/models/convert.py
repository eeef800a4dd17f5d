"""Carry parameters across from the JAX package.

``params_from_numpy(jax.tree.map(np.asarray, init_params(cfg, key)), cfg)``
turns a JAX parameter pytree (nested dicts of numpy arrays, same keys and
shapes as the port's) into a :class:`~deepspeed_tpu_torch.models.paged.
PagedTransformer`. Floating leaves are cast to the compute dtype, as the JAX
``FastGenEngine`` casts them; integer leaves keep theirs.
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
