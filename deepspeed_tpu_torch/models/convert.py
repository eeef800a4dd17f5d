"""Carry parameters across from the JAX package.

``params_from_numpy(jax.tree.map(np.asarray, init_params(cfg, key)), cfg)``
turns a JAX parameter pytree (nested dicts of numpy arrays, same keys and
shapes as the port's) into a :class:`~deepspeed_tpu_torch.models.paged.
PagedTransformer`. Floating leaves are cast to the compute dtype, as the JAX
``FastGenEngine`` casts them; integer leaves keep theirs.

``load_master(engine, jax.tree.map(np.asarray, jax_engine.state["master"]))``
copies a JAX fp32 master tree into a training engine's master state, so both
engines start from the same weights; a data-parallel rank keeps its shard
of each leaf (under an ``expert`` axis, its experts of each expert leaf
first: ``engine.local_leaf``). ``gather_master(engine)`` reads a
data-parallel engine's sharded master back as whole numpy arrays, the
experts of every rank included (every rank calls it).
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


def _leaves(tree: Dict[str, Any], prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_master(engine, tree: Dict[str, Any]) -> None:
    """Copy the fp32 master tree ``tree`` (numpy arrays or tensors, the JAX
    keys and whole shapes) into ``engine``'s master — a data-parallel rank
    keeps its shard of its experts — and refresh its compute copy. Keys or shapes that differ
    raise ``ValueError``."""
    slots = {slot.path: slot for slot in engine._slots}
    src = dict(_leaves(tree))
    if sorted(slots) != sorted(src):
        diff = sorted(set(slots) ^ set(src))
        raise ValueError(f"master keys differ at {'/'.join(diff[0])}: "
                         f"{len(slots)} leaves vs {len(src)}")
    with torch.no_grad():
        for path, slot in slots.items():
            t = engine.local_leaf(path, _to_tensor(src[path], torch.float32,
                                                   engine.device))
            if tuple(t.shape) != slot.shape:
                raise ValueError(f"master /{'/'.join(path)}: shape "
                                 f"{tuple(t.shape)}, want {slot.shape}")
            engine._load_master_leaf(slot, t)
    engine._compute_params()


def gather_master(engine) -> Dict[str, Any]:
    """The engine's whole fp32 master as numpy arrays (JAX's keys and
    shapes); collective on a data-parallel engine."""
    if hasattr(engine, "full_master"):
        tree = engine.full_master()
    else:
        engine._materialize_master()
        tree = engine.state["master"]

    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else v.detach().cpu().numpy() for k, v in t.items()}

    return walk(tree)
