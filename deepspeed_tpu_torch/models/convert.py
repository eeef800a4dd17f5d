"""Carry parameters across from the JAX package.

``params_from_numpy(jax.tree.map(np.asarray, init_params(cfg, key)), cfg)``
turns a JAX parameter pytree (nested dicts of numpy arrays, same keys and
shapes as the port's) into a :class:`~deepspeed_tpu_torch.models.paged.
PagedTransformer`. Floating leaves are cast to the compute dtype, as the JAX
``FastGenEngine`` casts them; integer leaves keep theirs. With ``tp`` (a
rank's :class:`~deepspeed_tpu_torch.comm.mesh.TensorGroup`) each leaf is
the rank's slice of the global leaf (:func:`tp_local_tree`, the one place
a whole tree is cut for a tensor axis; FastGen goes through it too).
:func:`pp_local_tree` cuts a stage's layers of a ``pipe`` axis; the two
compose (``tp_local_tree(pp_local_tree(tree, ...), ...)``), each keeping
what the other or an earlier call already cut.

``load_master(engine, jax.tree.map(np.asarray, jax_engine.state["master"]))``
copies a JAX fp32 master tree into a training engine's master state, so both
engines start from the same weights; a data-parallel rank keeps its shard
of each leaf (under an ``expert`` axis, its experts of each expert leaf
first, under a ``tensor`` axis its slice, under a ``pipe`` axis its
stage's layers: ``engine.local_leaf``).
``gather_master(engine)`` reads a data-parallel engine's sharded master
back as whole numpy arrays, the experts and the tensor slices of every
rank included (every rank calls it).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.models.paged import PagedTransformer
from deepspeed_tpu_torch.parallel.partitioning import (
    pp_slice,
    tp_dim,
    tp_slice,
)


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


def tp_local_tree(tree: Dict[str, Any], cfg: T.TransformerConfig,
                  size: int, rank: int) -> Dict[str, Any]:
    """Rank ``rank``'s slices, on a ``tensor`` axis of ``size``, of the
    parameter tree ``tree`` of ``cfg`` (numpy arrays or tensors): each leaf
    with a tensor dim at its global size is cut (``tp_slice``), a leaf
    already cut is kept as it is, and a tensor's slice is copied so that
    the whole leaf can be freed."""
    full = {"vocab": cfg.vocab_size, "mlp": cfg.ffn_size,
            "heads": cfg.num_heads * cfg.head_dim,
            "kv_heads": cfg.kv_heads * cfg.head_dim}

    def cut(axes, t):
        if isinstance(t, dict):
            return {k: cut(axes[k], v) for k, v in t.items()}
        dim = tp_dim(axes)
        if dim is None or t.shape[dim] != full[axes[dim]]:
            return t
        piece = tp_slice(axes, t, size, rank)
        if isinstance(piece, torch.Tensor):
            return piece.clone(memory_format=torch.contiguous_format)
        return piece

    return cut(T.param_logical_axes(cfg), tree)


def pp_local_tree(tree: Dict[str, Any], cfg: T.TransformerConfig,
                  size: int, stage: int) -> Dict[str, Any]:
    """Stage ``stage``'s part, on a ``pipe`` axis of ``size``, of the
    parameter tree ``tree`` of ``cfg`` (numpy arrays or tensors): each
    ``blocks`` leaf at its whole L layers is cut to the stage's L/P
    (``pp_slice``), a leaf already cut is kept as it is, a tensor's cut is
    copied so that the whole leaf can be freed; every other leaf whole."""
    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        if t.shape[0] != cfg.num_layers:
            return t
        piece = pp_slice(t, size, stage)
        if isinstance(piece, torch.Tensor):
            return piece.clone(memory_format=torch.contiguous_format)
        return piece

    return {k: cut(v) if k == "blocks" else v for k, v in tree.items()}


def params_from_numpy(tree: Dict[str, Any], cfg: T.TransformerConfig,
                      device=None, dtype: Optional[torch.dtype] = None,
                      tp=None) -> PagedTransformer:
    """``device`` as in :func:`resolve_device` (``None`` = the first GPU;
    tests pass ``"cpu"``); ``dtype`` defaults to ``cfg.compute_dtype``;
    ``tp``: the rank's slices of a ``tensor`` axis (:func:`tp_local_tree`)."""
    dev = resolve_device(device)
    if tp is not None:
        tree = tp_local_tree(tree, cfg, tp.size, tp.rank)
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
    keeps its shard of its experts or of its tensor slice — and refresh
    its compute copy. Keys or shapes that differ raise ``ValueError``."""
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
