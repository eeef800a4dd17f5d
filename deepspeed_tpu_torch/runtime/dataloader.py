"""Synthetic token data and the stacking of an accumulation window.

``synthetic_lm_data`` is a copy of ``deepspeed_tpu/runtime/dataloader.py``
(:328): numpy, so one seed gives both packages the same tokens.
``stack_micros`` is the JAX engine's ``_stack_micros``: the gas micro-batches
of one step stacked on a leading axis.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

Batch = Union[np.ndarray, torch.Tensor, Dict[str, Any]]


def synthetic_lm_data(batch_size: int, seq_len: int, vocab_size: int,
                      seed: int = 0, num_batches: Optional[int] = None,
                      dtype=np.int32) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic synthetic token stream (the ``random_dataloader``
    fixture analog, reference ``tests/unit/simple_model.py:275``)."""
    rng = np.random.default_rng(seed)
    i = 0
    while num_batches is None or i < num_batches:
        yield {"tokens": rng.integers(0, vocab_size, (batch_size, seq_len),
                                      dtype=dtype)}
        i += 1


def stack_micros(micros: List[Batch]) -> Batch:
    """Stack gas micro-batches (dicts of arrays, or arrays) on a new leading
    axis; they must share one shape, as in the JAX engine."""
    if isinstance(micros[0], dict):
        return {k: stack_micros([m[k] for m in micros]) for k in micros[0]}
    if isinstance(micros[0], torch.Tensor):
        arrs = list(micros)
        shapes = {tuple(a.shape) for a in arrs}
    else:
        arrs = [np.asarray(m) for m in micros]
        shapes = {a.shape for a in arrs}
    if len(shapes) > 1:
        raise ValueError(
            "micro-batches in one accumulation window have different shapes "
            f"{sorted(shapes)} — variable/token-budget batching requires "
            "gradient_accumulation_steps=1")
    if isinstance(arrs[0], torch.Tensor):
        return torch.stack(arrs)
    return np.stack(arrs)
