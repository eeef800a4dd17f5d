"""Token sampling: greedy, temperature, top-k, top-p (nucleus).

Parity: ``deepspeed_tpu/inference/sampling.py`` ``sample_logits``. The JAX
version draws with a ``jax.random`` key; this one with a
``torch.Generator``. The two give different draws from one seed; greedy
(temperature 0) is identical. Inside a captured CUDA graph
(``inference/graphs.TickGraph``) the generator must be registered with the
graph (``CUDAGraph.register_generator_state``), so that each replay draws
anew from it; a capture that draws from one not registered raises.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """logits [B, V] → token ids [B] (int64). Temperature 0 → greedy argmax
    (the first maximal index on ties, as ``jnp.argmax``)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sampling with temperature > 0 requires a generator")
    logits = logits.float() / temperature
    V = logits.shape[-1]
    if top_k and top_k < V:
        kth = torch.sort(logits, dim=-1).values[:, V - top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=V - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
