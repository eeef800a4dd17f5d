"""ModelSpec — the contract between a model and the training engine.

Ports ``deepspeed_tpu/models/api.py``: ``ModelSpec`` (:23),
``resolve_attention`` (:58) for ``xla`` / ``None``, ``flash`` and
``sparse[:fixed|bigbird|bslongformer]``, and
``causal_lm_spec`` (:124) for ``loss_impl`` fused or exact with untiled
loss. A model is functions plus metadata: ``init_fn(generator, device)``
returns the fp32 master tree (the JAX pytree's keys and shapes), and
``loss_fn(params, batch)`` the scalar loss on compute-dtype parameters —
a tree whose ``blocks`` are either stacked [L, ...] tensors or a list of
per-layer dicts (the engine's per-layer leaves) — and ``axes_fn()`` the
logical axes of each parameter dim.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.runtime.config_utils import later_slice

Batch = Union[torch.Tensor, Dict[str, torch.Tensor]]

# attention names of the JAX package that a later slice ports
_LATER_ATTENTION = ("ulysses", "ulysses_flash", "ring", "chunked", "fpdt")


@dataclasses.dataclass
class ModelSpec:
    init_fn: Callable[..., Any]                     # (generator, device) → fp32 params
    loss_fn: Callable[[Any, Batch], torch.Tensor]   # (compute params, batch) → scalar
    apply_fn: Optional[Callable[[Any, Batch], Any]] = None  # → model outputs
    name: str = "model"
    num_params: Optional[int] = None
    seq_len: Optional[int] = None
    config: Any = None             # underlying model config (zoo: TransformerConfig)
    # fn(remat=None) → an equivalent spec with that knob changed (the
    # engine's activation_checkpointing.policy); None when the spec holds a
    # hand-written attention_fn
    builder: Optional[Callable[..., "ModelSpec"]] = None
    # → the tree of logical axis names per parameter dim (the ZeRO layout
    # reads it); None: every leaf replicated
    axes_fn: Optional[Callable[[], Any]] = None


def _tokens_of(batch: Batch) -> torch.Tensor:
    return batch["tokens"] if isinstance(batch, dict) else batch


def _mask_of(batch: Batch):
    return batch.get("loss_mask") if isinstance(batch, dict) else None


def resolve_attention(attention: Optional[str], use_kernels: bool = True):
    """'xla' / None / 'default' → None (the plain attention of the model);
    'flash' → the CUDA flash-attention kernels (``ops/flash_attention.py``);
    'sparse' | 'sparse:fixed' | 'sparse:bigbird' | 'sparse:bslongformer' →
    block-sparse attention at block 64 (``ops/block_sparse.py``, the
    default kind ``fixed``). ``use_kernels=False`` gives the kernels' plain
    versions under autograd. The JAX package's sequence-parallel attentions
    raise ``NotImplementedError``; unknown names and sparse kinds raise
    ``ValueError``, as in JAX."""
    if attention in (None, "xla", "default"):
        return None
    if attention == "flash":
        from deepspeed_tpu_torch.ops import flash_attention as PF

        return PF.flash_attention if use_kernels else PF.flash_attention_plain
    if attention.startswith("sparse"):
        from deepspeed_tpu_torch.ops.block_sparse import sparse_attention

        kind = attention.split(":", 1)[1] if ":" in attention else "fixed"
        return sparse_attention(kind, use_kernels=use_kernels)
    if attention in _LATER_ATTENTION:
        raise later_slice(f"attention={attention!r}")
    raise ValueError(f"unknown attention impl {attention!r}")


def causal_lm_spec(cfg: Union[str, T.TransformerConfig], attention_fn=None,
                   attention: Optional[str] = None, loss_tiles: int = 0,
                   loss_impl: str = "fused", use_kernels: bool = True,
                   **overrides) -> ModelSpec:
    """A ModelSpec for a causal-LM preset or config. ``loss_impl``: 'fused'
    (compute-dtype logits, one compute-dtype grad-logits array — the JAX
    default) or 'exact' (fp32 logits through ``head_matmul``).
    ``use_kernels=False`` runs the kernels' plain versions on any device
    (flash and block-sparse attention's whole-tensor versions under
    autograd, the plain norms and grouped GEMMs): the card's kernel-vs-plain
    checks. An MoE config (``n_experts > 0``) adds ``moe_aux_coef`` × the layers' summed
    aux loss to the LM loss, as JAX does."""
    if attention_fn is not None and attention is not None:
        raise ValueError("pass either attention_fn or attention=, not both")
    if loss_impl not in ("fused", "exact"):
        raise ValueError(f"unknown loss_impl {loss_impl!r}; one of "
                         "fused|exact (a typo must not silently change the "
                         "loss numerics/perf class)")
    if loss_tiles > 1:
        raise later_slice(f"loss_tiles={loss_tiles}")
    if attention_fn is None:
        attention_fn = resolve_attention(attention, use_kernels)
    if isinstance(cfg, str):
        name = cfg
        cfg = T.get_model_config(cfg, **overrides)
    else:
        name = "transformer"
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
    if cfg.remat not in T.REMAT_POLICIES:
        raise later_slice(f"remat={cfg.remat!r} (this slice runs none|full)")
    T._check_supported(cfg)

    def loss_fn(params, batch):
        tokens = _tokens_of(batch)
        hidden, head, aux = T.forward_hidden(params, tokens, cfg,
                                             attention_fn=attention_fn,
                                             use_kernels=use_kernels)
        if loss_impl == "fused":
            loss = T.fused_lm_loss(hidden, head, tokens, _mask_of(batch))
        else:
            logits = T.head_matmul(hidden, head.to(hidden.dtype))
            loss = T.causal_lm_loss(logits, tokens, _mask_of(batch))
        if cfg.n_experts > 0:
            loss = loss + cfg.moe_aux_coef * aux
        return loss

    def apply_fn(params, batch):
        return T.forward(params, _tokens_of(batch), cfg,
                         attention_fn=attention_fn, use_kernels=use_kernels)

    def init_fn(generator: Optional[torch.Generator] = None, device=None):
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        return T.init_params(cfg, generator, dev)

    user_attention_fn = attention_fn is not None and attention is None

    def _rebuild(remat: Optional[str] = None) -> ModelSpec:
        cfg2 = dataclasses.replace(cfg, remat=remat) if remat else cfg
        return causal_lm_spec(cfg2, attention=attention, loss_impl=loss_impl,
                              use_kernels=use_kernels)

    return ModelSpec(init_fn=init_fn, loss_fn=loss_fn, apply_fn=apply_fn,
                     name=name, num_params=cfg.num_params(),
                     seq_len=cfg.max_seq_len, config=cfg,
                     builder=None if user_attention_fn else _rebuild,
                     axes_fn=lambda: T.param_logical_axes(cfg))
