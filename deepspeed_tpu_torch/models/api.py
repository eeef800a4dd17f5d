"""ModelSpec — the contract between a model and the training engine.

Ports ``deepspeed_tpu/models/api.py``: ``ModelSpec`` (:23),
``resolve_attention`` (:58) for ``xla`` / ``None``, ``flash``,
``sparse[:fixed|bigbird|bslongformer]`` and the sequence-parallel
``ulysses``, ``ulysses_flash``, ``ring``, ``chunked`` and ``fpdt``, and
``causal_lm_spec`` (:124) for ``loss_impl`` fused or exact and the tiled
loss (``loss_tiles > 1``, :194-198), with JAX's ``builder`` (:227-255).
A model is functions plus metadata: ``init_fn(generator, device)``
returns the fp32 master tree (the JAX pytree's keys and shapes), and
``loss_fn(params, batch)`` the scalar loss on compute-dtype parameters —
a tree whose ``blocks`` are either stacked [L, ...] tensors or a list of
per-layer dicts (the engine's per-layer leaves) — and ``axes_fn()`` the
logical axes of each parameter dim.

Under a ``seq`` mesh axis above 1 the engine hands each rank's
``loss_fn`` whole rows (``tokens`` / ``loss_mask`` [B, S]) and the batch
key ``seq_shard`` (idx, sp), and the rank computes its own positions
``[idx·S/sp, (idx+1)·S/sp)``: the embedding and position tables there,
attention across the ``seq`` ranks (``ulysses``, ``ulysses_flash`` or
``ring``; another attention raises, since JAX's GSPMD gathers the
sequence for it and the port does not), and the LM loss over those
positions' next tokens, the rank's masked mean (the engine weights the
ranks' means into JAX's global one).

Under a ``tensor`` mesh axis above 1 the engine hands each rank's
``loss_fn`` its slices of the parameters and the batch key ``tp`` (the
rank's :class:`~deepspeed_tpu_torch.comm.mesh.TensorGroup`), and the model
runs Megatron's dataflow (``models/transformer``): ``flash`` runs the
flash kernels on the rank's heads, ``xla`` the plain attention; the
fused and the exact loss are vocab-parallel. Block-sparse attention, the
tiled loss and MoE raise (queue A.4).

Under a ``pipe`` mesh axis above 1 (the batch key ``pp``, this rank's
:class:`~deepspeed_tpu_torch.comm.mesh.PipeGroup`, which the engine
passes; else the installed mesh's) ``loss_fn`` takes the GPipe loss
(``transformer.pipelined_lm_loss``) and ``loss_and_grads_fn`` the 1F1B
schedule's loss and gradients (``pipelined_lm_loss_and_grads``), as JAX's
``causal_lm_spec`` (:129-146, :172-181, :217-224) with
``pipeline_schedule`` and ``pipeline_micro_batches``; ``params`` hold the
stage's layers (or are a ZeRO-3 engine's parameter hook). The engine's
batch key ``pipe_weights`` [M] weights each pipeline micro-batch's loss
(``runtime/engine``); with ``seq_shard`` beside ``pp`` each rank computes
its positions inside every stage. As in JAX the pipelined loss is taken
before the tiled loss: ``loss_tiles`` is not read under ``pipe``. The
ring attention raises under ``pipe``, as JAX's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.runtime.config_utils import later_slice

Batch = Union[torch.Tensor, Dict[str, torch.Tensor]]

# the attentions that run across the ranks of a seq axis
SEQ_PARALLEL_ATTENTION = ("ulysses", "ulysses_flash", "ring")


@dataclasses.dataclass
class ModelSpec:
    init_fn: Callable[..., Any]                     # (generator, device) → fp32 params
    loss_fn: Callable[[Any, Batch], torch.Tensor]   # (compute params, batch) → scalar
    apply_fn: Optional[Callable[[Any, Batch], Any]] = None  # → model outputs
    name: str = "model"
    num_params: Optional[int] = None
    seq_len: Optional[int] = None
    config: Any = None             # underlying model config (zoo: TransformerConfig)
    # fn(attention=None, loss_tiles=0, remat=None) → an equivalent spec
    # with those knobs changed (AutoSP, the engine's
    # activation_checkpointing.policy); None when the spec holds a
    # hand-written attention_fn
    builder: Optional[Callable[..., "ModelSpec"]] = None
    # → the tree of logical axis names per parameter dim (the ZeRO layout
    # reads it); None: every leaf replicated
    axes_fn: Optional[Callable[[], Any]] = None
    # the attention name the spec was built with (AutoSP keeps the flash
    # kernels inside Ulysses)
    attention: Optional[str] = None
    # (params, batch, loss_scale=None) → (loss, grads) for a schedule with
    # an explicit backward (1F1B under a pipe axis), else None: the engine
    # differentiates loss_fn
    loss_and_grads_fn: Optional[Callable[..., Any]] = None
    # the pipeline's micro-batches a step's micro-batch (None: the stages)
    pipeline_micro_batches: Optional[int] = None


def _tokens_of(batch: Batch) -> torch.Tensor:
    return batch["tokens"] if isinstance(batch, dict) else batch


def _mask_of(batch: Batch):
    return batch.get("loss_mask") if isinstance(batch, dict) else None


def resolve_attention(attention: Optional[str], use_kernels: bool = True):
    """'xla' / None / 'default' → None (the plain attention of the model);
    'flash' → the CUDA flash-attention kernels (``ops/flash_attention.py``);
    'ulysses' / 'ulysses_flash' → Ulysses' all-to-alls over ``seq`` around
    the plain attention / the flash kernels; 'ring' → the K/V ring over
    ``seq``; 'chunked' → query-chunked attention; 'fpdt' → FPDT attention
    (``sequence/``); 'sparse' | 'sparse:fixed' | 'sparse:bigbird' |
    'sparse:bslongformer' → block-sparse attention at block 64
    (``ops/block_sparse.py``, the default kind ``fixed``).
    ``use_kernels=False`` gives the kernels' plain versions under autograd.
    Unknown names and sparse kinds raise ``ValueError``, as in JAX."""
    if attention in (None, "xla", "default"):
        return None
    if attention in ("flash", "ulysses_flash"):
        from deepspeed_tpu_torch.ops import flash_attention as PF

        flash = (PF.flash_attention if use_kernels
                 else PF.flash_attention_plain)
        if attention == "flash":
            return flash
        from deepspeed_tpu_torch.sequence import ulysses_attention

        return ulysses_attention(inner=flash)
    if attention == "ulysses":
        from deepspeed_tpu_torch.sequence import ulysses_attention

        return ulysses_attention()
    if attention == "ring":
        from deepspeed_tpu_torch.sequence import ring_attention

        return ring_attention()
    if attention == "chunked":
        from deepspeed_tpu_torch.sequence import chunked_attention

        return chunked_attention
    if attention == "fpdt":
        from deepspeed_tpu_torch.sequence.tiled import fpdt_attention

        return fpdt_attention
    if attention.startswith("sparse"):
        from deepspeed_tpu_torch.ops.block_sparse import sparse_attention

        kind = attention.split(":", 1)[1] if ":" in attention else "fixed"
        return sparse_attention(kind, use_kernels=use_kernels)
    raise ValueError(f"unknown attention impl {attention!r}")


def _seq_shard_of(batch: Batch):
    """The batch's ``seq_shard`` (idx, sp): the positions of the whole rows
    this rank of a ``seq`` axis computes, which the engine passes; None:
    every position."""
    return batch.get("seq_shard") if isinstance(batch, dict) else None


def _weights_of(batch: Batch):
    """The batch's ``pipe_weights`` [M] (the engine's weight of each
    pipeline micro-batch's loss); None: weight one."""
    return batch.get("pipe_weights") if isinstance(batch, dict) else None


def _tp_of(batch: Batch):
    """The batch's ``tp`` (this rank's ``tensor`` axis group, which the
    engine passes); None: the whole model on this rank."""
    return batch.get("tp") if isinstance(batch, dict) else None


def _pp_of(batch: Batch):
    """This rank's ``pipe`` axis group: the batch's ``pp`` (which the
    engine passes), else the installed mesh's; None at pipe = 1 (JAX's
    ``_pipe_stages`` reads the global mesh)."""
    pp = batch.get("pp") if isinstance(batch, dict) else None
    if pp is None:
        from deepspeed_tpu_torch.comm import mesh as mesh_mod

        if mesh_mod.mesh_is_initialized():
            pp = mesh_mod.get_mesh_manager().pipe()
    return pp


def causal_lm_spec(cfg: Union[str, T.TransformerConfig], attention_fn=None,
                   attention: Optional[str] = None, loss_tiles: int = 0,
                   loss_impl: str = "fused", use_kernels: bool = True,
                   pipeline_schedule: str = "1f1b",
                   pipeline_micro_batches: Optional[int] = None,
                   **overrides) -> ModelSpec:
    """A ModelSpec for a causal-LM preset or config. ``loss_impl``: 'fused'
    (compute-dtype logits, one compute-dtype grad-logits array — the JAX
    default) or 'exact' (fp32 logits through ``head_matmul``).
    ``loss_tiles > 1`` takes the tiled loss (``sequence/tiled.
    tiled_lm_loss``: fp32 tile logits, no [B, S, V] array), which takes
    precedence over ``loss_impl`` as in JAX.
    ``use_kernels=False`` runs the kernels' plain versions on any device
    (flash and block-sparse attention's whole-tensor versions under
    autograd, the plain norms and grouped GEMMs): the card's kernel-vs-plain
    checks. An MoE config (``n_experts > 0``) adds ``moe_aux_coef`` × the layers' summed
    aux loss to the LM loss, as JAX does.
    ``pipeline_schedule``: '1f1b' (the explicit backward, O(stages)
    activations) or 'gpipe' (autograd over the ticks, O(micro-batches));
    only read under a ``pipe`` axis above 1. ``pipeline_micro_batches``:
    the schedule's micro-batches M of a step's micro-batch (default M =
    P); the bubble is (P − 1)/(M + P − 1)."""
    if attention_fn is not None and attention is not None:
        raise ValueError("pass either attention_fn or attention=, not both")
    if loss_impl not in ("fused", "exact"):
        raise ValueError(f"unknown loss_impl {loss_impl!r}; one of "
                         "fused|exact (a typo must not silently change the "
                         "loss numerics/perf class)")
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

    def _check_seq(shard):
        if shard is not None and attention not in SEQ_PARALLEL_ATTENTION:
            raise later_slice(
                f"attention={attention!r} under a seq mesh axis above 1 "
                "(JAX's GSPMD gathers the sequence for it; the port runs "
                f"{'|'.join(SEQ_PARALLEL_ATTENTION)} across seq ranks)")

    def _check_pipe(pp):
        if attention == "ring":
            # JAX's ring shard_map takes the concrete mesh, which does not
            # match the pipeline's manual context mesh: it raises there
            raise ValueError(
                f"attention='ring' under mesh pipe={pp.size}: the JAX "
                "package's ring attention does not run inside its pipeline "
                "(its shard_map's mesh does not match the pipeline's "
                "context mesh); use 'ulysses' or 'ulysses_flash'")

    # under a pipe axis JAX's loss_fn returns the pipelined loss before the
    # tiled loss (api.py:174-182 against :194-198): loss_tiles is not read
    def loss_fn(params, batch):
        tokens = _tokens_of(batch)
        pp = _pp_of(batch)
        shard = _seq_shard_of(batch)
        _check_seq(shard)
        if pp is not None:
            _check_pipe(pp)
            loss, aux = T.pipelined_lm_loss(
                params, tokens, cfg, pp, n_micro=pipeline_micro_batches,
                attention_fn=attention_fn, loss_mask=_mask_of(batch),
                use_kernels=use_kernels, tp=_tp_of(batch),
                loss_weights=_weights_of(batch), seq_shard=shard)
            if cfg.n_experts > 0:
                loss = loss + cfg.moe_aux_coef * aux
            return loss
        tp = _tp_of(batch)
        if tp is not None and loss_tiles > 1:
            raise later_slice(f"loss_tiles={loss_tiles} under mesh "
                              f"tensor={tp.size} (queue A.4)")
        hidden, head, aux = T.forward_hidden(params, tokens, cfg,
                                             attention_fn=attention_fn,
                                             use_kernels=use_kernels,
                                             seq_shard=shard, tp=tp)
        mask = _mask_of(batch)
        if loss_tiles > 1:
            from deepspeed_tpu_torch.sequence.tiled import tiled_lm_loss

            loss = tiled_lm_loss(hidden, head, tokens, mask,
                                 num_tiles=loss_tiles, seq_shard=shard)
        elif loss_impl == "fused":
            loss = T.fused_lm_loss(hidden, head, tokens, mask, shard, tp)
        else:
            logits = T.lm_logits(hidden, head, tp)
            loss = T.causal_lm_loss(logits, tokens, mask, shard)
        if cfg.n_experts > 0:
            loss = loss + cfg.moe_aux_coef * aux
        return loss

    def apply_fn(params, batch):
        return T.forward(params, _tokens_of(batch), cfg,
                         attention_fn=attention_fn, use_kernels=use_kernels,
                         seq_shard=_seq_shard_of(batch), tp=_tp_of(batch))

    def loss_and_grads_fn(params, batch, loss_scale=None):
        pp = _pp_of(batch)
        if pipeline_schedule != "1f1b" or pp is None:
            return None     # the engine differentiates loss_fn
        shard = _seq_shard_of(batch)
        _check_seq(shard)
        _check_pipe(pp)
        return T.pipelined_lm_loss_and_grads(
            params, _tokens_of(batch), cfg, pp,
            n_micro=pipeline_micro_batches, attention_fn=attention_fn,
            loss_mask=_mask_of(batch), loss_scale=loss_scale,
            use_kernels=use_kernels, tp=_tp_of(batch),
            loss_weights=_weights_of(batch), seq_shard=shard)

    def init_fn(generator: Optional[torch.Generator] = None, device=None):
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        return T.init_params(cfg, generator, dev)

    user_attention_fn = attention_fn is not None and attention is None

    orig_attention, orig_loss_tiles = attention, loss_tiles

    def _rebuild(attention: Optional[str] = None, loss_tiles: int = 0,
                 remat: Optional[str] = None) -> ModelSpec:
        # JAX's rule: the stronger loss tiling of (original, requested);
        # an unspecified attention keeps the original one. Both pipeline
        # arguments are kept: JAX's _rebuild (api.py:253-259) drops
        # pipeline_micro_batches, so a spec rebuilt for
        # activation_checkpointing.policy falls back to M = P there
        # (ROADMAP queue C)
        cfg2 = dataclasses.replace(cfg, remat=remat) if remat else cfg
        return causal_lm_spec(cfg2, attention=attention or orig_attention,
                              loss_tiles=max(loss_tiles, orig_loss_tiles),
                              loss_impl=loss_impl, use_kernels=use_kernels,
                              pipeline_schedule=pipeline_schedule,
                              pipeline_micro_batches=pipeline_micro_batches)

    return ModelSpec(init_fn=init_fn, loss_fn=loss_fn, apply_fn=apply_fn,
                     name=name, num_params=cfg.num_params(),
                     seq_len=cfg.max_seq_len, config=cfg,
                     builder=None if user_attention_fn else _rebuild,
                     axes_fn=lambda: T.param_logical_axes(cfg),
                     attention=attention,
                     loss_and_grads_fn=loss_and_grads_fn,
                     pipeline_micro_batches=pipeline_micro_batches)
