"""Mixture of experts (the JAX package's ``deepspeed_tpu/moe/``).

* :mod:`gating` — the index-form top-k gate of the dropless dispatch.
* :mod:`layer` — the dropless ragged dispatch on one process: counting
  sort, grouped GEMMs (``ops/grouped_gemm.py``), gather-only combine.

Model integration: ``n_experts > 0`` on a ``TransformerConfig`` (the
``tiny_moe`` and ``moe_350m`` presets).
"""
