"""PyTorch/CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package beside this one is the reference: every module here mirrors
a module path there (``deepspeed_tpu_torch/inference/fastgen.py`` is the
counterpart of ``deepspeed_tpu/inference/fastgen.py``) and keeps its tensor
layouts at the public functions, so the parity tests feed both the same
numpy inputs. This package imports ``torch`` and never ``jax`` or anything
of ``deepspeed_tpu``.

Ported so far (the serving slice): FastGen continuous batching over the
paged KV pool (``inference/fastgen.py``, ``models/paged.py``) with the
model zoo subset it needs (``models/transformer.py``), and two kernels
written by hand for Hopper — paged attention in CUDA C++
(``ops/csrc/paged_attention.cu``) and RMSNorm/LayerNorm in Triton
(``ops/norms.py``).

Entry points run on the GPU unless the caller asks for the CPU
(``device="cpu"``); with no CUDA device and no explicit device they raise.
"""
from deepspeed_tpu_torch.accelerator import resolve_device

__all__ = ["resolve_device"]
