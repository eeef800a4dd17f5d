"""Packaging for deepspeed_tpu (reference setup.py + bin/ console scripts).

The op-builder story differs from the reference by design: the only native
component built at install time is the aio library (csrc/aio), compiled
lazily on first use by ``deepspeed_tpu/ops/aio.py``; TPU kernels are Pallas
(no compilation step).
"""
from setuptools import find_packages, setup

setup(
    name="deepspeed_tpu",
    version="0.1.0",
    description="TPU-native distributed training & inference framework "
                "(DeepSpeed-compatible API on JAX/XLA/Pallas)",
    # deepspeed_tpu_torch: the PyTorch/CUDA port (its CUDA sources ship as
    # package data and build with nvcc at first use)
    packages=find_packages(include=["deepspeed_tpu", "deepspeed_tpu.*",
                                    "deepspeed_tpu_torch",
                                    "deepspeed_tpu_torch.*"]),
    # the committed compiled-program contracts hlolint/memlint enforce
    # (analysis/{hlolint,memlint}/contracts/*.json) ship with the package
    package_data={"deepspeed_tpu.analysis.hlolint": ["contracts/*.json"],
                  "deepspeed_tpu.analysis.memlint": ["contracts/*.json"],
                  "deepspeed_tpu.analysis.racelint": ["contracts/*.json",
                                                      "baseline.json"],
                  "deepspeed_tpu_torch.ops": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "orbax-checkpoint", "einops"],
    extras_require={
        "hf": ["transformers", "torch"],
        "monitor": ["tensorboardX", "wandb", "comet-ml"],
    },
    entry_points={
        "console_scripts": [
            "dstpu=deepspeed_tpu.launcher.runner:main",
            "dstpu_report=deepspeed_tpu.env_report:main",
            "dstpu_bench=deepspeed_tpu.utils.comm_bench:main",
            "dslint=deepspeed_tpu.analysis.__main__:main",
            "hlolint=deepspeed_tpu.analysis.hlolint.__main__:main",
            "memlint=deepspeed_tpu.analysis.memlint.__main__:main",
            "racelint=deepspeed_tpu.analysis.racelint.__main__:main",
            "trace-dump=deepspeed_tpu.telemetry.tracing:main",
            "bench-diff=deepspeed_tpu.bench.cli:main",
            "step-report=deepspeed_tpu.profiling.observatory.__main__:main",
            "fleet-report=deepspeed_tpu.serving.observatory.__main__:main",
            "plan=deepspeed_tpu.autotuning.__main__:main",
            "reshard=deepspeed_tpu.checkpoint.reshard_cli:main",
        ],
    },
    # tools/dslint + tools/bench-diff are checkout-only shims; the
    # matching console entry points cover installs (listing both would
    # collide on the bin/ names)
    scripts=["bin/dstpu", "bin/dstpu_report", "bin/dstpu_bench",
             "bin/dstpu_elastic", "bin/dstpu_io"],
)
