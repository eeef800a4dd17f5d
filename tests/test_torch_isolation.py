"""The PyTorch port stands alone and never falls back silently.

* Importing every module of ``deepspeed_tpu_torch`` (the MoE modules, the
  grouped GEMM, ``comm/``, ``parallel/``, the int8 wire's kernels,
  ``checkpoint/`` and ``sequence/`` among them) and ``chip_smoke.py`` imports neither jax
  nor anything of ``deepspeed_tpu``, nor ``ml_dtypes`` or ``orbax``, which
  the card's machine does not have.
* A process that never imports jax writes and reads bf16 and fp16
  checkpoints and the 16-bit export (numpy has no bf16 there).
* Without a CUDA device, entry points that default to the GPU raise; with
  one, they land on it. Whether a card is present is decided inside each
  test, never at import or collection time.
"""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from deepspeed_tpu_torch.accelerator import (
    device_count,
    memory_stats,
    resolve_device,
    synchronize,
)
from deepspeed_tpu_torch.inference.fastgen import FastGenEngine
from deepspeed_tpu_torch.models import paged as PPG
from deepspeed_tpu_torch.models import transformer as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package():
    code = textwrap.dedent("""
        import importlib, importlib.util, pkgutil, sys
        import deepspeed_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      "chip_smoke.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "deepspeed_tpu",
                                            "ml_dtypes", "orbax"))
        print(len(names), ",".join(names), bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, names, bad = out.stdout.strip().split(" ", 2)
    assert int(n) >= 44, out.stdout          # every module was walked
    for mod in ("moe.gating", "moe.layer", "ops.grouped_gemm", "comm.comm",
                "comm.mesh", "parallel.partitioning", "parallel.compressed",
                "ops.quantization", "ops.quant_kernels", "ops.aio",
                "runtime.swap_tensor", "runtime.zenflow",
                "runtime.host_step", "checkpoint.fault_tolerance",
                "checkpoint.checkpoint_engine", "checkpoint.engine",
                "checkpoint.universal", "checkpoint.zero_to_fp32",
                "checkpoint.reshard_cli", "sequence", "sequence.ulysses",
                "sequence.ring", "sequence.tiled", "sequence.auto_sp"):
        assert f"deepspeed_tpu_torch.{mod}" in names.split(","), mod
    assert bad == "[]", bad


def test_default_device_is_the_gpu_or_an_error():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FastGenEngine("tiny")
    assert device_count() == 0


def test_model_constructors_default_to_the_gpu_or_an_error():
    """``init_params`` and ``init_paged_kv`` resolve ``device=None`` as the
    engine does: the first card, or an error — never the CPU."""
    cfg = PT.get_model_config("tiny")
    if torch.cuda.is_available():
        gen = torch.Generator("cuda").manual_seed(0)
        assert PT.init_params(cfg, gen)["tok_emb"].device.type == "cuda"
        assert PPG.init_paged_kv(cfg, 4, 8)["k"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPG.init_paged_kv(cfg, 4, 8)
    assert PPG.init_paged_kv(cfg, 4, 8, device="cpu")["v"].device.type \
        == "cpu"


def test_training_entry_points_default_to_the_gpu_or_an_error():
    """``initialize``, the engine and a spec's ``init_fn`` resolve
    ``device=None`` to the first card, or raise — training never runs on
    the CPU unasked."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedTPUEngine

    spec = dtt.causal_lm_spec("tiny", dtype="float32")
    config = {"train_micro_batch_size_per_gpu": 2,
              "optimizer": {"type": "adam", "params": {"lr": 1e-3}}}
    if torch.cuda.is_available():
        engine, *_ = dtt.initialize(model=spec, config=config)
        assert engine.flat_master.device.type == "cuda"
        assert spec.init_fn()["tok_emb"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dtt.initialize(model=spec, config=config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeepSpeedTPUEngine(spec, config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.init_fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.rope_table(16, 8, 10000.0)
    engine, *_ = dtt.initialize(model=spec, config=config, device="cpu")
    assert engine.flat_master.device.type == "cpu"


def test_cpu_device_is_reached_only_by_asking():
    dev = resolve_device("cpu")
    assert dev == torch.device("cpu")
    synchronize("cpu")
    assert memory_stats("cpu") == {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                                   "bytes_limit": 0}
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory (no package beside it) it exits non-zero and
    prints no result; in the checkout without a card, likewise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is for "
                    "machines without one")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    for cwd, script in ((tmp_path, str(lone)), (REPO, "chip_smoke.py")):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_importing_builds_nothing(tmp_path):
    """Importing every module (the NVMe tier's ``ops/aio.py`` over
    ``ops/csrc/aio.cpp`` among them) compiles and loads no library: the
    host library is built at its first use, as the kernels are."""
    code = textwrap.dedent("""
        import importlib, os, pkgutil
        import deepspeed_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from deepspeed_tpu_torch.ops import build
        print(len(build._libs), sorted(os.listdir(os.environ[
            "DSTPU_TORCH_BUILD_DIR"])) if os.path.isdir(os.environ[
            "DSTPU_TORCH_BUILD_DIR"]) else [])
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["DSTPU_TORCH_BUILD_DIR"] = str(tmp_path / "build")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []", out.stdout


def test_bf16_and_fp16_checkpoints_without_jax(tmp_path):
    """In a process that never imports jax (so numpy knows no bf16): a bf16
    and an fp16 engine save, a fresh engine of each loads and continues
    bit-equal, and the 16-bit export reads back as the compute dtype."""
    code = textwrap.dedent("""
        import sys
        import torch
        import deepspeed_tpu_torch as dtt
        from deepspeed_tpu_torch.checkpoint.engine import load_16bit_model
        from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

        root = sys.argv[1]
        for prec, extra in (("bfloat16", {"bf16": {"enabled": True}}),
                            ("float16", {"fp16": {
                                "enabled": True,
                                "initial_scale_power": 8}})):
            cfg = dict({"train_micro_batch_size_per_gpu": 2,
                        "optimizer": {"type": "adam",
                                      "params": {"lr": 1e-3}},
                        "steps_per_print": 10 ** 6}, **extra)

            def build(seed):
                return dtt.initialize(
                    model=dtt.causal_lm_spec("tiny", dtype=prec),
                    config=dict(cfg, seed=seed), device="cpu")[0]

            e = build(1)
            data = synthetic_lm_data(2, 16, 512, seed=1)
            e.train_batch(data)
            e.save_checkpoint(f"{root}/{prec}")
            e.save_16bit_model(f"{root}/{prec}_16")
            want = [float(e.train_batch(data)) for _ in range(2)]
            f = build(2)
            f.load_checkpoint(f"{root}/{prec}")
            data = synthetic_lm_data(2, 16, 512, seed=1)
            next(data)
            got = [float(f.train_batch(data)) for _ in range(2)]
            assert got == want, (prec, got, want)
            assert torch.equal(f.flat_compute, e.flat_compute), prec
            flat = load_16bit_model(f"{root}/{prec}_16")
            assert flat["tok_emb"].dtype == getattr(torch, prec), prec
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "deepspeed_tpu",
                                            "ml_dtypes", "orbax"))
        print("ok", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok []", out.stdout
