"""The PyTorch port stands alone and never falls back silently.

* Importing every module of ``deepspeed_tpu_torch`` (the MoE modules and
  the grouped GEMM among them) and ``chip_smoke.py`` imports neither jax
  nor anything of ``deepspeed_tpu``.
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
                     if m == "jax" or m.startswith("jax.")
                     or m == "deepspeed_tpu" or m.startswith("deepspeed_tpu."))
        print(len(names), ",".join(names), bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, names, bad = out.stdout.strip().split(" ", 2)
    assert int(n) >= 31, out.stdout          # every module was walked
    for mod in ("moe.gating", "moe.layer", "ops.grouped_gemm"):
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
