"""Checkpoints of the PyTorch port against the JAX package, and its fault
tolerance.

The on-disk format is the JAX package's ``writer="fast"`` tag layout, so
each package reads the other's tags with no conversion step.

* JAX → port: one JAX engine (engine A: one process on the 8-device CPU
  mesh, tiny, fp32, ``checkpoint.writer`` fast) trains steps 1-2, saves,
  trains steps 3-4. The port loads A's tag into an engine built from
  another seed and trains steps 3-4: losses and master within
  ``test_torch_train.TOL["float32"]`` of A's, the lr schedule and the
  step counters A's.
* Port → JAX: the port trains steps 1-2 from A's initial master and saves;
  A loads that tag (its compiled step, no new compile) and trains step 3:
  its loss within TOL of the port's step 3. The two tags' manifests have
  the same leaf names, shapes and dtypes, and a tag committed by either
  package passes the other's ``verify_tag``. The bf16 and fp16 engines'
  state names, shapes and dtypes equal JAX's (engine init only: the fp16
  scaler's ``scaler/.scale``, ``.good_steps``, ``.hysteresis`` and
  ``skips``), and each package reads the other's 16-bit export.
* A native tag that lacks a leaf of the engine's state raises
  ``KeyError`` in both packages, also under ``load_optimizer_states=False``:
  engine A's fp32 tag loaded into an fp16 engine (``scaler/.scale``), a
  tag written without its ``opt/*`` leaves.
* Port ↔ port on gloo CPU ranks: at world 2 ZeRO-2 exact, ZeRO-3 with
  qgZ + qwZ + LoCo (its save async) and ``tiny_moe`` at ``{expert: 2}``;
  at world 4 hpZ at (data 2, zshard 2) with qgZ + qwZ + LoCo, and
  ``tiny_moe`` at ``{data: 2, expert: 2}`` under ZeRO-3 and under ZeRO-2
  with qgZ + qwZ + LoCo (its residual's expert leaves in JAX's layout). Each case
  trains 2 steps, saves, trains 2 more; a fresh engine from another seed
  loads the tag and trains the same 2: losses, each rank's master and
  moment shards and its LoCo rows bit-equal. Each world's cases run in one
  spawn, the ranks building the engines in turn.
* Fault tolerance: walk-back over a corrupt and a torn head,
  ``CheckpointCorruptError`` on a named bad tag; ``keep_n`` with a
  protected tag; an async save committed by its thread while steps run;
  a deferred preemption signal; a subprocess that gets SIGTERM after step
  k exits 0 with a committed ``emergency_step<k>`` tag, and its rerun
  with ``auto_resume`` restores step k and gives the uninterrupted run's
  next losses bit for bit.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_zero import _leaves, _spawn

SEQ, VOCAB = 32, 512
JAX_MICRO, DP = 1, 8           # the CPU mesh of tests/conftest.py
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny models on one intra-op thread: beside the suite's other
    workers a multi-threaded pool only oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(micro, precision="float32", writer=None, zero=None, **extra):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-2, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 4,
                                    "warmup_max_lr": 1e-2,
                                    "warmup_type": "linear"}},
           "gradient_clipping": 0.5,
           "zero_optimization": zero or {"stage": 1},
           "steps_per_print": 10 ** 6}
    if writer:
        cfg["checkpoint"] = {"writer": writer}
    if precision == "bfloat16":
        cfg["bf16"] = {"enabled": True}
    elif precision == "float16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 12,
                       "loss_scale_window": 2}
    cfg.update(extra)
    return cfg


def _port_engine(master0=None, precision="float32", seed=None, **kw):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import load_master

    cfg = _config(JAX_MICRO * DP, precision, **kw)
    if seed is not None:
        cfg["seed"] = seed
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec("tiny", dtype=precision), config=cfg,
        device="cpu")
    if master0 is not None:
        load_master(engine, master0)
    return engine


def _data(skip_steps=0, rows=JAX_MICRO * DP):
    from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

    data = synthetic_lm_data(rows, SEQ, VOCAB, seed=3)
    for _ in range(2 * skip_steps):            # gas 2
        next(data)
    return data


@pytest.fixture(scope="module")
def jax_a(tmp_path_factory):
    """Engine A, and everything JAX does with the port's tags: steps 1-2,
    a fast save, steps 3-4; the port's steps 1-2 from A's initial master
    and its save; A restored from the port's tag and its step 3."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.checkpoint import fault_tolerance as JFT
    from deepspeed_tpu.comm import mesh as mesh_mod
    from deepspeed_tpu.runtime.dataloader import synthetic_lm_data as jdata

    root = tmp_path_factory.mktemp("ckpt_a")
    mesh_mod.reset_mesh()
    engine, *_ = dst.initialize(
        model=dst.causal_lm_spec("tiny", dtype="float32"),
        config=_config(JAX_MICRO, writer="fast"))
    assert engine.dp_world_size == DP
    master0 = jax.tree.map(np.asarray, engine.state["master"])
    data = jdata(JAX_MICRO * DP, SEQ, VOCAB, seed=3)
    losses = [float(engine.train_batch(data)) for _ in range(2)]
    lr2 = engine.get_lr()
    engine.save_checkpoint(str(root / "jax"))
    losses += [float(engine.train_batch(data)) for _ in range(2)]
    out = {"root": root, "master0": master0, "losses": losses, "lr2": lr2,
           "master4": jax.tree.map(np.asarray, engine.state["master"])}

    port = _port_engine(master0)
    pdata = _data()
    plosses = [float(port.train_batch(pdata)) for _ in range(2)]
    port.save_checkpoint(str(root / "port"))
    plosses.append(float(port.train_batch(pdata)))
    out["port_losses"] = plosses

    engine.load_checkpoint(str(root / "port"))
    out["jax_from_port_steps"] = engine.global_steps
    jd = jdata(JAX_MICRO * DP, SEQ, VOCAB, seed=3)
    for _ in range(4):
        next(jd)
    out["jax_from_port_loss"] = float(engine.train_batch(jd))
    out["jax_verify_port"] = JFT.verify_tag(str(root / "port"),
                                            "global_step2")
    mesh_mod.reset_mesh()
    return out


def test_port_resumes_a_jax_fast_checkpoint(jax_a):
    from test_torch_train import TOL

    tol = TOL["float32"]
    engine = _port_engine(seed=99)
    engine.load_checkpoint(str(jax_a["root"] / "jax"))
    assert engine.global_steps == 2 and engine.micro_steps == 4
    assert engine.state["step"] == 2 and engine.state["opt"]["step"] == 2
    np.testing.assert_allclose(engine.get_lr(), jax_a["lr2"], rtol=4e-6)
    data = _data(skip_steps=2)
    losses = [float(engine.train_batch(data)) for _ in range(2)]
    np.testing.assert_allclose(losses, jax_a["losses"][2:],
                               rtol=tol["loss"], atol=0)
    got = dict(_leaves(engine.get_fp32_params()))
    want = dict(_leaves(jax_a["master4"]))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=tol["master"],
                                   err_msg=key)


def test_jax_resumes_a_port_checkpoint(jax_a):
    from test_torch_train import TOL

    assert jax_a["jax_from_port_steps"] == 2
    np.testing.assert_allclose(jax_a["jax_from_port_loss"],
                               jax_a["port_losses"][2],
                               rtol=TOL["float32"]["loss"], atol=0)


def test_tags_verify_under_both_packages_and_manifests_agree(jax_a):
    from deepspeed_tpu_torch.checkpoint import fault_tolerance as PFT

    root = jax_a["root"]
    assert jax_a["jax_verify_port"] == (True, "ok")
    assert PFT.verify_tag(str(root / "jax"), "global_step2") == (True, "ok")
    man = {}
    for who in ("jax", "port"):
        tag = root / who / "global_step2"
        with open(tag / "state_fast" / "manifest.json") as f:
            man[who] = json.load(f)
        with open(tag / "client_state.json") as f:
            cs = json.load(f)
        assert cs["global_steps"] == 2 and cs["world_size"] in (1, DP)
        assert cs["lr_scheduler"] == {"last_batch_iteration": 2}
        assert cs["np_rng"]["bit_generator"] == "PCG64"
    assert man["jax"] == man["port"]
    # JAX's writer stores a 0-d leaf as [1]
    assert man["port"]["step"] == {"shape": [1], "dtype": "int32",
                                   "file": "step.bin"}


def _port_state_manifest(engine):
    return {name: {"shape": list(t.shape),
                   "dtype": str(t.numpy().dtype) if t.dtype != torch.bfloat16
                   else "bfloat16"}
            for name, t in engine._checkpoint_leaves()}


@pytest.mark.parametrize("precision", ["bfloat16", "float16"])
def test_low_precision_state_names_match_jax(precision, tmp_path):
    """Engine init only: the state's leaf names, shapes and dtypes equal
    JAX's ``_checkpoint_state`` flattened as its fast writer names it; each
    package reads the other's 16-bit export bit for bit."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.checkpoint.checkpoint_engine import _flatten_with_paths
    from deepspeed_tpu.checkpoint.engine import load_16bit_model as jload
    from deepspeed_tpu.comm import mesh as mesh_mod

    from deepspeed_tpu_torch.checkpoint.checkpoint_engine import (
        flatten_with_paths,
    )
    from deepspeed_tpu_torch.checkpoint.engine import load_16bit_model

    mesh_mod.reset_mesh()
    jeng, *_ = dst.initialize(model=dst.causal_lm_spec("tiny",
                                                       dtype=precision),
                              config=_config(JAX_MICRO, precision))
    want = {name: {"shape": list(np.shape(leaf)),
                   "dtype": str(np.asarray(jax.device_get(leaf)).dtype)}
            for name, leaf in _flatten_with_paths(jeng._checkpoint_state())}
    master0 = jax.tree.map(np.asarray, jeng.state["master"])
    engine = _port_engine(master0, precision)
    got = _port_state_manifest(engine)
    assert got == want
    if precision == "float16":
        assert {"scaler/.scale", "scaler/.good_steps", "scaler/.hysteresis",
                "skips"} <= set(got)
    jeng.save_16bit_model(str(tmp_path / "jax"))
    engine.save_16bit_model(str(tmp_path / "port"))
    mesh_mod.reset_mesh()
    mine = load_16bit_model(str(tmp_path / "jax"))
    theirs = jload(str(tmp_path / "port"))
    for key, t in flatten_with_paths(engine.get_fp32_params()):
        cast = t.to(engine.compute_dtype)
        assert mine[key].dtype == cast.dtype and torch.equal(mine[key], cast)
        assert str(theirs[key].dtype) == precision
        assert np.array_equal(theirs[key].view(np.uint16),
                              cast.view(torch.int16).numpy().view(np.uint16))


def _jax_engine(precision):
    import deepspeed_tpu as dst
    from deepspeed_tpu.comm import mesh as mesh_mod

    mesh_mod.reset_mesh()
    engine, *_ = dst.initialize(
        model=dst.causal_lm_spec("tiny", dtype=precision),
        config=_config(JAX_MICRO, precision, writer="fast"))
    return engine


def test_fp32_tag_into_fp16_engine_raises_in_both_packages(jax_a):
    """A native load takes every leaf of the engine's state from the tag
    (JAX's ``_unflatten_like``): engine A's fp32 tag holds no fp16 scaler,
    so an fp16 engine's load raises ``KeyError`` naming ``scaler/.scale``
    in both packages, also without the optimizer states; the port's own
    fp16 tag loads."""
    from deepspeed_tpu.comm import mesh as mesh_mod

    tag = str(jax_a["root"] / "jax")
    jeng = _jax_engine("float16")
    try:
        with pytest.raises(KeyError, match="scaler/.scale"):
            jeng.load_checkpoint(tag)
    finally:
        mesh_mod.reset_mesh()
    engine = _port_engine(jax_a["master0"], "float16")
    for opt in (True, False):
        with pytest.raises(KeyError, match="scaler/.scale"):
            engine.load_checkpoint(tag, load_optimizer_states=opt)
    assert engine._scaler_state.scale == 2.0 ** 12      # left as it was
    root = str(jax_a["root"] / "port_fp16")
    engine.save_checkpoint(root)
    _port_engine(precision="float16", seed=5).load_checkpoint(root)


def test_tag_without_opt_raises_without_optimizer_states(jax_a, tmp_path):
    """A committed tag whose optimizer leaves are gone: the native load
    raises ``KeyError`` for the first ``opt/*`` leaf under
    ``load_optimizer_states=False`` too, in both packages (JAX reads the
    whole state tree, then puts the live moments back)."""
    from deepspeed_tpu.comm import mesh as mesh_mod

    from deepspeed_tpu_torch.checkpoint.engine import save_state

    engine = _port_engine(jax_a["master0"])
    save_state(str(tmp_path), "no_opt",
               ((n, t) for n, t in engine._checkpoint_leaves()
                if not n.startswith("opt/")), engine._client_state())
    tag = str(tmp_path)
    for opt in (True, False):
        with pytest.raises(KeyError, match="opt/"):
            engine.load_checkpoint(tag, load_optimizer_states=opt)
    jeng = _jax_engine("float32")
    try:
        with pytest.raises(KeyError, match="opt"):
            jeng.load_checkpoint(tag, load_optimizer_states=False)
    finally:
        mesh_mod.reset_mesh()


# --------------------------------------------------------------------------- #
# port ↔ port at world 2 and 4 (gloo CPU ranks)
# --------------------------------------------------------------------------- #

WORLD_CASES = {
    2: {"zero2_exact": ("tiny", {"stage": 2}, None, False),
        "zero3_qgz_qwz_loco": ("tiny", {"stage": 3,
                                        "zero_quantized_gradients": True,
                                        "zero_quantized_weights": True,
                                        "loco_error_feedback": True},
                               None, True),
        "moe_ep2": ("tiny_moe", {"stage": 2}, {"expert": 2}, False)},
    4: {"hpz_qgz_qwz_loco": ("tiny", {"stage": 3,
                                      "zero_hpz_partition_size": 2,
                                      "zero_quantized_gradients": True,
                                      "zero_quantized_weights": True,
                                      "loco_error_feedback": True},
                             None, False),
        "moe_d2e2_zero3": ("tiny_moe", {"stage": 3},
                           {"data": 2, "expert": 2}, False),
        "moe_d2e2_qgz_qwz_loco": ("tiny_moe", {
            "stage": 2, "zero_quantized_gradients": True,
            "zero_quantized_weights": True, "loco_error_feedback": True},
            {"data": 2, "expert": 2}, False)},
}


def _local_state(engine):
    st = {"master": engine.flat_master.clone(),
          "step": (engine.state["step"], engine.state["opt"]["step"],
                   engine.global_steps, engine.micro_steps)}
    for k in engine._opt_names():
        st[k] = engine.state["opt"][k].clone()
    if engine.loco_err is not None:
        st["loco_err"] = engine.loco_err.clone()
    return st


def _native_rank(rank, world, root):
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.checkpoint.engine import finalize_async

    out = {}
    for name, (model, zero, mesh, async_save) in WORLD_CASES[world].items():
        def build(seed):
            cfg = _config(2, zero=dict(zero), seed=seed)
            if mesh:
                cfg["mesh"] = dict(mesh)
            engine, *_ = dtt.initialize(
                model=dtt.causal_lm_spec(model, dtype="float32"),
                config=cfg, device="cpu")
            return engine

        engine = build(1234)
        data = _data(rows=2 * world)
        for _ in range(2):
            engine.train_batch(data)
        d = os.path.join(root, name)
        engine.save_checkpoint(d, async_save=async_save)
        losses = [float(engine.train_batch(data)) for _ in range(2)]
        if async_save:
            finalize_async()
        want = _local_state(engine)
        engine.close()
        fresh = build(99)
        fresh.load_checkpoint(d)
        assert fresh.global_steps == 2
        data = _data(skip_steps=2, rows=2 * world)
        got = [float(fresh.train_batch(data)) for _ in range(2)]
        mine = _local_state(fresh)
        out[name] = {"type": type(fresh).__name__, "losses": (losses, got),
                     "same": {k: (torch.equal(v, mine[k])
                                  if isinstance(v, torch.Tensor)
                                  else v == mine[k]) for k, v in want.items()},
                     "keys": sorted(want)}
        fresh.close()
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_native_reload_continues_bit_equal(world, tmp_path):
    ranks = _spawn(_native_rank, world, tmp_path, str(tmp_path / "ck"))
    for name, (model, zero, mesh, _) in WORLD_CASES[world].items():
        for r, res in enumerate(ranks):
            got = res[name]
            assert got["type"] == ("Zero3Engine" if zero["stage"] == 3
                                   else "DataParallelEngine"), name
            losses, resumed = got["losses"]
            assert losses == resumed, (name, r, losses, resumed)
            assert all(got["same"].values()), (name, r, got["same"])
            if "loco" in name:
                assert "loco_err" in got["keys"]
        assert ranks[0][name]["losses"] == ranks[-1][name]["losses"]
        assert os.path.isfile(tmp_path / "ck" / name / "global_step2" /
                              "COMMITTED")


# --------------------------------------------------------------------------- #
# fault tolerance
# --------------------------------------------------------------------------- #

def _trained(tmp_path, steps, **kw):
    engine = _port_engine(**kw)
    data = _data()
    for _ in range(steps):
        engine.train_batch(data)
    return engine


def test_walk_back_over_corrupt_and_torn_heads(tmp_path, caplog):
    from deepspeed_tpu_torch.checkpoint import CheckpointCorruptError
    from deepspeed_tpu_torch.checkpoint import fault_tolerance as PFT

    d = str(tmp_path / "ck")
    engine = _trained(tmp_path, 1)
    engine.save_checkpoint(d)
    want = engine.flat_master.clone()
    data = _data(skip_steps=1)
    engine.train_batch(data)
    engine.save_checkpoint(d)
    # flip a byte of the head's master: its CRC no longer matches
    leaf = os.path.join(d, "global_step2", "state_fast",
                        "master__tok_emb.bin")
    with open(leaf, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    ok, why = PFT.verify_tag(d, "global_step2")
    assert not ok and "checksum" in why
    fresh = _port_engine(seed=7)
    with pytest.raises(CheckpointCorruptError, match="global_step2"):
        fresh.load_checkpoint(d, tag="global_step2")
    fresh.load_checkpoint(d)           # walks back to global_step1
    assert fresh.global_steps == 1 and torch.equal(fresh.flat_master, want)
    # a torn head: a tag without its marker is never a restore candidate
    engine.save_checkpoint(d, tag="global_step3")
    os.remove(os.path.join(d, "global_step3", "COMMITTED"))
    assert PFT.find_restore_tag(d) == "global_step1"
    assert PFT.committed_tags(d) == ["global_step2", "global_step1"]


def test_keep_n_spares_a_protected_tag(tmp_path):
    from deepspeed_tpu_torch.checkpoint import fault_tolerance as PFT

    d = str(tmp_path / "ck")
    engine = _trained(tmp_path, 0, checkpoint={"keep_n": 1})
    data = _data()
    engine.train_batch(data)
    engine.save_checkpoint(d)                    # global_step1
    engine.protect_checkpoint_tag("global_step1", d)
    engine.train_batch(data)
    engine.save_checkpoint(d)
    # keep_n 1 spared the pinned tag; the newer commit then cleared the pin
    assert PFT.committed_tags(d) == ["global_step2", "global_step1"]
    assert not engine._gc_protect_tags
    engine.train_batch(data)
    engine.save_checkpoint(d)
    assert PFT.committed_tags(d) == ["global_step3"]


def test_async_save_commits_while_steps_run(tmp_path):
    from deepspeed_tpu_torch.checkpoint import fault_tolerance as PFT
    from deepspeed_tpu_torch.checkpoint.engine import finalize_async

    d = str(tmp_path / "ck")
    engine = _trained(tmp_path, 2)
    want = (engine.flat_master.clone(),
            engine.state["opt"]["exp_avg"].clone())
    engine.save_checkpoint(d, async_save=True)
    data = _data(skip_steps=2)
    engine.train_batch(data)                 # updates the buffers in place
    finalize_async()
    assert PFT.verify_tag(d, "global_step2") == (True, "ok")
    with open(os.path.join(d, "latest")) as f:
        assert f.read() == "global_step2"
    fresh = _port_engine(seed=5)
    fresh.load_checkpoint(d)
    assert torch.equal(fresh.flat_master, want[0])
    assert torch.equal(fresh.state["opt"]["exp_avg"], want[1])


def test_preemption_defers_to_the_step_boundary(tmp_path):
    import signal

    from deepspeed_tpu_torch.checkpoint import fault_tolerance as PFT

    d = str(tmp_path / "resume")
    engine = _trained(tmp_path, 1, fault_tolerance={"resume_dir": d})
    engine._in_step = True
    engine._on_preempt_signal(signal.SIGTERM, None)     # mid-step: deferred
    assert engine.preemption_requested() and not os.path.exists(d)
    engine._in_step = False
    with pytest.raises(SystemExit) as exit_:
        engine._check_preemption_boundary()
    assert exit_.value.code == 0
    assert PFT.verify_tag(d, "emergency_step1") == (True, "ok")


SIGTERM_SCRIPT = textwrap.dedent("""
    import json, os, signal, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

    config = json.loads({config!r})
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec("tiny", dtype="float32"), config=config,
        device="cpu")
    print("start", engine.global_steps, flush=True)
    data = synthetic_lm_data(8, 32, 512, seed=3)
    for _ in range(2 * engine.global_steps):
        next(data)
    kill_after = int(sys.argv[1])
    while engine.global_steps < {steps}:
        loss = float(engine.train_batch(data))
        print("loss", engine.global_steps, loss.hex(), flush=True)
        if engine.global_steps == kill_after:
            os.kill(os.getpid(), signal.SIGTERM)
    print("done", flush=True)
""")


def test_sigterm_saves_and_auto_resume_continues_bit_equal(tmp_path):
    """A process that gets SIGTERM after step k exits 0 with a committed
    ``emergency_step<k>`` tag; its rerun with ``auto_resume`` restores step
    k and gives the uninterrupted run's next losses bit for bit."""
    from deepspeed_tpu_torch.checkpoint import fault_tolerance as PFT

    k, steps = 2, 4
    d = str(tmp_path / "resume")
    config = _config(JAX_MICRO * DP, fault_tolerance={
        "resume_dir": d, "auto_resume": True})
    script = tmp_path / "train.py"
    script.write_text(SIGTERM_SCRIPT.format(repo=REPO, steps=steps,
                                            config=json.dumps(config)))
    env = {kk: v for kk, v in os.environ.items() if kk != "PYTHONPATH"}

    def run(kill_after):
        out = subprocess.run([sys.executable, str(script), str(kill_after)],
                             cwd=str(tmp_path), env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        lines = [ln.split() for ln in out.stdout.splitlines()]
        losses = {int(ln[1]): float.fromhex(ln[2]) for ln in lines
                  if ln[0] == "loss"}
        return lines, losses

    lines, first = run(k)
    assert ["start", "0"] in lines and ["done"] not in lines
    assert sorted(first) == [1, 2]
    assert PFT.verify_tag(d, f"emergency_step{k}") == (True, "ok")
    lines, second = run(-1)
    assert ["start", str(k)] in lines and ["done"] in lines
    assert sorted(second) == [3, 4]
    engine = _port_engine()         # one thread, as the subprocesses
    data = _data()
    whole = [float(engine.train_batch(data)) for _ in range(steps)]
    assert [first[1], first[2], second[3], second[4]] == whole


def test_writers_and_the_decoupled_close(tmp_path):
    """Every writer name writes the per-leaf layout; the decoupled writer
    saves in its thread, and its best-effort close swallows (and counts) a
    failed queued save instead of masking the caller's error."""
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.checkpoint import checkpoint_engine as CKE

    leaves = {"a": torch.arange(6, dtype=torch.float32).view(2, 3),
              "b": {"c": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)}}
    for name in ("orbax", "fast", "torch"):
        eng = CKE.get_checkpoint_engine(name)
        assert isinstance(eng, CKE.FastCheckpointEngine)
    eng = CKE.get_checkpoint_engine("decoupled")
    eng.save(CKE.flatten_with_paths(leaves), str(tmp_path / "d"))
    got = eng.load(str(tmp_path / "d"))
    assert torch.equal(got["a"], leaves["a"])
    assert torch.equal(got["b/c"], leaves["b"]["c"])
    with open(tmp_path / "d" / "manifest.json") as f:
        assert json.load(f)["b/c"] == {"shape": [2], "dtype": "bfloat16",
                                       "file": "b__c.bin"}
    (tmp_path / "file").write_text("")
    eng.save([("x", torch.zeros(4))], str(tmp_path / "file" / "sub"))
    before = telemetry.counter("checkpoint_close_errors_total").total()
    eng.close()
    eng.close()                       # idempotent
    assert telemetry.counter(
        "checkpoint_close_errors_total").total() == before + 1
    with pytest.raises(ValueError, match="unknown checkpoint engine"):
        CKE.get_checkpoint_engine("nope")


@pytest.mark.parametrize("section,value", [
    ("checkpoint", {"writer": "bogus"}),
    ("checkpoint", {"keep_n": 2, "fsync": False, "writer": "fast"}),
    ("fault_tolerance", {"on_stall": "bogus"}),
    ("fault_tolerance", {"resume_dir": "/x", "auto_resume": False}),
])
def test_checkpoint_config_sections_match_jax(section, value, monkeypatch):
    """The sections are read as JAX reads them: the same values, the same
    errors, the environment defaults (an explicit false wins)."""
    from deepspeed_tpu.runtime import config as JC

    from deepspeed_tpu_torch.runtime import config as PC

    monkeypatch.setenv("DSTPU_RESUME_DIR", "/from/env")
    monkeypatch.setenv("DSTPU_AUTO_RESUME", "1")
    cfg = {"train_micro_batch_size_per_gpu": 1, section: value}

    def load(mod):
        try:
            c = mod.load_config(dict(cfg))
        except mod.DeepSpeedConfigError as e:
            return "error", str(e)
        return (c.effective_checkpoint_writer, c.checkpoint.keep_n,
                c.checkpoint.fsync, c.fault_tolerance.resume_dir,
                c.fault_tolerance.auto_resume)

    assert load(PC) == load(JC)


def test_on_stall_escalation_is_a_later_slice():
    from deepspeed_tpu_torch.runtime import config as PC

    for on_stall in ("dump_trace", "checkpoint"):
        with pytest.raises(NotImplementedError, match="A.5"):
            PC.load_config({"train_micro_batch_size_per_gpu": 1,
                            "fault_tolerance": {"on_stall": on_stall}})
    cfg = PC.load_config({"train_micro_batch_size_per_gpu": 1,
                          "checkpoint_writer": "fast"})
    assert cfg.effective_checkpoint_writer == "fast"
