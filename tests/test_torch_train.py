"""The training slice of the PyTorch port against the JAX engine.

``initialize`` + ``train_batch`` of both packages on the same tokens from
the same weights (the JAX engine's fp32 master carried across with
``models/convert.load_master``): gas 2, gradient clipping, a WarmupLR
schedule, flash attention, remat "full". On the 8-device CPU mesh the JAX
global micro-batch is micro × 8, so the port's single process takes a micro
batch of 8 × the JAX micro: both see the same 8 sequences per micro-batch
and the same mean loss. Also: config parity (the same values and the same
errors), ``lr_at`` parity, and the ``NotImplementedError`` of every option
outside the slice (the multi-process path: ``tests/test_torch_zero.py``).
"""
import itertools

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu as dst
import deepspeed_tpu_torch as dtt
from deepspeed_tpu.runtime import config as JC
from deepspeed_tpu.runtime import lr_schedules as JL
from deepspeed_tpu.runtime.dataloader import synthetic_lm_data as jax_data
from deepspeed_tpu_torch.models.convert import load_master
from deepspeed_tpu_torch.runtime import config as PC
from deepspeed_tpu_torch.runtime import lr_schedules as PL
from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

SEQ = 32
STEPS = 3
JAX_MICRO = 1
DP = 8                     # the CPU mesh of tests/conftest.py
# fp32: the same arithmetic in another order (blockwise vs whole-row
# softmax, summation order of every product) through two layers and three
# Adam steps at lr 1e-2: losses within 2e-5 relative; the master within
# 1e-4 absolute, 1 % of the largest move of one Adam step (lr). Adam
# divides by sqrt(v) + eps, so an element whose gradient is near zero turns
# a last-digit difference of that gradient into a visible share of a step
# (measured: 3.8e-5 on one of 32,768 embedding entries). bf16: each side
# rounds activations and gradients to bf16 at other places: losses within
# 1e-2 relative; every master element within one Adam step (lr = 1e-2)
# and the mean absolute difference of every leaf within 2e-4 (2 % of a
# step) — a near-zero gradient's rounding noise can swing one element.
# fp16 (dynamic loss scaling): 3 more mantissa bits than bf16, so losses
# within 1e-3 and leaf means within 1e-4; the loss scale and the skipped
# steps must be equal.
TOL = {"float32": dict(loss=2e-5, master=1e-4, master_mean=1e-4),
       "bfloat16": dict(loss=1e-2, master=1e-2, master_mean=2e-4),
       "float16": dict(loss=1e-3, master=1e-2, master_mean=1e-4)}


def _config(precision, micro):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-2, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 4,
                                    "warmup_max_lr": 1e-2,
                                    "warmup_type": "linear"}},
           "gradient_clipping": 0.5,
           "zero_optimization": {"stage": 1},
           "steps_per_print": 10 ** 6}
    if precision == "bfloat16":
        cfg["bf16"] = {"enabled": True}
    elif precision == "float16":
        # dynamic loss scaling from 2^12 with a window of 2 steps: the
        # third step runs at the grown scale
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 12,
                       "loss_scale_window": 2}
    return cfg


CASES = {"tiny-fp32": ("tiny", "float32"),
         "tiny_llama-fp32": ("tiny_llama", "float32"),
         "tiny-bf16": ("tiny", "bfloat16"),
         "tiny_llama-fp16": ("tiny_llama", "float16")}


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's JAX engine run once per module: initial master, losses,
    final master (numpy)."""
    out = {}
    for case, (model, precision) in CASES.items():
        spec = dst.causal_lm_spec(model, attention="flash", remat="full",
                                  dtype=precision)
        engine, *_ = dst.initialize(model=spec,
                                    config=_config(precision, JAX_MICRO))
        assert engine.dp_world_size == DP
        master0 = jax.tree.map(np.asarray, engine.state["master"])
        data = jax_data(JAX_MICRO * DP, SEQ, 512, seed=3)
        losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
        out[case] = (master0, losses,
                     jax.tree.map(np.asarray, engine.state["master"]),
                     engine.get_global_grad_norm(),
                     (engine.loss_scale, engine.skipped_steps))
    return out


def _port(case, master0):
    model, precision = CASES[case]
    spec = dtt.causal_lm_spec(model, attention="flash", remat="full",
                              dtype=precision)
    engine, opt, loader, sched = dtt.initialize(
        model=spec, config=_config(precision, JAX_MICRO * DP), device="cpu")
    assert loader is None and opt is engine.optimizer
    assert sched is engine.lr_scheduler is not None
    load_master(engine, master0)
    return engine


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


@pytest.mark.parametrize("case", list(CASES))
def test_train_batch_matches_jax_engine(case, jax_runs):
    master0, jlosses, jmaster, jnorm, (jscale, jskips) = jax_runs[case]
    engine = _port(case, master0)
    data = synthetic_lm_data(JAX_MICRO * DP, SEQ, 512, seed=3)
    losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
    tol = TOL[CASES[case][1]]
    np.testing.assert_allclose(losses, jlosses, rtol=tol["loss"], atol=0)
    assert losses[-1] < losses[0]
    assert engine.global_steps == STEPS and engine.micro_steps == 2 * STEPS
    assert engine.state["opt"]["step"] == STEPS - jskips
    assert (engine.loss_scale, engine.skipped_steps) == (jscale, jskips)
    np.testing.assert_allclose(engine.get_global_grad_norm(), jnorm,
                               rtol=10 * tol["loss"])
    got = dict(_flat({k: v for k, v in engine.state["master"].items()}))
    want = dict(_flat(jmaster))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key == "/blocks/bk" and CASES[case][1] != "float32":
            # the key bias's true gradient is 0 (softmax ignores a
            # per-query constant); in bf16 both sides' rounding noise is
            # large enough that Adam turns it into lr-sized steps of
            # unrelated sign
            continue
        np.testing.assert_allclose(got[key].astype(np.float32), w, rtol=0,
                                   atol=tol["master"], err_msg=key)
        assert np.abs(got[key] - w).mean() <= tol["master_mean"], key


def test_exact_loss_and_xla_attention_agree_with_fused_flash(jax_runs):
    """loss_impl="exact" (fp32 logits) and the plain attention train the
    same fp32 model to the same losses as the fused loss + flash path."""
    master0, jlosses = jax_runs["tiny-fp32"][:2]
    spec = dtt.causal_lm_spec("tiny", attention="xla", loss_impl="exact",
                              dtype="float32")
    engine, *_ = dtt.initialize(model=spec,
                                config=_config("float32", JAX_MICRO * DP),
                                device="cpu")
    load_master(engine, master0)
    data = synthetic_lm_data(JAX_MICRO * DP, SEQ, 512, seed=3)
    losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5, atol=0)


def test_train_batches_is_a_loop_of_steps(jax_runs):
    master0 = jax_runs["tiny-fp32"][0]
    a, b = _port("tiny-fp32", master0), _port("tiny-fp32", master0)
    da = synthetic_lm_data(JAX_MICRO * DP, SEQ, 512, seed=3)
    db = synthetic_lm_data(JAX_MICRO * DP, SEQ, 512, seed=3)
    mean = float(a.train_batches(da, 2))
    losses = [float(b.train_batch(db)) for _ in range(2)]
    np.testing.assert_allclose(mean, np.mean(losses), rtol=1e-6)
    assert a.global_steps == b.global_steps == 2
    torch.testing.assert_close(a.flat_master, b.flat_master, rtol=0, atol=0)


def test_fixed_batch_overfits_and_grad_accum_dtype():
    """The verify flow: a fixed repeated batch drives the loss well below
    ln(vocab); a bf16 gradient accumulator (data_types) trains too."""
    for extra in ({}, {"data_types": {"grad_accum_dtype": "bf16"},
                       "bf16": {"enabled": True}}):
        cfg = dict(_config("float32", 8), **extra)
        cfg.pop("scheduler")
        spec = dtt.causal_lm_spec("tiny", attention="flash",
                                  dtype="bfloat16" if extra else "float32")
        engine, *_ = dtt.initialize(model=spec, config=cfg, device="cpu")
        assert engine.flat_grad_acc.dtype == (torch.bfloat16 if extra
                                              else torch.float32)
        batch = next(synthetic_lm_data(8, SEQ, 512, seed=0))
        data = itertools.repeat(batch)
        losses = [float(engine.train_batch(data)) for _ in range(12)]
        assert np.isfinite(losses).all()
        assert losses[-1] < 0.8 * np.log(512), losses


# --------------------------------------------------------------------------- #
# config and schedules
# --------------------------------------------------------------------------- #

GOOD = [
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "gradient_accumulation_steps": 4},
    {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 3,
     "gradient_clipping": 1.0, "steps_per_print": 5, "seed": 7,
     "bf16": {"enabled": True}, "prescale_gradients": True,
     "optimizer": {"type": "AdamW", "params": {"lr": 3e-4,
                                               "betas": [0.9, 0.95]}},
     "scheduler": {"type": "WarmupCosineLR",
                   "params": {"total_num_steps": 100}},
     "zero_optimization": {"stage": 1, "reduce_bucket_size": 5e8,
                           "allgather_bucket_size": "auto"},
     "fp16": {"enabled": False, "initial_scale_power": 12},
     "data_types": {"grad_accum_dtype": "bf16"},
     "activation_checkpointing": {"policy": "full"},
     "amp": {"enabled": True}, "no_such_key": 1},
]
BAD = [
    {"train_batch_size": 30, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 2},
    {"train_batch_size": 30, "train_micro_batch_size_per_gpu": 4},
    {"gradient_accumulation_steps": 2},
    {"train_batch_size": 8, "zero_optimization": {"stage": 5}},
    {"train_batch_size": 8, "zero_optimization": {"reduce_bucket_size": 0}},
    {"train_batch_size": 8, "zero_optimization": {"mics_shard_size": -1}},
    {"train_batch_size": 8, "fp16": {"enabled": True},
     "bf16": {"enabled": True}},
    {"train_batch_size": 8, "zero_optimization": {"overlap_step": 1}},
    {"train_batch_size": 8, "zero_optimization": {"update_bucket_size": -3}},
]


def _values(cfg):
    import dataclasses
    return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            for k, v in ((f, getattr(cfg, f))
                         for f in PC.DeepSpeedTPUConfig.__dataclass_fields__)}


@pytest.mark.parametrize("i", range(len(GOOD)))
def test_config_values_match_jax(i):
    pcfg, jcfg = PC.load_config(GOOD[i]), JC.load_config(GOOD[i])
    pcfg.resolve_batch_size(1)
    jcfg.resolve_batch_size(1)
    assert _values(pcfg) == _values(jcfg)
    assert pcfg.precision_dtype == jcfg.precision_dtype
    assert pcfg.zero_enabled == jcfg.zero_enabled


@pytest.mark.parametrize("i", range(len(BAD)))
def test_config_errors_match_jax(i):
    def err(mod):
        try:
            cfg = mod.load_config(BAD[i])
            cfg.resolve_batch_size(1)
            cfg.precision_dtype
        except mod.DeepSpeedConfigError as e:
            return str(e)
        return None

    got, want = err(PC), err(JC)
    assert want is not None
    assert got == want


@pytest.mark.parametrize("name,params", [
    ("WarmupLR", {"warmup_num_steps": 10, "warmup_max_lr": 1e-3}),
    ("WarmupLR", {"warmup_num_steps": 10, "warmup_type": "linear",
                  "warmup_min_lr": 1e-5}),
    ("WarmupDecayLR", {"warmup_num_steps": 5, "total_num_steps": 20}),
    ("WarmupCosineLR", {"warmup_num_steps": 5, "total_num_steps": 20,
                        "warmup_min_ratio": 0.1}),
    ("LRRangeTest", {"lr_range_test_step_size": 3,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_first_step_size": 4, "decay_lr_rate": 0.1,
                  "decay_step_size": 2}),
])
def test_lr_at_matches_jax(name, params):
    p = PL.get_lr_schedule(name, params, base_lr=1e-3)
    j = JL.get_lr_schedule(name, params, base_lr=1e-3)
    steps = range(0, 30)
    # the JAX schedules compute in fp32 (a few ulp through log1p / cos),
    # the port's in double
    np.testing.assert_allclose([p.lr_at(s) for s in steps],
                               [float(j.lr_at(s)) for s in steps],
                               rtol=4e-6, atol=1e-12)
    for s in (p, j):
        s.step()
        s.step()
    np.testing.assert_allclose(p.get_last_lr(), j.get_last_lr(), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown scheduler"):
        PL.get_lr_schedule("NoSuchLR", {}, 1e-3)


# --------------------------------------------------------------------------- #
# out of the slice
# --------------------------------------------------------------------------- #

BASE = {"train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": "adam", "params": {"lr": 1e-3}}}


@pytest.mark.parametrize("extra,spec_kw", [
    # (an expert axis runs: tests/test_torch_expert_parallel.py)
    ({}, {"remat": "moe_selective"}),
    # (the offload tiers, ZenFlow and SuperOffload run: they are held in
    # tests/test_torch_offload.py and tests/test_torch_zenflow.py)
    ({"optimizer": {"type": "adafactor", "params": {"lr": 1e-3}}}, {}),
    ({"bf16": {"enabled": True, "fp32_master": False}}, {}),
    ({"progressive_layer_drop": {"enabled": True}}, {}),
    ({"data_efficiency": {"enabled": True}}, {}),
    ({"telemetry": {"tracing": True}}, {}),
    ({"wall_clock_breakdown": True}, {}),
    ({"activation_checkpointing": {"policy": "selective"}}, {}),
    ({"activation_checkpointing": {"cpu_checkpointing": True}}, {}),
    ({"optimizer": {"type": "lion", "params": {"lr": 1e-3}}}, {}),
    ({}, {"remat": "dots_saveable"}),
    # (the dense MoE dispatch runs: tests/test_torch_moe_dense.py; the
    # seq axis, the tiled loss and the sequence-parallel attentions run:
    # test_seq_options_at_world_1 below, tests/test_torch_sequence.py; the
    # tensor axis and the tensor_parallel section: test_tensor_options_at_
    # world_1 below, tests/test_torch_tensor_parallel.py; the pipe axis and
    # the pipeline section: test_pipe_options_at_world_1 below,
    # tests/test_torch_pipeline.py)
])
def test_out_of_slice_options_raise(extra, spec_kw):
    with pytest.raises(NotImplementedError, match="later slice"):
        spec = dtt.causal_lm_spec("tiny", dtype="float32", **spec_kw)
        dtt.initialize(model=spec, config=dict(BASE, **extra), device="cpu")


SEQ_OPTIONS = {"mesh_seq2": ({"mesh": {"seq": 2}}, {}),
               "autosp": ({"sequence_parallel": {"auto": True}}, {}),
               "loss_tiles": ({}, {"loss_tiles": 4}),
               "ring": ({}, {"attention": "ring"}),
               "ulysses": ({}, {"attention": "ulysses"})}


@pytest.mark.parametrize("name", list(SEQ_OPTIONS))
def test_seq_options_at_world_1(name):
    """The options of the seq slice in one process: ``mesh.seq = 2``
    raises JAX's ``ValueError`` (2 does not divide one process), the
    others train one step from JAX's master to JAX's loss (at sp = 1 the
    attentions are the plain one, AutoSP plans nothing; the tiled loss is
    JAX's)."""
    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh

    extra, spec_kw = SEQ_OPTIONS[name]
    cfg = dict(BASE, **extra, steps_per_print=10 ** 6)
    if name == "mesh_seq2":
        from deepspeed_tpu.comm.mesh import MeshConfig as JMC

        with pytest.raises(ValueError) as want:
            JMC(seq=2).resolve(1)
        with pytest.raises(ValueError) as got:
            dtt.initialize(model=dtt.causal_lm_spec("tiny", dtype="float32"),
                           config=cfg, device="cpu")
        assert str(got.value) == str(want.value)
        return
    mm = initialize_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng, *_ = dst.initialize(
        model=dst.causal_lm_spec("tiny_llama", dtype="float32", **spec_kw),
        config=cfg, mesh_manager=mm)
    peng, *_ = dtt.initialize(
        model=dtt.causal_lm_spec("tiny_llama", dtype="float32", **spec_kw),
        config=cfg, device="cpu")
    load_master(peng, jax.tree.map(np.asarray, jeng.state["master"]))
    batch = next(synthetic_lm_data(2, SEQ, 512, seed=3))
    jl = float(jeng.train_batch(iter([batch])))
    pl = float(peng.train_batch(iter([batch])))
    np.testing.assert_allclose(pl, jl, rtol=TOL["float32"]["loss"], atol=0)
    assert (peng.sp_plan is None) == (jeng.sp_plan is None)
    if jeng.sp_plan is not None:
        assert not peng.sp_plan.enabled and not jeng.sp_plan.enabled


TENSOR_OPTIONS = {"mesh_tensor2": {"mesh": {"tensor": 2}},
                  "mesh_tensor2_seq2": {"mesh": {"tensor": 2, "seq": 2}},
                  "autotp_size": {"tensor_parallel": {"autotp_size": 2}}}


@pytest.mark.parametrize("name", list(TENSOR_OPTIONS))
def test_tensor_options_at_world_1(name):
    """The options of the tensor slice in one process: a ``tensor`` axis
    of 2 (alone or beside ``seq = 2``) raises JAX's ``ValueError`` (it
    does not divide one process); the ``tensor_parallel`` section is read
    and inert, as in JAX, and the engine trains one step from JAX's master
    to JAX's loss."""
    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh

    extra = TENSOR_OPTIONS[name]
    cfg = dict(BASE, **extra, steps_per_print=10 ** 6)
    if "mesh" in extra:
        from deepspeed_tpu.comm.mesh import MeshConfig as JMC

        with pytest.raises(ValueError) as want:
            JMC(**extra["mesh"]).resolve(1)
        with pytest.raises(ValueError) as got:
            dtt.initialize(model=dtt.causal_lm_spec("tiny", dtype="float32"),
                           config=cfg, device="cpu")
        assert str(got.value) == str(want.value)
        return
    mm = initialize_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng, *_ = dst.initialize(
        model=dst.causal_lm_spec("tiny_llama", dtype="float32"),
        config=cfg, mesh_manager=mm)
    peng, *_ = dtt.initialize(
        model=dtt.causal_lm_spec("tiny_llama", dtype="float32"),
        config=cfg, device="cpu")
    assert peng.config.tensor_parallel.autotp_size == \
        jeng.config.tensor_parallel.autotp_size == 2
    load_master(peng, jax.tree.map(np.asarray, jeng.state["master"]))
    batch = next(synthetic_lm_data(2, SEQ, 512, seed=3))
    jl = float(jeng.train_batch(iter([batch])))
    pl = float(peng.train_batch(iter([batch])))
    np.testing.assert_allclose(pl, jl, rtol=TOL["float32"]["loss"], atol=0)


PIPE_OPTIONS = {"mesh_pipe2": {"mesh": {"pipe": 2}},
                "pipeline_section": {"pipeline": {
                    "stages": 2, "micro_batches": 4,
                    "activation_checkpoint_interval": 1}}}


@pytest.mark.parametrize("name", list(PIPE_OPTIONS))
def test_pipe_options_at_world_1(name):
    """The options of the pipeline slice in one process: a ``pipe`` axis
    of 2 raises JAX's ``ValueError`` (it does not divide one process); the
    ``pipeline`` section is read and inert, as in JAX, and the engine
    trains one step from JAX's master to JAX's loss."""
    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh

    extra = PIPE_OPTIONS[name]
    cfg = dict(BASE, **extra, steps_per_print=10 ** 6)
    if "mesh" in extra:
        with pytest.raises(ValueError) as want:
            MeshConfig(**extra["mesh"]).resolve(1)
        with pytest.raises(ValueError) as got:
            dtt.initialize(model=dtt.causal_lm_spec("tiny", dtype="float32"),
                           config=cfg, device="cpu")
        assert str(got.value) == str(want.value)
        return
    mm = initialize_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng, *_ = dst.initialize(
        model=dst.causal_lm_spec("tiny_llama", dtype="float32"),
        config=cfg, mesh_manager=mm)
    peng, *_ = dtt.initialize(
        model=dtt.causal_lm_spec("tiny_llama", dtype="float32"),
        config=cfg, device="cpu")
    assert peng.config.pipeline.micro_batches == \
        jeng.config.pipeline.micro_batches == 4
    load_master(peng, jax.tree.map(np.asarray, jeng.state["master"]))
    batch = next(synthetic_lm_data(2, SEQ, 512, seed=3))
    jl = float(jeng.train_batch(iter([batch])))
    pl = float(peng.train_batch(iter([batch])))
    np.testing.assert_allclose(pl, jl, rtol=TOL["float32"]["loss"], atol=0)


def test_initialize_refuses_what_it_does_not_run_yet():
    spec = dtt.causal_lm_spec("tiny", dtype="float32")
    with pytest.raises(NotImplementedError, match="data loader"):
        dtt.initialize(model=spec, config=BASE, device="cpu",
                       training_data=[1, 2])
    with pytest.raises(NotImplementedError, match="mpu"):
        dtt.initialize(model=spec, config=BASE, device="cpu", mpu=object())
    with pytest.raises(ValueError, match="requires a ModelSpec"):
        dtt.initialize(config=BASE, device="cpu")


def test_more_than_one_process_raises(monkeypatch):
    """WORLD_SIZE above 1 without a process group: the engine joins none
    itself, it asks for ``init_distributed`` (the data-parallel path is
    ``tests/test_torch_zero.py``)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="init_distributed"):
        dtt.initialize(model=dtt.causal_lm_spec("tiny", dtype="float32"),
                       config=BASE, device="cpu")


def test_inert_sections_and_unknown_names():
    cfg = dict(BASE, mesh={"data": -1}, telemetry={},
               tensorboard={"enabled": False})
    engine, *_ = dtt.initialize(model=dtt.causal_lm_spec("tiny",
                                                         dtype="float32"),
                                config=cfg, device="cpu")
    assert engine.train_micro_batch_size() == 2
    with pytest.raises(ValueError, match="unknown optimizer"):
        dtt.initialize(model=dtt.causal_lm_spec("tiny", dtype="float32"),
                       config=dict(BASE, optimizer={"type": "nope"}),
                       device="cpu")
    with pytest.raises(ValueError, match="unknown attention"):
        dtt.causal_lm_spec("tiny", attention="nope")
