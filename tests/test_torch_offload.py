"""The offload family of the PyTorch port against the JAX engine.

Counterparts of ``tests/unit/test_offload.py`` (``TestHostOffload``,
``TestNvmeSwap::test_optimizer_swap_roundtrip``, ``TestHostStep`` without
its checkpoint and ``eval_batch`` halves, ``TestOffloadParam`` without its
checkpoint): tiny, fp32, one fixed batch of 16 rows (the JAX engine's 8
CPU devices × micro 2; the port's one process × micro 16), Adam lr 1e-3,
6 steps, the JAX initial master carried across with ``load_master``.

* Each tier — ``offload_optimizer`` cpu and nvme at stage 2,
  ``offload_param`` cpu and nvme at stage 3 — and the host step
  (``host_step`` without overlap, and ``super_offload``'s overlap with
  gradient clipping) against the JAX engine with the same config: losses,
  every step's grad norm and the final master within
  ``test_torch_train.TOL["float32"]``. Each tier bit-equal to the port
  without offload; the sync host step's first loss too, and its later
  losses and master within ``HOST_SYNC_VS_PLAIN`` of it (its compiled Adam
  rounds sqrt correctly where the plain CPU version does not, so its
  later steps differ in the last bits); two overlap runs bit-equal; the
  overlap schedule (step 2 on the initial parameters, step 3 on update
  1's) against the sync run's losses.
* Where the state lies between steps: the moments on the host tier or in
  their files, the master parked or in its file, the host step's master
  and moments on the host from init on.
* ``offload_states`` / ``reload_states`` and the NVMe optimizer swapper's
  round trip; every configuration error raised with JAX's message, and
  the stage < 3 warning.
* World 2 on gloo CPU ranks (``Zero3Engine``): every tier bit-equal to the
  run without it; ``host_step`` refused at world 2 (JAX refuses more than
  one process) and with the int8 wire, with JAX's messages.
* The in-step ``offload_param`` streaming mode (JAX's on its accelerator;
  the port's on the CPU too), cpu and nvme, at world 1 and 2: losses
  and master bit-equal to no offload (and within TOL of JAX at world 1),
  the master's storage the pinned tier buffer at every streamed pass, one
  host→device and one device→host copy a chunk a step for the update and
  one a gather for ZeRO-3's fp32 gathers; the int8 wire keeps the
  boundary swap.

The CPU runs these with one intra-op thread (``single_thread``): the
overlap runs a forward on the main thread beside the update on the
worker, and a multi-threaded BLAS may then split a matmul otherwise.
"""
import itertools
import logging
import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_zero import _leaves, _spawn

STEPS = 6
ROWS, SEQ, VOCAB = 16, 32, 512
JAX_MICRO, DP = 2, 8
NVME = "__NVME__"          # replaced by the test's directory
CASES = {
    "base": {"stage": 2},
    "opt_cpu": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
    "opt_nvme": {"stage": 2, "offload_optimizer": {"device": "nvme",
                                                   "nvme_path": NVME}},
    "param_cpu": {"stage": 3, "offload_param": {"device": "cpu"}},
    "param_nvme": {"stage": 3, "offload_param": {"device": "nvme",
                                                 "nvme_path": NVME}},
    "host_sync": {"stage": 0, "offload_optimizer": {"device": "cpu",
                                                    "host_step": True}},
    "host_overlap": {"stage": 0, "super_offload": True},
}
# the overlap case also clips, so the host clip is held against JAX's
CLIP = {"host_overlap": 1.0}
# The sync host step against the port without offload: its compiled Adam
# rounds sqrt correctly where PyTorch's CPU sqrt is an ulp off
# (tests/test_torch_cpu_adam.py), and those ulps travel through the later
# steps' gradients. Measured over the 6 steps at lr 1e-3: losses bit-equal,
# the master at most 1.44e-6 and on average 1.05e-9 apart. The bounds sit
# 7x and 10x above that, and far below what an update off by a fraction
# of a step (~lr on every element) would leave.
HOST_SYNC_VS_PLAIN = dict(loss=1e-6, master=1e-5, master_mean=1e-8)


def _config(zero, micro, nvme, clip=0.0):
    zero = pickle.loads(pickle.dumps(zero))
    for off in ("offload_optimizer", "offload_param"):
        if zero.get(off, {}).get("nvme_path") == NVME:
            zero[off]["nvme_path"] = str(nvme)
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": 1,
           "optimizer": {"type": "adam", "params": {"lr": 1e-3}},
           "zero_optimization": zero, "steps_per_print": 10 ** 9}
    if clip:
        cfg["gradient_clipping"] = clip
    return cfg


def _tokens():
    return np.random.default_rng(7).integers(0, VOCAB, (ROWS, SEQ)).astype(
        np.int32)


@pytest.fixture
def single_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each case's JAX engine: initial master, losses, grad norms, final
    master (numpy)."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm import mesh as mesh_mod

    nvme = tmp_path_factory.mktemp("jax_nvme")
    toks = _tokens()
    out = {}
    for case, zero in CASES.items():
        mesh_mod.reset_mesh()
        spec = dst.causal_lm_spec("tiny", dtype="float32", max_seq_len=SEQ)
        cfg = dict(_config(zero, JAX_MICRO, nvme, CLIP.get(case, 0.0)),
                   mesh={"data": DP})
        engine, *_ = dst.initialize(model=spec, config=cfg)
        master0 = jax.tree.map(np.asarray, engine.state["master"])
        data = iter(lambda: {"tokens": toks}, None)
        losses, norms = [], []
        for _ in range(STEPS):
            losses.append(float(engine.train_batch(data)))
            norms.append(float(engine.get_global_grad_norm()))
        if engine._offload_param_nvme:
            engine._param_nvme_swapper().swap_in_params()
        master = jax.tree.map(np.asarray, engine.state["master"])
        out[case] = {"master0": master0, "losses": losses, "norms": norms,
                     "master": master}
    mesh_mod.reset_mesh()
    return out


def _port(case, master0, nvme, zero=None):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import load_master

    spec = dtt.causal_lm_spec("tiny", dtype="float32", max_seq_len=SEQ)
    engine, *_ = dtt.initialize(model=spec, config=_config(
        CASES[case] if zero is None else zero, ROWS, nvme,
        CLIP.get(case, 0.0)), device="cpu")
    if master0 is not None:
        load_master(engine, master0)
    return engine


def _train(engine, steps=STEPS, after=None):
    toks = _tokens()
    data = itertools.repeat({"tokens": toks})
    losses, norms, seen = [], [], []
    for _ in range(steps):
        losses.append(float(engine.train_batch(data)))
        norms.append(engine.get_global_grad_norm())
        if after is not None:
            seen.append(after(engine))
    return losses, norms, seen


def _master(engine):
    from deepspeed_tpu_torch.models.convert import gather_master

    return gather_master(engine)


@pytest.fixture(scope="module")
def port_base(jax_runs, tmp_path_factory):
    engine = _port("base", jax_runs["base"]["master0"],
                   tmp_path_factory.mktemp("base"))
    losses, norms, _ = _train(engine)
    return {"losses": losses, "norms": norms,
            "flat": engine.flat_master.clone(), "master": _master(engine)}


def _where(engine):
    """Where the state lies between steps."""
    from deepspeed_tpu_torch.runtime.swap_tensor import Swapped

    opt = {k: v for k, v in engine.state["opt"].items() if k != "step"}
    return {"opt_on_host": engine._opt_on_host,
            "opt_swapped": all(isinstance(v, Swapped) for v in opt.values()),
            "master_parked": engine._master_parked,
            "master_swapped": isinstance(engine.flat_master, Swapped),
            "master_device": getattr(engine.flat_master, "device", None)}


WHERE = {"opt_cpu": dict(opt_on_host=True, opt_swapped=False,
                         master_parked=False, master_swapped=False),
         "opt_nvme": dict(opt_on_host=False, opt_swapped=True,
                          master_parked=False, master_swapped=False),
         "param_cpu": dict(opt_on_host=False, opt_swapped=False,
                           master_parked=True, master_swapped=False),
         "param_nvme": dict(opt_on_host=False, opt_swapped=False,
                            master_parked=True, master_swapped=True),
         "host_sync": dict(opt_on_host=False, opt_swapped=False,
                           master_parked=False, master_swapped=False)}


@pytest.mark.parametrize("case", [c for c in CASES if c != "base"])
def test_tier_matches_jax_and_the_port_without_it(case, jax_runs, port_base,
                                                  tmp_path, single_thread):
    from test_torch_train import TOL

    tol = TOL["float32"]
    want = jax_runs[case]
    engine = _port(case, want["master0"], tmp_path)
    losses, norms, seen = _train(engine, after=_where)
    if engine._host_runner is not None:
        engine._host_runner.wait()
    np.testing.assert_allclose(losses, want["losses"], rtol=tol["loss"],
                               atol=0)
    np.testing.assert_allclose(norms, want["norms"], rtol=10 * tol["loss"])
    got = dict(_leaves(_master(engine)))
    for key, w in _leaves(want["master"]):
        np.testing.assert_allclose(got[key], w, rtol=0, atol=tol["master"],
                                   err_msg=key)
        assert np.abs(got[key] - w).mean() <= tol["master_mean"], key
    if case == "host_overlap":
        # the schedule: steps 1 and 2 on the initial parameters
        assert losses[1] == losses[0]
        assert engine._host_runner.overlap
        engine.close()
        return
    engine._materialize_master()
    if case == "host_sync":
        # the compiled Adam's correctly rounded sqrt: the first loss
        # bit-equal, the rest and the master within HOST_SYNC_VS_PLAIN
        b = HOST_SYNC_VS_PLAIN
        assert losses[0] == port_base["losses"][0], case
        np.testing.assert_allclose(losses, port_base["losses"],
                                   rtol=b["loss"], atol=0)
        diff = (engine.flat_master.cpu() - port_base["flat"]).abs()
        assert diff.max() <= b["master"], float(diff.max())
        assert diff.mean() <= b["master_mean"], float(diff.mean())
    else:
        # every tier is bit-equal to no offload
        assert losses == port_base["losses"], case
        assert torch.equal(engine.flat_master.cpu(), port_base["flat"]), case
    for w in seen:
        for k, v in WHERE[case].items():
            assert w[k] == v, (case, k, w)
    if case.endswith("nvme"):
        sub = "optimizer" if case.startswith("opt") else "param"
        files = os.listdir(tmp_path / sub / "rank0")
        assert any(f.endswith(".bin") for f in files), files
    engine.close()


def _stream_probe(engine):
    """Record, at every streamed pass, where the master's storage lies and
    whether it is the pinned tier buffer."""
    seen = []
    orig = engine._stream_pass

    def probe(*a, **kw):
        m = engine.flat_master
        seen.append((m.device.type, m.data_ptr()
                     == engine._host_bufs["master"].tensor.data_ptr()))
        return orig(*a, **kw)

    engine._stream_pass = probe
    return seen


@pytest.mark.parametrize("case", ["param_cpu", "param_nvme"])
def test_param_stream_matches_jax_and_no_offload(case, jax_runs, port_base,
                                                 tmp_path):
    """In-step ``offload_param`` streaming (JAX's mode on its accelerator;
    the port's on CPU tensors too): the master stays in its pinned buffer
    through the step, the update streams it chunk by chunk; losses and
    master bit-equal to no offload and within TOL of JAX; one host→device
    and one device→host copy a chunk a step."""
    from test_torch_train import TOL

    tol = TOL["float32"]
    want = jax_runs[case]
    engine = _port(case, want["master0"], tmp_path)
    assert engine._param_stream
    probe = _stream_probe(engine)
    counts = []
    losses, _, seen = _train(engine, after=lambda e: (
        counts.append(dict(e.stream_counts)), _where(e))[1])
    assert losses == port_base["losses"]
    engine._materialize_master()
    assert torch.equal(engine.flat_master.cpu(), port_base["flat"])
    got = dict(_leaves(_master(engine)))
    for key, w in _leaves(want["master"]):
        np.testing.assert_allclose(got[key], w, rtol=0, atol=tol["master"],
                                   err_msg=key)
    assert probe == [("cpu", True)] * STEPS
    chunks = len(engine._stream_ranges())
    assert chunks == 1 + len(engine._layer_bounds()) > 1
    assert counts == [{"update_h2d": chunks, "update_d2h": chunks,
                       "derive_h2d": 0, "gather_h2d": 0}] * STEPS
    for w in seen:
        assert w["master_parked"]
        assert w["master_swapped"] == (case == "param_nvme")
    engine.close()


def test_host_step_state_lives_on_the_host_and_overlap_is_deterministic(
        jax_runs, tmp_path, single_thread):
    """The host step's master and moments are host tensors from init on,
    its card buffers the compute copy, the gradient and the accumulator;
    two overlap runs give the same bits; the overlap run's step 3 loss is
    the sync run's step 2 loss (both on update 1's parameters)."""
    master0 = jax_runs["host_overlap"]["master0"]
    runs = []
    for _ in range(2):
        engine = _port("host_overlap", master0, tmp_path)
        runner = engine._host_runner
        assert runner.overlap and engine.flat_master.device.type == "cpu"
        assert runner.landing.dtype == torch.float32
        assert runner.staging.dtype == engine.compute_dtype
        losses, norms, _ = _train(engine, steps=4)
        runner.wait()
        runs.append((losses, norms, engine.flat_master.clone(),
                     engine.state["opt"]["exp_avg"].clone()))
        engine.close()
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    assert torch.equal(runs[0][2], runs[1][2])
    assert torch.equal(runs[0][3], runs[1][3])
    sync = _port("host_overlap", master0, tmp_path, zero={
        "stage": 0, "super_offload": True,
        "offload_optimizer": {"overlap_step": False}})
    assert not sync._host_runner.overlap        # explicit False wins
    slosses, _, _ = _train(sync, steps=2)
    sync.close()
    assert runs[0][0][2] == slosses[1]


def test_super_offload_and_zenflow_resolve_overlap(tmp_path):
    """JAX's resolution: super_offload → cpu + host_step + overlap;
    ZenFlow with host_step takes ZenFlow's overlap_step."""
    from deepspeed_tpu_torch.runtime.zenflow import ZenFlowOptimizer

    e = _port("host_sync", None, tmp_path, zero={"stage": 0,
                                                 "super_offload": True})
    off = e.config.zero_optimization.offload_optimizer
    assert (off.device, off.host_step, off.overlap_step) == ("cpu", True,
                                                             True)
    assert e._host_step and not e._offload_opt and e._host_runner.overlap
    e.close()
    z = _port("host_sync", None, tmp_path, zero={
        "stage": 0, "offload_optimizer": {"device": "cpu", "host_step": True},
        "zenflow": {"enabled": True, "topk_ratio": 0.05,
                    "update_interval": 2}})
    assert isinstance(z.optimizer, ZenFlowOptimizer) and z._host_runner.overlap
    losses, _, _ = _train(z, steps=4)
    z.close()
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_offload_states_api(jax_runs, port_base, tmp_path):
    """``offload_states`` parks the moments and the master in host memory,
    ``reload_states`` brings them back; the run's bits do not change."""
    engine = _port("base", jax_runs["base"]["master0"], tmp_path)
    losses, _, _ = _train(engine, steps=1)
    engine.offload_states()
    assert engine._opt_on_host and engine._master_parked
    engine.reload_states()
    assert not engine._opt_on_host and not engine._master_parked
    engine.offload_states(include=["optim_states"])
    assert engine._opt_on_host and not engine._master_parked
    more, _, _ = _train(engine, steps=STEPS - 1)
    assert losses + more == port_base["losses"]
    assert torch.equal(engine.flat_master, port_base["flat"])
    with pytest.raises(ValueError, match="offload_states supports "
                                         "device='cpu'"):
        engine.offload_states(device="nvme")


HOST_BUFS = {"opt_cpu": ["opt/exp_avg", "opt/exp_avg_sq"],
             "param_cpu": ["master"], "param_nvme": ["master"]}


@pytest.mark.parametrize("case", sorted(HOST_BUFS))
def test_host_tiers_reuse_their_buffers(case, tmp_path):
    """A host tier copies into one buffer a tensor, made at its first
    swap-out and reused by every later swap (the NVMe master is read back
    into it); ``close`` lets them go."""
    engine = _port(case, None, tmp_path)

    def ptrs(e):
        if e._param_swapper is not None:
            e._param_swapper.swap_in_params()
        tiers = [e.flat_master] if case.startswith("param") else [
            v for k, v in e.state["opt"].items() if k != "step"]
        return [t.data_ptr() for t in tiers]

    _, _, seen = _train(engine, steps=3, after=ptrs)
    assert sorted(engine._host_bufs) == HOST_BUFS[case]
    bufs = [engine._host_bufs[k].tensor.data_ptr() for k in HOST_BUFS[case]]
    assert seen == [bufs] * 3
    engine.close()
    assert engine._host_bufs == {}


def test_tensor_swapper_staging_and_into(tmp_path):
    """A tensor that is not a contiguous CPU tensor is staged through one
    buffer a key, reused by the next swap-out; ``swap_in(into=...)``
    reads into the caller's buffer."""
    from deepspeed_tpu_torch.runtime.swap_tensor import TensorSwapper

    sw = TensorSwapper(str(tmp_path / "sw"))
    a = torch.arange(24, dtype=torch.float32).view(4, 6)
    sw.swap_out({"a": a.t(), "b": a[0]})
    stage = sw._staging["a"].tensor.data_ptr()
    sw.swap_out({"a": (a + 1).t(), "b": a[1]})
    assert list(sw._staging) == ["a"]
    assert sw._staging["a"].tensor.data_ptr() == stage
    into = {"b": torch.empty(6)}
    back = sw.swap_in(into=into)
    assert back["b"] is into["b"] and torch.equal(into["b"], a[1])
    assert torch.equal(back["a"], (a + 1).t())
    sw.close()
    assert sw._staging == {}


def test_optimizer_swap_roundtrip(jax_runs, tmp_path):
    """``OptimizerSwapper`` writes every moment and reads it back bit for
    bit; training goes on after the swap-in."""
    from deepspeed_tpu_torch.runtime.swap_tensor import (
        OptimizerSwapper,
        Swapped,
    )

    engine = _port("base", jax_runs["base"]["master0"], tmp_path)
    _train(engine, steps=1)
    want = engine.state["opt"]["exp_avg"].clone()
    swapper = OptimizerSwapper(engine, swap_dir=str(tmp_path))
    swapper.swap_out_optimizer()
    assert isinstance(engine.state["opt"]["exp_avg"], Swapped)
    assert swapper.swapper.last["bytes"] == 2 * want.numel() * 4
    swapper.swap_in_optimizer()
    assert torch.equal(engine.state["opt"]["exp_avg"], want)
    losses, _, _ = _train(engine, steps=1)
    assert np.isfinite(losses).all()


BAD = {
    "fp16_host_step": ({"stage": 0, "offload_optimizer": {
        "device": "cpu", "host_step": True}}, {"fp16": {"enabled": True}}),
    "host_step_nvme": ({"stage": 0, "offload_optimizer": {
        "device": "nvme", "host_step": True}}, {}),
    "super_offload_nvme": ({"stage": 0, "super_offload": True,
                            "offload_optimizer": {"device": "nvme"}}, {}),
    "offload_param_gpu": ({"stage": 3, "offload_param": {"device": "gpu"}},
                          {}),
}


@pytest.mark.parametrize("name", list(BAD))
def test_config_errors_match_jax(name, tmp_path):
    import deepspeed_tpu as dst
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu.comm import mesh as mesh_mod
    from deepspeed_tpu.runtime.config_utils import \
        DeepSpeedConfigError as JErr
    from deepspeed_tpu_torch.runtime.config_utils import \
        DeepSpeedConfigError as PErr

    zero, extra = BAD[name]
    mesh_mod.reset_mesh()
    with pytest.raises(JErr) as jerr:
        dst.initialize(model=dst.causal_lm_spec("tiny", dtype="float32",
                                                max_seq_len=SEQ),
                       config=dict(_config(zero, JAX_MICRO, tmp_path),
                                   mesh={"data": DP}, **extra))
    mesh_mod.reset_mesh()
    with pytest.raises(PErr) as perr:
        dtt.initialize(model=dtt.causal_lm_spec("tiny", dtype="float32",
                                                max_seq_len=SEQ),
                       config=dict(_config(zero, ROWS, tmp_path), **extra),
                       device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_offload_param_below_stage3_warns_and_is_off(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="deepspeed_tpu_torch"):
        e = _port("base", None, tmp_path, zero={
            "stage": 2, "offload_param": {"device": "cpu"}})
    assert not e._offload_param and not e._master_parked
    assert any("offload_param is a ZeRO-3 tier" in r.getMessage()
               for r in caplog.records)
    losses, _, _ = _train(e, steps=1)
    assert np.isfinite(losses).all()


# --------------------------------------------------------------------------- #
# world 2 on gloo CPU ranks
# --------------------------------------------------------------------------- #

WORLD2 = {"none": {"stage": 3},
          "param_cpu": {"stage": 3, "offload_param": {"device": "cpu"}},
          "param_nvme": {"stage": 3, "offload_param": {"device": "nvme",
                                                       "nvme_path": NVME}},
          "opt_cpu": {"stage": 3, "offload_optimizer": {"device": "cpu"}},
          "opt_nvme": {"stage": 3, "offload_optimizer": {"device": "nvme",
                                                         "nvme_path": NVME}}}
# the exact wire's offload_param streams (each rank's master shard); the
# int8 wire keeps the boundary swap
STREAMED2 = ("param_cpu", "param_nvme")
INT8_2 = {"param_cpu_int8": {"stage": 3, "zero_quantized_gradients": True,
                             "zero_quantized_weights": True,
                             "offload_param": {"device": "cpu"}}}
REFUSED2 = {"host_step": {"stage": 2, "offload_optimizer": {
                "device": "cpu", "host_step": True}},
            "host_step_qgz": {"stage": 2, "zero_quantized_gradients": True,
                              "offload_optimizer": {"device": "cpu",
                                                    "host_step": True}}}


def _world2_rank(rank, world, nvme):
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master
    from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

    out = {}
    for name, zero in list(WORLD2.items()) + list(INT8_2.items()):
        spec = dtt.causal_lm_spec("tiny", dtype="float32", max_seq_len=SEQ)
        engine, *_ = dtt.initialize(model=spec, config=_config(
            zero, ROWS // world, nvme), device="cpu")
        probe = _stream_probe(engine) if engine._param_stream else None
        counts = []
        losses, _, seen = _train(engine, steps=3, after=lambda e: (
            counts.append((dict(e.stream_counts), dict(e._zero3.counts))),
            _where(e))[1])
        out[name] = {"type": type(engine).__name__, "losses": losses,
                     "seen": seen, "master": gather_master(engine),
                     "stream": engine._param_stream, "probe": probe,
                     "counts": counts,
                     "chunks": len(engine._stream_ranges())
                     if engine._param_stream else None}
        engine.close()
    for name, zero in REFUSED2.items():
        try:
            dtt.initialize(model=dtt.causal_lm_spec("tiny", dtype="float32",
                                                    max_seq_len=SEQ),
                           config=_config(zero, ROWS // world, nvme),
                           device="cpu")
            out[name] = None
        except DeepSpeedConfigError as e:
            out[name] = str(e)
    return out


def test_world2_tiers_bit_equal_and_host_step_refused(tmp_path):
    ranks = _spawn(_world2_rank, 2, tmp_path, str(tmp_path / "nvme"))
    for r, res in enumerate(ranks):
        base = res["none"]
        assert base["type"] == "Zero3Engine"
        for name in WORLD2:
            assert res[name]["losses"] == base["losses"], name
            for key, v in _leaves(base["master"]):
                assert np.array_equal(dict(_leaves(res[name]["master"]))[key],
                                      v), (name, key)
        for name in STREAMED2:
            got = res[name]
            assert got["stream"], name
            assert got["probe"] == [("cpu", True)] * 3, name
            for stream, z3 in got["counts"]:
                # one copy each way a chunk for the update; every fp32
                # gather reads its group from the host master
                assert stream["update_h2d"] == stream["update_d2h"] \
                    == got["chunks"] > 1, name
                assert stream["gather_h2d"] == z3["gather_fwd"] \
                    + z3["gather_bwd"] > 0, name
        int8 = res["param_cpu_int8"]
        assert not int8["stream"]
        assert all(s["master_parked"] for s in int8["seen"])
        assert all(s["master_parked"] for s in res["param_cpu"]["seen"])
        assert all(s["master_swapped"] for s in res["param_nvme"]["seen"])
        assert all(s["opt_on_host"] for s in res["opt_cpu"]["seen"])
        assert all(s["opt_swapped"] for s in res["opt_nvme"]["seen"])
        assert os.listdir(tmp_path / "nvme" / "param" / f"rank{r}")
        assert res["host_step"] == (
            "host_step is single-host for now: the update runs on this "
            "process's CPU backend and cannot address remote shards")
        assert res["host_step_qgz"] == ("host_step cannot combine with "
                                        "compressed collectives")


# --------------------------------------------------------------------------- #
# checkpoints through the tiers (the checkpoint halves of tests/unit/
# test_offload.py)
# --------------------------------------------------------------------------- #

def test_nvme_checkpoint_reload_does_not_clobber_restored_moments(
        jax_runs, port_base, tmp_path, single_thread):
    """``TestNvmeSwap::test_checkpoint_reload_does_not_clobber_restored_
    moments``: a load into an NVMe-tier engine leaves the restored moments
    authoritative (the next step's swap-in must not bring back the swap
    files of the steps after the save: they equal the tag's leaves), and
    the run goes on bit-equal to the port without offload, within TOL of
    JAX's."""
    from test_torch_train import TOL

    from deepspeed_tpu_torch.checkpoint.engine import open_state

    want = jax_runs["opt_nvme"]
    engine = _port("opt_nvme", want["master0"], tmp_path)
    _train(engine, steps=1)
    engine.save_checkpoint(str(tmp_path / "ck"))
    _train(engine, steps=1)         # the swap files move past the save
    engine.load_checkpoint(str(tmp_path / "ck"))
    assert engine.global_steps == 1
    assert _where(engine)["opt_swapped"]
    engine._nvme_swapper().swap_in_optimizer()
    saved = open_state(str(tmp_path / "ck" / "global_step1"))
    for slot in engine._slots:
        name = "/".join(slot.path)
        assert torch.equal(engine._view(engine.state["opt"]["exp_avg"], slot),
                           saved[f"opt/exp_avg/{name}"]), name
    engine._nvme_swapper().swap_out_optimizer()
    losses, _, _ = _train(engine, steps=3)
    assert losses == port_base["losses"][1:4]
    np.testing.assert_allclose(losses, want["losses"][1:4],
                               rtol=TOL["float32"]["loss"], atol=0)
    engine.close()


def test_host_step_checkpoint_lands_the_update_and_adopts(
        jax_runs, port_base, tmp_path, single_thread):
    """The checkpoint half of ``TestHostStep::test_gas_and_eval_and_
    checkpoint``: a save lands the pending host update first (the overlap
    schedule leaves one in flight after every step), a load re-homes the
    state (``HostStepRunner.adopt_state``: the update in flight dropped,
    master and moments on the host, the compute copy from the restored
    master); a fresh sync host-step engine resumes bit-equal to the
    uninterrupted run, within HOST_SYNC_VS_PLAIN of the port without
    offload and TOL of JAX."""
    from test_torch_train import TOL

    over = _port("host_overlap", jax_runs["host_overlap"]["master0"],
                 tmp_path)
    _train(over, steps=3)
    runner = over._host_runner
    assert runner._pending is not None          # update 3 in flight
    over.save_checkpoint(str(tmp_path / "over"))
    assert runner._pending.done()
    with open(tmp_path / "over" / "global_step3" / "state_fast" /
              "master__tok_emb.bin", "rb") as f:
        saved = np.frombuffer(f.read(), np.float32)
    assert np.array_equal(saved, over.state["master"]["tok_emb"].reshape(-1)
                          .numpy())
    over.load_checkpoint(str(tmp_path / "over"))
    assert runner._pending is None
    assert over.flat_master.device.type == "cpu"
    assert all(v.device.type == "cpu" for k, v in over.state["opt"].items()
               if k != "step")
    assert torch.equal(over.flat_compute, over.flat_master.to(
        over.compute_dtype))
    over.close()

    want = jax_runs["host_sync"]
    whole = _port("host_sync", want["master0"], tmp_path)
    wlosses, _, _ = _train(whole)
    whole._host_runner.wait()
    first = _port("host_sync", want["master0"], tmp_path)
    _train(first, steps=3)
    first.save_checkpoint(str(tmp_path / "sync"))
    first.close()
    resumed = _port("host_sync", None, tmp_path)
    resumed.load_checkpoint(str(tmp_path / "sync"))
    assert resumed.global_steps == 3
    losses, _, _ = _train(resumed, steps=STEPS - 3)
    resumed._host_runner.wait()
    assert losses == wlosses[3:]
    assert torch.equal(resumed.flat_master, whole.flat_master)
    np.testing.assert_allclose(losses, port_base["losses"][3:],
                               rtol=HOST_SYNC_VS_PLAIN["loss"], atol=0)
    np.testing.assert_allclose(losses, want["losses"][3:],
                               rtol=TOL["float32"]["loss"], atol=0)
    whole.close()
    resumed.close()


def test_param_nvme_tier_checkpoint_roundtrip(jax_runs, port_base, tmp_path,
                                              single_thread):
    """The checkpoint half of ``TestOffloadParam::test_nvme_tier_roundtrip_
    and_checkpoint``: a save swaps the master in from its file, a load
    writes the restored master to the file anew (no stale file wins), and
    the run goes on bit-equal to the port without offload, within TOL of
    JAX's."""
    from test_torch_train import TOL

    want = jax_runs["param_nvme"]
    engine = _port("param_nvme", want["master0"], tmp_path)
    _train(engine, steps=2)
    assert _where(engine)["master_swapped"]
    engine.save_checkpoint(str(tmp_path / "ck"))
    assert _where(engine)["master_swapped"]
    _train(engine, steps=1)
    engine.load_checkpoint(str(tmp_path / "ck"))
    assert engine.global_steps == 2
    where = _where(engine)
    assert where["master_parked"] and where["master_swapped"]
    losses, _, _ = _train(engine, steps=2)
    assert losses == port_base["losses"][2:4]
    np.testing.assert_allclose(losses, want["losses"][2:4],
                               rtol=TOL["float32"]["loss"], atol=0)
    engine.close()
