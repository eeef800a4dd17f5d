"""Data-parallel training of the PyTorch port against the JAX package.

Ranks run as spawned processes on gloo (``init_method="file://…"`` in
``tmp_path``, so xdist workers never share a port); each test spawns its
ranks once and runs all its cases inside them. Every rank is joined under
its own time limit (``RANK_TIMEOUT``) and the process group has a
``timeout``, so a hang fails the test instead of running the suite's clock
out. A spawned rank imports this module to find its function: jax is
imported inside the fixtures and tests, never at the top.

* ``quantized_reduce_scatter`` at world 2 and 4 against JAX's on a
  ``data = W`` mesh of W CPU devices, the same [W, N] input: bit-equal to
  JAX's jnp path (the qgZ arithmetic the JAX engine runs), within W - 1
  ulps of its Pallas path in interpret mode (an FMA the CPU compiler
  contracts there, ``tests/test_torch_quantization.py``); the ranks'
  chunks concatenate to the whole reduction. ``onebit_allreduce`` the same
  way, with its new error state. At world 2, the per-leaf wire
  (``q_reduce_leaf`` int8 and exact, ``loco_reduce_leaf``) against JAX's
  in a ``shard_map`` on leaves sharded on dim 0, on dim 1 and replicated. The gloo staging
  through pinned host buffers, run on CPU tensors, gives the direct
  collective's result.
* The engine at world 2 against the JAX engine at ``data = 2`` (a tiny
  fp32 model, the JAX initial master carried over, the same global batches
  for 3 steps): stage 1 exact, stage 2 exact, stage 2 qgZ, qgZ + qwZ and
  qgZ + qwZ + LoCo; ``_compressed`` / ``_wire_format`` equal to JAX's.
  Then stage 1 / stage 2 exact and qgZ on batches whose ``loss_mask``
  keeps a different number of tokens on each rank: the exact wire takes
  JAX's global masked token mean, the int8 wire the ranks' mean.
* ``tiny_moe`` at world 2 against the JAX engine at ``data = 2`` (stage 1
  and stage 2 exact, stage 2 qgZ): the exact wire takes JAX's global aux
  loss (the token means of the router probabilities and the first-choice
  mask averaged over the ranks before their product), the int8 wire the
  ranks' mean of their own aux values, as JAX's manual step does.
"""
import pickle
import queue
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

RANK_TIMEOUT = 120          # seconds, each rank's join
PG_TIMEOUT = 60             # seconds, the process group's collectives
B = 2048


# --------------------------------------------------------------------------- #
# spawning ranks
# --------------------------------------------------------------------------- #

def _rank_main(fn, rank, world, init_method, out, args):
    try:
        torch.set_num_threads(2)
        import deepspeed_tpu_torch as dtt

        dtt.init_distributed(dist_backend="gloo", init_method=init_method,
                             rank=rank, world_size=world, timeout=PG_TIMEOUT,
                             verbose=False)
        out.put((rank, "ok", fn(rank, world, *args)))
        dtt.comm.destroy_process_group()
    except Exception:                                   # noqa: BLE001
        out.put((rank, "error", traceback.format_exc()))


def _spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned ranks; returns
    the results by rank. Any rank's error, or a rank still running after
    ``RANK_TIMEOUT``, fails the test."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init = f"file://{tmp_path / 'pg'}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, status, value = out.get(timeout=RANK_TIMEOUT)
            if status == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    except queue.Empty:
        errors.append(f"a rank gave no result in {RANK_TIMEOUT} s")
    finally:
        for p in procs:
            p.join(timeout=RANK_TIMEOUT if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
                errors.append(f"rank process {p.pid} killed at its limit")
    assert not errors, "\n".join(errors)
    return [results[r] for r in range(world)]


# --------------------------------------------------------------------------- #
# the entry points
# --------------------------------------------------------------------------- #

def _collective_inputs(world):
    rng = np.random.default_rng(world)
    n = world * 2 * B
    x = (rng.standard_normal((world, n)) * 10.0 ** rng.integers(
        -2, 2, (world, 1))).astype(np.float32)
    err = (0.1 * rng.standard_normal((world, n))).astype(np.float32)
    return x, err


# per-leaf wire: (shape, spec) — sharded on dim 0, on dim 1, replicated
LEAVES = {"a": ((4, 3000), ("data", None)), "b": ((6, 8), (None, "data")),
          "c": ((5,), (None,))}


def _leaf_inputs(world):
    rng = np.random.default_rng(100 + world)
    grads = {k: rng.standard_normal((world,) + shape).astype(np.float32)
             for k, (shape, _) in LEAVES.items()}
    errs = {k: (0.01 * rng.standard_normal((world,) + shape)).astype(
        np.float32) for k, (shape, _) in LEAVES.items()}
    return grads, errs


def _collectives_rank(rank, world):
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops import quantization as PQ
    from deepspeed_tpu_torch.parallel import compressed as C

    grads, errs = _leaf_inputs(world)
    mine = {k: torch.from_numpy(v[rank]) for k, v in grads.items()}
    specs = {k: spec for k, (_, spec) in LEAVES.items()}
    leaves = {}
    for quant in (True, False):
        red, _ = C.reduce_tree_bucketed(mine, specs, ("data",), world,
                                        {"data": world}, quant_grads=quant)
        leaves[f"quant={quant}"] = {k: v.numpy() for k, v in red.items()}
    red, new_err = C.reduce_tree_bucketed(
        mine, specs, ("data",), world, {"data": world},
        err_tree={k: torch.from_numpy(v[rank]) for k, v in errs.items()})
    leaves["loco"] = {k: v.numpy() for k, v in red.items()}
    leaves["loco_err"] = {k: v.numpy() for k, v in new_err.items()}

    x, err = _collective_inputs(world)
    chunk = PQ.quantized_reduce_scatter(torch.from_numpy(x[rank]))
    chunk_sum = PQ.quantized_reduce_scatter(torch.from_numpy(x[rank]),
                                            mean=False)
    red, new_err = PQ.onebit_allreduce(torch.from_numpy(x[rank]),
                                       torch.from_numpy(err[rank]))
    # the pinned-host staging of gloo collectives, on CPU tensors
    t = torch.from_numpy(x[rank]).clone()
    direct = t.clone()
    dist.all_reduce(direct)
    comm._gloo_via_pinned_host(lambda o, i: dist.all_reduce(o), t, t)
    rows = torch.from_numpy(x[rank]).view(world, -1)
    staged = torch.empty_like(rows)
    comm._gloo_via_pinned_host(
        lambda o, i: dist.all_to_all_single(o, i), staged, rows)
    # the torch-shaped wrappers: reduce_scatter (AVG) and broadcast
    rs = comm.reduce_scatter(rows.clone(), comm.ReduceOp.AVG)
    bc = comm.broadcast(torch.full((3,), float(rank)), src=world - 1)
    return {"leaves": leaves, "reduce_scatter": rs.numpy(),
            "broadcast": bc.numpy(),
            "chunk": chunk.numpy(), "chunk_sum": chunk_sum.numpy(),
            "onebit": red.numpy(), "onebit_err": new_err.numpy(),
            "staged_all_reduce": bool(torch.equal(t, direct)),
            "staged_all_to_all": staged.numpy(),
            "a2a": comm.all_to_all_single(rows).numpy()}


@pytest.mark.parametrize("world", [2, 4])
def test_quantized_reduce_scatter_and_onebit_match_jax(world, tmp_path):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh
    from deepspeed_tpu.ops import quantization as JQ

    got = _spawn(_collectives_rank, world, tmp_path)
    x, err = _collective_inputs(world)
    mesh = initialize_mesh(MeshConfig(data=world),
                           devices=jax.devices()[:world]).mesh
    xj = jnp.asarray(x)
    plain = np.asarray(JQ.quantized_reduce_scatter(xj, mesh,
                                                   use_pallas=False))
    pallas = np.asarray(JQ.quantized_reduce_scatter(xj, mesh,
                                                    use_pallas=True))
    chunks = np.stack([g["chunk"] for g in got])
    np.testing.assert_array_equal(chunks, plain)
    scale = np.abs(x).max() / 127
    np.testing.assert_allclose(chunks, pallas, rtol=0,
                               atol=(world - 1) * np.spacing(
                                   np.float32(world * scale * 127)))
    np.testing.assert_array_equal(
        np.stack([g["chunk_sum"] for g in got]) / np.float32(world),
        chunks)
    # the int8 error against the exact mean: at most half a step a rank
    exact = x.mean(axis=0).reshape(world, -1)
    steps = np.abs(x).reshape(world, -1, B).max(-1) / 127    # [W, blocks]
    bound = (steps.sum(0) / 2 / world).repeat(B).reshape(world, -1)
    assert (np.abs(chunks - exact) <= bound * (1 + 1e-5) + 1e-6).all()
    jred, jerr = JQ.onebit_allreduce(xj, jnp.asarray(err), mesh)
    for r, g in enumerate(got):
        np.testing.assert_allclose(
            g["reduce_scatter"], x.reshape(world, world, -1)[:, r].mean(0)[None],
            rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(g["broadcast"], np.full(3, world - 1.0))
        np.testing.assert_allclose(g["onebit"], np.asarray(jred), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(g["onebit"], got[0]["onebit"])
        assert g["staged_all_reduce"]
        np.testing.assert_array_equal(g["staged_all_to_all"], g["a2a"])
    np.testing.assert_allclose(np.stack([g["onebit_err"] for g in got]),
                               np.asarray(jerr), rtol=0, atol=1e-5)
    if world == 2:
        _check_leaf_wire(got, world, mesh)


def _check_leaf_wire(got, world, mesh):
    """``q_reduce_leaf`` (int8 and exact) and ``loco_reduce_leaf`` per leaf
    against JAX's in a ``shard_map`` over the same mesh (world 2): the int8
    shards and LoCo residuals bit-equal, the exact reductions (and the
    replicated leaf's exact all-reduce) to fp32 reassociation."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.parallel import compressed as JC

    grads, errs = _leaf_inputs(world)
    sizes = {"data": world}
    for name, (_, spec) in LEAVES.items():
        jspec = P(*spec)
        for quant in (True, False):
            fn = shard_map(
                lambda g, q=quant: JC.q_reduce_leaf(
                    g[0], jspec, ("data",), world, sizes,
                    quant_grads=q)[None],
                mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                check_vma=False)
            want = np.asarray(fn(jnp.asarray(grads[name])))
            mine = np.stack([g["leaves"][f"quant={quant}"][name]
                             for g in got])
            if quant and spec != (None,):
                np.testing.assert_array_equal(mine, want, err_msg=name)
            else:
                np.testing.assert_allclose(mine, want, rtol=1e-6,
                                           atol=1e-6, err_msg=name)
        fn = shard_map(
            lambda g, e: tuple(o[None] for o in JC.loco_reduce_leaf(
                g[0], e[0], jspec, ("data",), world, sizes)),
            mesh=mesh, in_specs=(P("data"), P("data")),
            out_specs=(P("data"), P("data")), check_vma=False)
        want, want_err = (np.asarray(o) for o in fn(
            jnp.asarray(grads[name]), jnp.asarray(errs[name])))
        rel = np.abs(want).max()
        np.testing.assert_allclose(
            np.stack([g["leaves"]["loco"][name] for g in got]), want,
            rtol=0, atol=1e-6 * rel if spec == (None,) else 0, err_msg=name)
        np.testing.assert_array_equal(
            np.stack([g["leaves"]["loco_err"][name] for g in got]),
            want_err, err_msg=name)


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #

SEQ, STEPS, WORLD = 32, 3, 2
ZERO = {
    "stage1_exact": {"stage": 1},
    "stage2_exact": {"stage": 2},
    "stage2_qgz": {"stage": 2, "zero_quantized_gradients": True},
    "stage2_qgz_qwz": {"stage": 2, "zero_quantized_gradients": True,
                       "zero_quantized_weights": True},
    "stage2_qgz_qwz_loco": {"stage": 2, "zero_quantized_gradients": True,
                            "zero_quantized_weights": True,
                            "loco_error_feedback": True},
    # 20,000 elements a chunk: tiny's 49,984 a layer give the plan two
    # chunks, and qwZ quantizes each chunk's pieces on their own
    "stage2_qgz_qwz_chunked": {"stage": 2, "zero_quantized_gradients": True,
                               "zero_quantized_weights": True,
                               "allgather_bucket_size": 20000},
    "stage2_qgz_qwz_loco_chunked": {"stage": 2,
                                    "zero_quantized_gradients": True,
                                    "zero_quantized_weights": True,
                                    "loco_error_feedback": True,
                                    "allgather_bucket_size": 20000},
}
# Tolerances, measured on this CPU run (numpy seeds, 3 steps of AdamW at
# lr 1e-2 with gradient clipping). Adam's eps is 1e-3: at the default 1e-8
# an element whose gradient cancels to ~0 turns its reassociation noise
# (~1e-9) into a visible share of a step (up to 4.4e-4 of the master,
# measured). Exact wires: the same arithmetic in another order — losses
# within 1e-5 relative (measured 1.5e-7), every master element within 1e-5
# (measured 6.0e-8). int8 wires: a reassociated fp32 gradient can flip one
# int8 rounding, which moves that element by one quantization step
# (scale / world ≤ 5e-5 here) and its Adam update by at most lr · 5e-5 /
# eps = 5e-4 a step; the flipped elements then perturb the next steps'
# forward. Losses within 1e-5 (measured 6.1e-7), every master element
# within 3 steps of that, 1.5e-3 (measured 4.8e-4), the mean over elements
# within 2e-6 (measured 6.5e-7). LoCo's residual: a flipped element's
# residual moves by one quantization step, so within 2e-3 (measured
# 7.3e-4), the mean within 3e-6 (measured 8.8e-7).
TOL = {"exact": dict(loss=1e-5, master=1e-5, master_mean=1e-5),
       "int8": dict(loss=1e-5, master=1.5e-3, master_mean=2e-6,
                    err=2e-3, err_mean=3e-6)}


def _engine_config(zero):
    return {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 1e-2, "weight_decay": 0.01,
                                     "eps": 1e-3}},
            "gradient_clipping": 0.5, "zero_optimization": zero,
            "steps_per_print": 10 ** 6}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


@pytest.fixture(scope="module")
def jax_zero_runs(tmp_path_factory):
    """Each config's JAX engine at data = 2: initial master, losses, final
    master and LoCo residuals (numpy), wire format; pickled for the
    ranks."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh
    from deepspeed_tpu.runtime.dataloader import synthetic_lm_data

    runs = {}
    for name, zero in ZERO.items():
        spec = dst.causal_lm_spec("tiny",
                                  dtype="float32")
        mm = initialize_mesh(MeshConfig(data=WORLD),
                             devices=jax.devices()[:WORLD])
        engine, *_ = dst.initialize(model=spec, config=_engine_config(zero),
                                    mesh_manager=mm)
        master0 = jax.tree.map(np.asarray, engine.state["master"])
        data = synthetic_lm_data(WORLD, SEQ, 512, seed=3)
        losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
        runs[name] = {
            "master0": master0, "losses": losses,
            "master": jax.tree.map(np.asarray, engine.state["master"]),
            "loco_err": (jax.tree.map(np.asarray, engine.state["loco_err"])
                         if "loco_err" in engine.state else None),
            "wire": engine._wire_format(), "compressed": engine._compressed}
    path = tmp_path_factory.mktemp("jax_zero") / "runs.pkl"
    path.write_bytes(pickle.dumps(runs))
    return runs, path


def _engine_rank(rank, world, runs_path):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master
    from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

    runs = pickle.loads(open(runs_path, "rb").read())
    out = {}
    for name, zero in ZERO.items():
        spec = dtt.causal_lm_spec("tiny",
                                  dtype="float32")
        engine, *_ = dtt.initialize(model=spec, config=_engine_config(zero),
                                    device="cpu")
        load_master(engine, runs[name]["master0"])
        data = synthetic_lm_data(world, SEQ, 512, seed=3)
        losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
        err = engine.full_loco_err() if engine.loco_err is not None else None
        out[name] = {
            "type": type(engine).__name__, "losses": losses,
            "master": gather_master(engine),
            "loco_err": None if err is None else dict(
                (k, v) for k, v in _leaves(err)),
            "wire": engine._wire_format(), "compressed": engine._compressed,
            "micro_rows": engine.train_micro_batch_size()}
    return out


def test_engine_world2_matches_jax_engine(jax_zero_runs, tmp_path):
    runs, path = jax_zero_runs
    ranks = _spawn(_engine_rank, WORLD, tmp_path, str(path))
    for name in ZERO:
        want, got = runs[name], ranks[0][name]
        tol = TOL["exact" if want["wire"] == "exact" else "int8"]
        assert got["type"] == "DataParallelEngine"
        assert (got["wire"], got["compressed"]) == (want["wire"],
                                                    want["compressed"])
        assert ranks[1][name]["losses"] == got["losses"], name
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=tol["loss"], atol=0, err_msg=name)
        mine, theirs = dict(_leaves(got["master"])), dict(
            _leaves(want["master"]))
        assert sorted(mine) == sorted(theirs)
        diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                               for k in theirs])
        assert diff.max() <= tol["master"], (name, diff.max())
        assert diff.mean() <= tol["master_mean"], (name, diff.mean())
        if want["loco_err"] is not None:
            jerr = dict(_leaves(want["loco_err"]))
            ediff = np.concatenate([np.abs(got["loco_err"][k] - jerr[k])
                                    .ravel() for k in jerr])
            assert ediff.max() <= tol["err"], (name, ediff.max())
            assert ediff.mean() <= tol["err_mean"], (name, ediff.mean())
        else:
            assert got["loco_err"] is None


# Masked batches whose valid-token counts differ by rank: rank 0's row keeps
# every token, rank 1's a third of them, and in micro-batch 3 (step 2's
# first) rank 1 keeps none, in micro-batch 4 rank 0 none. JAX's exact step
# is one GSPMD step over the data-sharded micro-batch, so its loss divides
# by the global count of valid tokens; its int8 wire takes the mean of the
# ranks' own masked means (a pmean).
MASKED = ("stage1_exact", "stage2_exact", "stage2_qgz")


def _masked_batches(world):
    rng = np.random.default_rng(11)
    out = []
    for i in range(STEPS * 2):                 # gas 2
        mask = np.ones((world, SEQ), np.float32)
        mask[1] = (np.arange(SEQ) % 3 == 0)
        if i == 3:
            mask[1] = 0.0
        if i == 4:
            mask[0] = 0.0
        out.append({"tokens": rng.integers(0, 512, (world, SEQ),
                                           dtype=np.int32),
                    "loss_mask": mask})
    return out


@pytest.fixture(scope="module")
def masked_runs(tmp_path_factory):
    """The JAX engine at data = 2 and the port's world-2 engine (spawned
    ranks) on the masked batches, each config from the same initial
    master: {name: (jax run, [rank runs])}."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh

    runs = {}
    for name in MASKED:
        spec = dst.causal_lm_spec("tiny", dtype="float32")
        mm = initialize_mesh(MeshConfig(data=WORLD),
                             devices=jax.devices()[:WORLD])
        engine, *_ = dst.initialize(model=spec,
                                    config=_engine_config(ZERO[name]),
                                    mesh_manager=mm)
        master0 = jax.tree.map(np.asarray, engine.state["master"])
        data = iter(_masked_batches(WORLD))
        losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
        runs[name] = {"master0": master0, "losses": losses,
                      "master": jax.tree.map(np.asarray,
                                             engine.state["master"]),
                      "wire": engine._wire_format()}
    tmp = tmp_path_factory.mktemp("masked")
    path = tmp / "runs.pkl"
    path.write_bytes(pickle.dumps(runs))
    ranks = _spawn(_masked_engine_rank, WORLD, tmp, str(path))
    return {name: (runs[name], [r[name] for r in ranks]) for name in MASKED}


def _masked_engine_rank(rank, world, runs_path):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    runs = pickle.loads(open(runs_path, "rb").read())
    out = {}
    for name in MASKED:
        spec = dtt.causal_lm_spec("tiny", dtype="float32")
        engine, *_ = dtt.initialize(model=spec,
                                    config=_engine_config(ZERO[name]),
                                    device="cpu")
        load_master(engine, runs[name]["master0"])
        data = iter(_masked_batches(world))
        losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
        out[name] = {"losses": losses, "master": gather_master(engine),
                     "wire": engine._wire_format()}
    return out


@pytest.mark.parametrize("name", MASKED)
def test_engine_world2_masked_token_mean_matches_jax(masked_runs, name):
    """Uneven valid-token counts across ranks: the exact wire takes JAX's
    global masked token mean (losses and final master within
    ``TOL["exact"]``), the int8 wire JAX's mean of the ranks' means
    (``TOL["int8"]``)."""
    want, got = masked_runs[name]
    tol = TOL["exact" if want["wire"] == "exact" else "int8"]
    assert got[0]["wire"] == want["wire"]
    assert got[1]["losses"] == got[0]["losses"], name
    np.testing.assert_allclose(got[0]["losses"], want["losses"],
                               rtol=tol["loss"], atol=0, err_msg=name)
    mine, theirs = dict(_leaves(got[0]["master"])), dict(
        _leaves(want["master"]))
    assert sorted(mine) == sorted(theirs)
    diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                           for k in theirs])
    assert diff.max() <= tol["master"], (name, diff.max())
    assert diff.mean() <= tol["master_mean"], (name, diff.mean())


def test_world_one_warns_and_runs_the_exact_wire(caplog):
    """One process: qgZ / qwZ / LoCo warn as in JAX and the exact wire runs
    (the single-process engine)."""
    import deepspeed_tpu_torch as dtt

    spec = dtt.causal_lm_spec("tiny", dtype="float32")
    with caplog.at_level("WARNING", logger="deepspeed_tpu_torch"):
        engine, *_ = dtt.initialize(
            model=spec, config=_engine_config(ZERO["stage2_qgz_qwz_loco"]),
            device="cpu")
    assert type(engine).__name__ == "DeepSpeedTPUEngine"
    assert engine._wire_format() == "exact" and engine._compressed is None
    text = caplog.text
    assert "need data-parallel width > 1" in text
    assert "exact collectives used" in text
    assert "loco_error_feedback requires an ACTIVE" in text
    data = iter([{"tokens": np.zeros((1, SEQ), np.int32)}] * 2)
    assert np.isfinite(float(engine.train_batch(data)))


def test_a_rank_device_is_never_chosen_silently(monkeypatch):
    """A data-parallel rank runs on the caller's device, else
    ``cuda:{LOCAL_RANK}``; without either it raises, and a missing card
    raises too — never a silent ``cuda:0`` or CPU."""
    from deepspeed_tpu_torch.runtime.engine import rank_device

    assert rank_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="LOCAL_RANK"):
        rank_device(None)
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(RuntimeError, match="no CUDA device|does not exist"):
        rank_device(None)


# tiny_moe at world 2: the aux loss of each wire. JAX's exact step is one
# GSPMD program whose MoE layer averages the router statistics over the
# data axis before their product; its int8 step is a manual shard_map over
# data, where each rank takes its own aux and the step the ranks' mean.
MOE_ZERO = ("stage1_exact", "stage2_exact", "stage2_qgz")


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """The JAX engine at data = 2 and the port's world-2 engine (spawned
    ranks) on tiny_moe, each config from the same initial master: {name:
    (jax run, [rank runs])}."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh
    from deepspeed_tpu.runtime.dataloader import synthetic_lm_data

    runs = {}
    for name in MOE_ZERO:
        spec = dst.causal_lm_spec("tiny_moe", dtype="float32")
        mm = initialize_mesh(MeshConfig(data=WORLD),
                             devices=jax.devices()[:WORLD])
        engine, *_ = dst.initialize(model=spec,
                                    config=_engine_config(ZERO[name]),
                                    mesh_manager=mm)
        JM.set_mesh(mm.mesh)          # the MoE layer lowers by it
        master0 = jax.tree.map(np.asarray, engine.state["master"])
        data = synthetic_lm_data(WORLD, SEQ, 512, seed=3)
        losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
        runs[name] = {"master0": master0, "losses": losses,
                      "master": jax.tree.map(np.asarray,
                                             engine.state["master"]),
                      "wire": engine._wire_format()}
        JM.reset_mesh()
    tmp = tmp_path_factory.mktemp("moe")
    path = tmp / "runs.pkl"
    path.write_bytes(pickle.dumps(runs))
    ranks = _spawn(_moe_engine_rank, WORLD, tmp, str(path))
    return {name: (runs[name], [r[name] for r in ranks]) for name in MOE_ZERO}


def _moe_engine_rank(rank, world, runs_path):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master
    from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

    runs = pickle.loads(open(runs_path, "rb").read())
    out = {}
    for name in MOE_ZERO:
        spec = dtt.causal_lm_spec("tiny_moe", dtype="float32")
        engine, *_ = dtt.initialize(model=spec,
                                    config=_engine_config(ZERO[name]),
                                    device="cpu")
        load_master(engine, runs[name]["master0"])
        data = synthetic_lm_data(world, SEQ, 512, seed=3)
        losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
        out[name] = {"losses": losses, "master": gather_master(engine),
                     "wire": engine._wire_format()}
        engine.close()
    return out


@pytest.mark.parametrize("name", MOE_ZERO)
def test_engine_world2_moe_aux_matches_jax(moe_runs, name):
    """tiny_moe at world 2: losses and the final master within ``TOL`` of
    the JAX engine at data = 2 — the exact wires with JAX's global aux
    loss, the int8 wire with the ranks' mean of their own."""
    want, got = moe_runs[name]
    tol = TOL["exact" if want["wire"] == "exact" else "int8"]
    assert got[0]["wire"] == want["wire"]
    assert got[1]["losses"] == got[0]["losses"], name
    np.testing.assert_allclose(got[0]["losses"], want["losses"],
                               rtol=tol["loss"], atol=0, err_msg=name)
    mine, theirs = dict(_leaves(got[0]["master"])), dict(
        _leaves(want["master"]))
    assert sorted(mine) == sorted(theirs)
    diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                           for k in theirs])
    assert diff.max() <= tol["master"], (name, diff.max())
    assert diff.mean() <= tol["master_mean"], (name, diff.mean())
