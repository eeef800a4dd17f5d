"""ZeRO-3 and the overlap scheduler's plan of the PyTorch port against the
JAX package.

A file of its own, so that xdist's ``--dist loadfile`` runs its spawned
ranks beside ``test_torch_zero.py``'s; it reuses that file's helpers (the
gloo ranks with their time limits, the engine config, the tolerances).
The ranks are spawned once, by a module fixture, for every world-2 case.

* ``parallel/overlap.py`` against JAX's: ``plan_buckets``, ``chunk_layers``
  and ``even_chunk_bounds`` over a grid of inputs, ``leaf_count`` and
  ``OverlapConfig``.
* The world-2 ``Zero3Engine`` against the JAX engine at ``data = 2`` (tiny,
  fp32, remat full so the backward's recompute gathers again, the JAX
  initial master carried over, the same global batches for 3 steps):
  exact ZeRO-3 with one chunk and with two (``stage3_prefetch_bucket_size``
  20,000 against tiny's 49,984 elements a layer), qgZ + qwZ with one
  chunk, qgZ + qwZ + LoCo with two, qgZ + qwZ with ``overlap_comm`` off
  (JAX's straight-through step: whole-leaf qwZ), and exact ZeRO-3 on
  ``test_torch_zero``'s masked batches; ``overlap_plan()`` equal to JAX's
  on each config.
* ``overlap_comm`` off against on: losses and master bit-equal.
* The one-process engine at stage 3 against JAX at ``data = 1``.
* Port ZeRO-3 against port ZeRO-2 in bf16 at world 2 from one master: the
  first loss bit-equal (the gathered bf16 parameters are the same bits).
* Memory: after ``train_batch`` the ZeRO-3 engine holds no full-size
  compute or gradient buffer: its persistent tensors' elements against
  the ZeRO-2 engine's; a dropped engine is freed at once.
* bf16 ZeRO-3, and fp16 ZeRO-3 with the loss-scaled qgZ + qwZ wire, at
  world 2 against JAX (``LOW_VS_JAX``): each no further from JAX's fp32
  run than twice JAX's own run at that precision; the fp16 overflow skips
  JAX's.
* ZeRO-3 for a spec without the parameter hook (a two-layer MLP with a
  regression loss, built in both packages): exact and int8 wires against
  JAX at ``data = 2`` by ``TOL``, one gather and one reduce a micro-batch.
* The per-leaf gathers of ``parallel/compressed.py`` (``gather_with_
  compressed_vjp`` forward and backward, exact and int8;
  ``chunked_gather_tree_fn`` and ``publish_gather_tree_fn``) against
  JAX's in a ``shard_map``, and the engine's packed group gathers against
  ``chunked_gather_tree_fn``.
"""
import pickle
import weakref

import numpy as np
import pytest
import torch

from test_torch_zero import (
    LEAVES,
    SEQ,
    STEPS,
    TOL,
    WORLD,
    _engine_config,
    _leaves,
    _masked_batches,
    _spawn,
)

INT8 = {"zero_quantized_gradients": True, "zero_quantized_weights": True}
ZERO3 = {
    "stage3_exact": {"stage": 3},
    "stage3_exact_chunked": {"stage": 3,
                             "stage3_prefetch_bucket_size": 20000},
    "stage3_qgz_qwz": dict(INT8, stage=3),
    "stage3_qgz_qwz_loco_chunked": dict(INT8, stage=3,
                                        loco_error_feedback=True,
                                        stage3_prefetch_bucket_size=20000),
    # overlap_comm off: JAX's straight-through step, whole-leaf qwZ
    "stage3_qgz_qwz_no_overlap": dict(INT8, stage=3, overlap_comm=False,
                                      stage3_prefetch_bucket_size=20000),
}
MASKED3 = "stage3_exact"
# bf16 ZeRO-3 and fp16 with the loss-scaled int8 wire against JAX: name →
# (zero config, dtype, the fp32 case of the same config)
LOW = {"bf16_stage3_exact": ({"stage": 3}, "bfloat16", "stage3_exact"),
       "fp16_stage3_qgz_qwz": (dict(INT8, stage=3), "float16",
                               "stage3_qgz_qwz")}
# A low-precision run against JAX's: both round every activation to 16 bits
# in different places (XLA fuses, PyTorch does not), so each is held to
# JAX's fp32 run of the same config instead: the port no further from it
# than LOW_VS_JAX times JAX's own low-precision run, metric by metric
# (the losses, the master's largest and mean distance), a distance below
# TOL["exact"]'s limit counting as that limit.
LOW_VS_JAX = 2.0
# ZeRO-3 for a spec other than causal_lm_spec's: a two-layer MLP with a
# regression loss, made the same way in both packages; the whole tree is
# one gather group
MLP_D, MLP_H = 64, 256
MLP = {"mlp_exact": {"stage": 3}, "mlp_qgz_qwz": dict(INT8, stage=3)}
# overlap_comm off against on (bit-equal): the exact chunked wire and the
# one-chunk int8 wire
OVERLAP_OFF = ("stage3_exact_chunked", "stage3_qgz_qwz")
CHUNKS = [(0, 1), (1, 2)]


def _mlp_axes():
    return {"b1": (None,), "b2": (None,), "w1": (None, None),
            "w2": (None, None)}


def _jax_mlp_spec():
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models.api import ModelSpec

    def init_fn(rng):
        k1, k2 = jax.random.split(rng)
        return {"w1": jax.random.normal(k1, (MLP_D, MLP_H)) * 0.05,
                "b1": jnp.zeros((MLP_H,)),
                "w2": jax.random.normal(k2, (MLP_H, MLP_D)) * 0.05,
                "b2": jnp.zeros((MLP_D,))}

    def loss_fn(p, batch):
        h = jnp.tanh(batch["x"] @ p["w1"] + p["b1"])
        return jnp.mean(jnp.square(h @ p["w2"] + p["b2"] - batch["y"]))

    return ModelSpec(init_fn=init_fn, loss_fn=loss_fn, axes_fn=_mlp_axes,
                     name="mlp")


def _port_mlp_spec():
    import deepspeed_tpu_torch as dtt

    def init_fn(gen, device):
        return {"w1": torch.randn(MLP_D, MLP_H, generator=gen,
                                  device=device) * 0.05,
                "b1": torch.zeros(MLP_H, device=device),
                "w2": torch.randn(MLP_H, MLP_D, generator=gen,
                                  device=device) * 0.05,
                "b2": torch.zeros(MLP_D, device=device)}

    def loss_fn(p, batch):
        h = torch.tanh(batch["x"] @ p["w1"] + p["b1"])
        return torch.mean(torch.square(h @ p["w2"] + p["b2"] - batch["y"]))

    return dtt.ModelSpec(init_fn=init_fn, loss_fn=loss_fn, axes_fn=_mlp_axes,
                         name="mlp")


def _mlp_batches(world):
    rng = np.random.default_rng(4)
    gas = _engine_config({})["gradient_accumulation_steps"]
    return [{"x": rng.normal(size=(world, MLP_D)).astype(np.float32),
             "y": rng.normal(size=(world, MLP_D)).astype(np.float32)}
            for _ in range(STEPS * gas)]


# --------------------------------------------------------------------------- #
# the plan's pure functions
# --------------------------------------------------------------------------- #

def _plan_grid():
    rng = np.random.default_rng(5)
    sizes = [list(rng.integers(1, 500, n)) for n in (0, 1, 4, 7, 13)]
    return sizes, [1, 50, 400, 1000, 10 ** 6]


@pytest.mark.parametrize("fn", ["plan_buckets", "chunk_layers",
                                "even_chunk_bounds", "leaf_count_config"])
def test_overlap_functions_match_jax(fn):
    """The port's copies give JAX's plans over a grid of inputs."""
    from deepspeed_tpu.parallel import overlap as JO
    from deepspeed_tpu.runtime.config import ZeroConfig as JZero

    from deepspeed_tpu_torch.parallel import overlap as PO
    from deepspeed_tpu_torch.runtime.config import ZeroConfig as PZero

    sizes, bounds = _plan_grid()
    if fn == "plan_buckets":
        for sz in sizes:
            for b in bounds:
                assert PO.plan_buckets(sz, b) == JO.plan_buckets(sz, b)
                order = list(np.random.default_rng(len(sz)).permutation(
                    len(sz)))
                assert PO.plan_buckets(sz, b, order) == \
                    JO.plan_buckets(sz, b, order)
        for bad in ((([4, 4], 8, [0, 0])), (([4], 0, None))):
            for mod in (PO, JO):
                with pytest.raises(ValueError):
                    mod.plan_buckets(*bad)
    elif fn == "chunk_layers":
        for L in (0, 1, 2, 7, 12, 20, 100):
            for per in (0, 1, 100, 28_311_552, 49_984):
                for size in (0, 1, 300, 20_000, 5 * 10 ** 7, 5 * 10 ** 8):
                    for cap in (1, 3, PO.MAX_LAYER_CHUNKS):
                        assert PO.chunk_layers(L, per, size, cap) == \
                            JO.chunk_layers(L, per, size, cap), (L, per, size)
        assert PO.MAX_LAYER_CHUNKS == JO.MAX_LAYER_CHUNKS
        # llama_750m at the defaults: ZeRO-3's 8 chunks, ZeRO-2's 2
        assert PO.chunk_layers(20, 28_311_552, 5 * 10 ** 7) == \
            PO.even_chunk_bounds(20, 8)
        assert PO.chunk_layers(20, 28_311_552, 5 * 10 ** 8) == \
            [(0, 10), (10, 20)]
    elif fn == "even_chunk_bounds":
        for n in range(0, 25):
            for k in range(-1, 12):
                assert PO.even_chunk_bounds(n, k) == \
                    JO.even_chunk_bounds(n, k), (n, k)
    else:
        for shape in ((), (3,), (4, 8), (2, 3, 5)):
            assert PO.leaf_count(shape) == JO.leaf_count(shape)
        for kw, stage in (({"stage": 2}, 2), ({"stage": 2}, 0),
                          ({"stage": 3, "overlap_comm": False}, 3),
                          ({"stage": 3, "reduce_bucket_size": 5e8,
                            "stage3_prefetch_bucket_size": "auto"}, 3)):
            pz, jz = PZero(**kw), JZero(**kw)
            pz.validate()
            jz.validate()
            assert dict(vars(PO.OverlapConfig.from_zero_config(pz, stage))) \
                == dict(vars(JO.OverlapConfig.from_zero_config(jz, stage)))


# --------------------------------------------------------------------------- #
# the JAX runs, then every world-2 case in one spawn
# --------------------------------------------------------------------------- #

def _precision(cfg, dtype):
    """The engine config's precision section for a compute dtype."""
    if dtype == "bfloat16":
        cfg["bf16"] = {"enabled": True}
    elif dtype == "float16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 8}
    return cfg


def _jax_engine(zero, data, dtype="float32", spec=None):
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh

    spec = spec or dst.causal_lm_spec("tiny", dtype=dtype)
    mm = initialize_mesh(MeshConfig(data=data), devices=jax.devices()[:data])
    engine, *_ = dst.initialize(
        model=spec, config=_precision(_engine_config(zero), dtype),
        mesh_manager=mm)
    return engine


def _jax_run(engine, data):
    import jax

    master0 = jax.tree.map(np.asarray, engine.state["master"])
    losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
    return {"master0": master0, "losses": losses,
            "master": jax.tree.map(np.asarray, engine.state["master"]),
            "loco_err": (jax.tree.map(np.asarray, engine.state["loco_err"])
                         if "loco_err" in engine.state else None),
            "wire": engine._wire_format(), "compressed": engine._compressed,
            "plan": engine.overlap_plan(), "skips": int(engine.skipped_steps)}


@pytest.fixture(scope="module")
def zero3_runs(tmp_path_factory):
    """JAX at data = 2 for each ZERO3 config and the masked case, JAX at
    data = 1 for the one-process case; then the port's world-2 ranks for
    every case. → (jax runs, [rank results])."""
    from deepspeed_tpu.runtime.dataloader import synthetic_lm_data

    runs = {}
    for name, zero in ZERO3.items():
        runs[name] = _jax_run(_jax_engine(zero, WORLD),
                              synthetic_lm_data(WORLD, SEQ, 512, seed=3))
    runs["masked"] = _jax_run(_jax_engine(ZERO3[MASKED3], WORLD),
                              iter(_masked_batches(WORLD)))
    runs["world1"] = _jax_run(_jax_engine(ZERO3["stage3_exact"], 1),
                              synthetic_lm_data(1, SEQ, 512, seed=3))
    for name, (zero, dtype, _) in LOW.items():
        runs[name] = _jax_run(_jax_engine(zero, WORLD, dtype),
                              synthetic_lm_data(WORLD, SEQ, 512, seed=3))
    for name, zero in MLP.items():
        runs[name] = _jax_run(_jax_engine(zero, WORLD, spec=_jax_mlp_spec()),
                              iter(_mlp_batches(WORLD)))
    tmp = tmp_path_factory.mktemp("zero3")
    path = tmp / "runs.pkl"
    path.write_bytes(pickle.dumps(runs))
    return runs, _spawn(_zero3_rank, WORLD, tmp, str(path))


def _port_run(zero, master0, data, dtype="float32", spec=None, **overrides):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    spec = spec or dtt.causal_lm_spec("tiny", dtype=dtype, remat="full")
    cfg = _precision(_engine_config(dict(zero, **overrides)), dtype)
    engine, *_ = dtt.initialize(model=spec, config=cfg, device="cpu")
    load_master(engine, master0)
    losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
    err = (engine.full_loco_err()
           if getattr(engine, "loco_err", None) is not None else None)
    return engine, {
        "type": type(engine).__name__, "losses": losses,
        "master": gather_master(engine),
        "loco_err": None if err is None else dict(_leaves(err)),
        "wire": engine._wire_format(), "compressed": engine._compressed,
        "plan": engine.overlap_plan(), "skips": engine.skipped_steps,
        "counts": dict(getattr(engine, "_zero3", None).counts)
        if hasattr(engine, "_zero3") else None}


def _persistent_elements(engine):
    """Elements of the tensors an engine keeps between steps: its own
    attributes, the optimizer state, and ZeRO-3's coordinator."""
    seen, total = set(), 0
    objs = list(vars(engine).values()) + list(
        engine.state["opt"].values())
    if hasattr(engine, "_zero3"):
        objs += list(vars(engine._zero3).values())
    for v in objs:
        if isinstance(v, torch.Tensor) and id(v) not in seen:
            seen.add(id(v))
            total += v.numel()
    return total


def _zero3_rank(rank, world, runs_path):
    from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

    runs = pickle.loads(open(runs_path, "rb").read())
    out = {}
    for name, zero in ZERO3.items():
        _, out[name] = _port_run(zero, runs[name]["master0"],
                                 synthetic_lm_data(world, SEQ, 512, seed=3))
    _, out["masked"] = _port_run(ZERO3[MASKED3], runs["masked"]["master0"],
                                 iter(_masked_batches(world)))
    for name in OVERLAP_OFF:
        _, out[f"{name}/overlap_off"] = _port_run(
            ZERO3[name], runs[name]["master0"],
            synthetic_lm_data(world, SEQ, 512, seed=3), overlap_comm=False)
    master0 = runs["stage3_exact"]["master0"]
    for stage in (2, 3):
        engine, out[f"bf16_stage{stage}"] = _port_run(
            {"stage": stage}, master0,
            synthetic_lm_data(world, SEQ, 512, seed=3), dtype="bfloat16")
        out[f"bf16_stage{stage}"]["persistent"] = _persistent_elements(
            engine)
        out[f"bf16_stage{stage}"]["full"] = engine._numel
        out[f"bf16_stage{stage}"]["buffers"] = {
            k: getattr(engine, k) is not None
            for k in ("flat_compute", "flat_grad", "_packed")}
        ref = weakref.ref(engine)
        del engine
        out[f"bf16_stage{stage}"]["freed"] = ref() is None
    for name, (zero, dtype, _) in LOW.items():
        _, out[name] = _port_run(zero, runs[name]["master0"],
                                 synthetic_lm_data(world, SEQ, 512, seed=3),
                                 dtype=dtype)
    for name, zero in MLP.items():
        _, out[name] = _port_run(zero, runs[name]["master0"],
                                 iter(_mlp_batches(world)),
                                 spec=_port_mlp_spec())
    out["leaf_wire"] = _leaf_gathers(rank, world)
    out["groups"] = _group_gathers(rank, world, master0)
    return out


def _leaf_gathers(rank, world):
    """``gather_with_compressed_vjp`` on ``LEAVES`` (sharded on dim 0, on
    dim 1, replicated): the gathered leaf and the gradient of a per-rank
    cotangent, for exact and int8 both ways."""
    from deepspeed_tpu_torch.parallel import compressed as C

    rng = np.random.default_rng(21)
    out = {}
    for name, (shape, spec) in LEAVES.items():
        full = rng.standard_normal(shape).astype(np.float32)
        cot = rng.standard_normal((world,) + shape).astype(np.float32)
        dim = C.sharded_dim(spec, ("data",))
        x = torch.from_numpy(full)
        if dim is not None:
            x = torch.chunk(x, world, dim=dim)[rank]
        for quant in (False, True):
            fn = C.gather_with_compressed_vjp(dim, ("data",), world,
                                              torch.float32, quant, quant)
            xl = x.clone().requires_grad_(True)
            y = fn(xl)
            y.backward(torch.from_numpy(cot[rank]))
            out[(name, quant)] = (y.detach().numpy(), xl.grad.numpy())
    return out


def _group_gathers(rank, world, master0):
    """``chunked_gather_tree_fn`` (qwZ, two chunks) and
    ``publish_gather_tree_fn`` (exact, one chunk) on the tiny model's
    stage-3 specs from ``master0``'s shards; and the engine's packed group
    gathers (int8, the same chunks) of the same master."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.models.convert import load_master
    from deepspeed_tpu_torch.parallel import compressed as C
    from deepspeed_tpu_torch.parallel import stage3 as S3
    from deepspeed_tpu_torch.parallel.partitioning import ShardingPolicy

    cfg = T.get_model_config("tiny", dtype="float32")
    shapes = {}
    for path, v in _leaves(master0):
        d = shapes
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = np.asarray(v).shape
    specs = ShardingPolicy({"data": world}, 3).param_spec(
        T.param_logical_axes(cfg), shapes)

    def local(tree, spec):
        if isinstance(tree, dict):
            return {k: local(tree[k], spec[k]) for k in tree}
        t = torch.from_numpy(np.asarray(tree))
        dim = C.sharded_dim(spec, ("data",))
        return t if dim is None else torch.chunk(t, world, dim)[rank]

    shards = local(master0, specs)
    chunked = C.chunked_gather_tree_fn(specs, ("data",), world,
                                       torch.float32, True, CHUNKS,
                                       axis_sizes={"data": world})(shards)
    published = C.publish_gather_tree_fn(specs, ("data",), world,
                                         torch.float32, False)(shards)
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec("tiny", dtype="float32"),
        config=_engine_config(dict(INT8, stage=3,
                                   stage3_prefetch_bucket_size=20000)),
        device="cpu")
    load_master(engine, master0)
    packed = {}
    for grp in engine._zero3.groups:
        rows = S3.gather_group(grp, engine, engine.flat_master, True)
        S3.unpack(grp, rows, world, lambda p: packed.setdefault(
            (p.path, p.layers), torch.empty(p.shape())))
    joined = {}
    for (path, layers), t in sorted(packed.items(), key=lambda kv: (
            kv[0][0], kv[0][1] or (0, 0))):
        joined.setdefault(path, []).append(t)
    engine.close()
    return {"chunked": dict(_leaves(chunked)),
            "published": dict(_leaves(published)),
            "engine": {"/" + "/".join(p): torch.cat(v).numpy()
                       for p, v in joined.items()},
            "n_groups": len(engine._zero3.groups)}


# --------------------------------------------------------------------------- #
# the checks
# --------------------------------------------------------------------------- #

def _check_run(want, got, name):
    tol = TOL["exact" if want["wire"] == "exact" else "int8"]
    assert (got["wire"], got["compressed"]) == (want["wire"],
                                                want["compressed"])
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=tol["loss"], atol=0, err_msg=name)
    mine, theirs = dict(_leaves(got["master"])), dict(_leaves(want["master"]))
    assert sorted(mine) == sorted(theirs)
    diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                           for k in theirs])
    assert diff.max() <= tol["master"], (name, diff.max())
    assert diff.mean() <= tol["master_mean"], (name, diff.mean())
    if want["loco_err"] is not None:
        jerr = dict(_leaves(want["loco_err"]))
        ediff = np.concatenate([np.abs(got["loco_err"][k] - jerr[k]).ravel()
                                for k in jerr])
        assert ediff.max() <= tol["err"], (name, ediff.max())
        assert ediff.mean() <= tol["err_mean"], (name, ediff.mean())
    else:
        assert got["loco_err"] is None


PLAN_KEYS = ("enabled", "scan_chunks", "chunk_bounds", "grad_sync_points",
             "reduce_bucket_elems", "allgather_bucket_elems",
             "prefetch_bucket_elems", "update_bucket_elems", "wire_format")


@pytest.mark.parametrize("name", list(ZERO3))
def test_stage3_world2_matches_jax_engine(zero3_runs, name):
    """Losses, master (and LoCo residual) within ``TOL`` of JAX's at
    ``data = 2``; both ranks' losses equal; the plan equal to JAX's; the
    gathers and reduces a step the plan's count."""
    runs, ranks = zero3_runs
    want, got = runs[name], ranks[0][name]
    assert got["type"] == "Zero3Engine"
    assert ranks[1][name]["losses"] == got["losses"], name
    _check_run(want, got, name)
    assert {k: got["plan"][k] for k in PLAN_KEYS} == \
        {k: want["plan"][k] for k in PLAN_KEYS}
    # the step phase's flags too (JAX engine.py:749-757)
    assert got["plan"] == want["plan"]
    chunks = max(len(want["plan"]["chunk_bounds"]), 1)
    gas = _engine_config({})["gradient_accumulation_steps"]
    assert got["counts"] == {
        "gather_fwd": gas * (1 + chunks), "gather_bwd": gas * chunks,
        "reduce": 0 if want["wire"] != "exact" else gas * (1 + chunks)}


def test_stage3_world2_masked_token_mean_matches_jax(zero3_runs):
    """Uneven valid-token counts across ranks: exact ZeRO-3 takes JAX's
    global masked token mean."""
    runs, ranks = zero3_runs
    assert ranks[1]["masked"]["losses"] == ranks[0]["masked"]["losses"]
    _check_run(runs["masked"], ranks[0]["masked"], "masked")


@pytest.mark.parametrize("name", OVERLAP_OFF)
def test_overlap_comm_off_gives_the_same_bits(zero3_runs, name):
    """``overlap_comm`` only moves when a gather is submitted: losses and
    master bit-equal to the overlapped run."""
    _, ranks = zero3_runs
    on, off = ranks[0][name], ranks[0][f"{name}/overlap_off"]
    assert off["plan"]["enabled"] is False
    assert off["losses"] == on["losses"]
    for (k, a), (_, b) in zip(_leaves(on["master"]), _leaves(off["master"])):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_stage3_bf16_matches_stage2(zero3_runs):
    """bf16 at world 2 from one master: ZeRO-3's first loss is ZeRO-2's
    bit for bit (the gathered bf16 parameters are the published ones);
    later steps and the master differ by the reduce's order only."""
    _, ranks = zero3_runs
    s2, s3 = ranks[0]["bf16_stage2"], ranks[0]["bf16_stage3"]
    assert s3["type"] == "Zero3Engine" and s2["type"] == "DataParallelEngine"
    assert s3["losses"][0] == s2["losses"][0]
    np.testing.assert_allclose(s3["losses"], s2["losses"], rtol=1e-3)
    mine, theirs = dict(_leaves(s3["master"])), dict(_leaves(s2["master"]))
    diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                           for k in theirs])
    # a bf16 gradient summed in another order moves an Adam step of lr
    # 1e-2 by at most a few ulps of its fp32 sum at eps 1e-3
    assert diff.max() <= 2e-3 and diff.mean() <= 2e-5, (diff.max(),
                                                        diff.mean())


def test_stage3_holds_no_full_compute_or_gradient_buffer(zero3_runs):
    """After ``train_batch``: no full compute copy, no full gradient and
    no packed rows on ZeRO-3's exact wire; its persistent tensors hold
    less than ZeRO-2's by at least those three (a full compute copy, a
    full gradient, [world, n_sh] fp32 rows: about 3 full-size buffers)."""
    _, ranks = zero3_runs
    for r in ranks:
        s2, s3 = r["bf16_stage2"], r["bf16_stage3"]
        assert s2["buffers"] == {"flat_compute": True, "flat_grad": True,
                                 "_packed": True}
        assert s3["buffers"] == {"flat_compute": False, "flat_grad": False,
                                 "_packed": False}
        assert s2["full"] == s3["full"]
        # a dropped engine frees its buffers at once (no reference cycle)
        assert s2["freed"] and s3["freed"]
        assert s2["persistent"] - s3["persistent"] >= 3 * s3["full"] - \
            s3["full"] // 4, (s2["persistent"], s3["persistent"])


def test_one_process_stage3_matches_jax_data1(zero3_runs):
    """One process at stage 3 shards nothing and runs the stage-0 step, as
    JAX at ``data = 1``; its plan is JAX's."""
    from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

    runs, _ = zero3_runs
    want = runs["world1"]
    engine, got = _port_run(ZERO3["stage3_exact"], want["master0"],
                            synthetic_lm_data(1, SEQ, 512, seed=3))
    assert got["type"] == "DeepSpeedTPUEngine"
    _check_run(want, got, "world1")
    assert {k: got["plan"][k] for k in PLAN_KEYS} == \
        {k: want["plan"][k] for k in PLAN_KEYS}


def _close_ulps(got, want, msg):
    """The int8 wire against JAX's jitted reference: XLA may compute the
    scale's division and contract q · scale (and the qgZ sum) otherwise
    than the eager ops, so each element within 4 fp32 ulps of the leaf's
    largest value (a quantization step is 2^16 times that)."""
    atol = 4 * np.finfo(np.float32).eps * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


def test_leaf_gathers_match_jax(zero3_runs):
    """``gather_with_compressed_vjp`` against JAX's in a ``shard_map``:
    the exact gather bit-equal and its reduce-scatter to fp32
    reassociation; the qwZ gather and the qgZ reduce to a few ulps."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh
    from deepspeed_tpu.parallel import compressed as JC

    _, ranks = zero3_runs
    mesh = initialize_mesh(MeshConfig(data=WORLD),
                           devices=jax.devices()[:WORLD]).mesh
    rng = np.random.default_rng(21)
    for name, (shape, spec) in LEAVES.items():
        full = rng.standard_normal(shape).astype(np.float32)
        cot = rng.standard_normal((WORLD,) + shape).astype(np.float32)
        dim = JC.sharded_dim(P(*spec), ("data",))
        for quant in (False, True):
            fn = JC.gather_with_compressed_vjp(dim, ("data",), WORLD,
                                               jnp.float32, quant, quant)

            def local(x, g, fn=fn):
                y, vjp = jax.vjp(fn, x)
                return y[None], vjp(g[0])[0]

            sm = jax.jit(shard_map(local, mesh=mesh,
                                   in_specs=(P(*spec), P("data")),
                                   out_specs=(P("data"), P(*spec)),
                                   check_vma=False))
            y, dx = (np.asarray(o) for o in sm(jnp.asarray(full),
                                                jnp.asarray(cot)))
            for r, got in enumerate(ranks):
                gy, gdx = got["leaf_wire"][(name, quant)]
                want_dx = dx if dim is None else np.split(
                    dx, WORLD, axis=dim)[r]
                if quant:
                    _close_ulps(gy, y[r], name)
                    _close_ulps(gdx, want_dx, name)
                else:
                    np.testing.assert_array_equal(gy, y[r], err_msg=name)
                    np.testing.assert_allclose(gdx, want_dx, rtol=1e-6,
                                               atol=1e-6, err_msg=name)


def test_chunked_gathers_match_jax(zero3_runs):
    """``chunked_gather_tree_fn`` (qwZ, two chunks; to a few ulps) and
    ``publish_gather_tree_fn`` (exact; bit for bit) against JAX's on the
    tiny model's stage-3 specs; the engine's packed group gathers give the
    per-leaf chunked gather's values bit for bit."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh
    from deepspeed_tpu.parallel import compressed as JC

    runs, ranks = zero3_runs
    engine = _jax_engine(ZERO3["stage3_exact"], WORLD)
    mesh = initialize_mesh(MeshConfig(data=WORLD),
                           devices=jax.devices()[:WORLD]).mesh
    spec = engine.param_spec
    manual = jax.tree.map(lambda s: JC.manual_spec(s, ("data",)), spec,
                          is_leaf=lambda x: isinstance(x, P))
    rep = jax.tree.map(lambda s: P(), spec, is_leaf=lambda x: isinstance(x, P))
    master0 = jax.tree.map(jnp.asarray, runs["stage3_exact"]["master0"])
    for key, fn in (
            ("chunked", JC.chunked_gather_tree_fn(
                spec, ("data",), WORLD, jnp.float32, True, CHUNKS,
                axis_sizes={"data": WORLD})),
            ("published", JC.publish_gather_tree_fn(
                spec, ("data",), WORLD, jnp.float32, False,
                axis_sizes={"data": WORLD}))):
        want = dict(_leaves(jax.tree.map(np.asarray, jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(manual,), out_specs=rep,
            check_vma=False))(master0))))
        for got in ranks:
            assert sorted(got["groups"][key]) == sorted(want)
            for k in want:
                if key == "chunked":
                    _close_ulps(got["groups"][key][k], want[k], k)
                else:
                    np.testing.assert_array_equal(got["groups"][key][k],
                                                  want[k], err_msg=k)
    for got in ranks:
        g = got["groups"]
        assert g["n_groups"] == 1 + len(CHUNKS)
        assert sorted(g["engine"]) == sorted(g["chunked"])
        for k, v in g["chunked"].items():
            np.testing.assert_array_equal(g["engine"][k], v, err_msg=k)


def _distances(got, want):
    """(largest relative loss distance, the master's largest and mean
    absolute distance) of one run from another."""
    loss = np.max(np.abs(np.asarray(got["losses"]) - want["losses"])
                  / np.abs(want["losses"]))
    mine, theirs = dict(_leaves(got["master"])), dict(_leaves(want["master"]))
    diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                           for k in theirs])
    return np.array([loss, diff.max(), diff.mean()])


@pytest.mark.parametrize("name", list(LOW))
def test_low_precision_stage3_matches_jax(zero3_runs, name):
    """bf16 ZeRO-3 and fp16 ZeRO-3 with the loss-scaled qgZ + qwZ wire at
    world 2: no further from JAX's fp32 run than ``LOW_VS_JAX`` times
    JAX's own run at that precision, metric by metric."""
    runs, ranks = zero3_runs
    _, _, ref = LOW[name]
    got, want = ranks[0][name], runs[name]
    assert ranks[1][name]["losses"] == got["losses"]
    assert (got["wire"], got["compressed"]) == (want["wire"],
                                                want["compressed"])
    # the same fp16 overflow skips as JAX's, and not every step skipped
    assert got["skips"] == want["skips"] < STEPS
    floor = np.array([TOL["exact"]["loss"], TOL["exact"]["master"],
                      TOL["exact"]["master_mean"]])
    theirs = np.maximum(_distances(want, runs[ref]), floor)
    mine = _distances(got, runs[ref])
    assert np.all(mine <= LOW_VS_JAX * theirs), (name, mine, theirs)


@pytest.mark.parametrize("name", list(MLP))
def test_stage3_any_spec_matches_jax(zero3_runs, name):
    """ZeRO-3 for a spec without the parameter hook (an MLP built in the
    test): its tree gathered as one group a forward and its gradient
    reduced after the backward, against JAX at ``data = 2`` by ``TOL``;
    a rank holds only its shards between steps."""
    runs, ranks = zero3_runs
    got = ranks[0][name]
    assert got["type"] == "Zero3Engine"
    assert ranks[1][name]["losses"] == got["losses"]
    _check_run(runs[name], got, name)
    gas = _engine_config({})["gradient_accumulation_steps"]
    assert got["counts"] == {
        "gather_fwd": gas, "gather_bwd": 0,
        "reduce": gas if runs[name]["wire"] == "exact" else 0}
    assert got["plan"] == runs[name]["plan"]
