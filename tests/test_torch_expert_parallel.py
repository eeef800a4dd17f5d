"""Expert parallelism of the PyTorch port against the JAX package.

Ranks run as spawned gloo processes (``test_torch_zero``'s rank entry, each
joined under ``RANK_TIMEOUT``); JAX runs the same meshes on the conftest's
CPU devices while they run (its layer cases in a process of their own). One
spawn a world runs every port case:

* ``moe_ffn`` alone, the ragged dispatch with the expert all-to-all, at
  ``{expert: 2}`` and ``{data: 2, expert: 2}`` against JAX's ``moe_ffn``
  on the same mesh (``tests/unit/test_moe.py:277``'s pattern): each rank
  gives its rows of the batch, the whole router and its own experts, and
  differentiates ``Σ y² + aux`` of its rows; JAX differentiates the ranks'
  summed loss, ``Σ y² + W · aux``. The output rows, the (global) aux loss
  and the gradients of x, ``gate_w`` (summed over the ranks) and each
  expert weight (summed over the expert's replicas) within ``LAYER_TOL``
  (fp32: the same products in other orders).
* At ``{expert: 4}`` with a skewed router (8 experts, two of them favoured,
  64 tokens a rank): the per-destination buffers overflow; the outputs
  (the same choices dropped, the kept weights renormalised), the dropped
  fraction the drop monitor reports and ``routing_drop_stats`` equal
  JAX's.
* The engine: ``tiny_moe`` fp32 (remat full, so the backward recomputes the
  all-to-alls), stages 1 and 2 on the exact wire with ``overlap_comm``'s
  hooked reduces, 3 steps from JAX's initial master, at ``{expert: 2}``
  and ``{data: 2, expert: 2}``: losses and the gathered master within
  ``TOL["exact"]`` of the JAX engine's stage 2 at the same mesh. At
  ``{expert: 2}`` JAX's ZeRO shards over ``data`` = 1, so its stage 1 and
  stage 2 are one program; at ``{data: 2, expert: 2}`` they differ only in
  where the sums are cut (the same math within ``TOL["exact"]``,
  ``test_torch_zero.py`` holds both JAX stages at ``data = 2``): both port
  stages are held against JAX's one run, which keeps the file's time.
* The drop monitor the engine installs fires; the int8 wire, ZeRO-3, hpZ
  (``zshard`` 2) and the dense dispatch under an expert axis raise
  ``NotImplementedError``; the mesh's groups and labels.
* Presets, ``ep_topology`` / ``fold_group_tables`` and ``plan_ep`` against
  JAX's (no ranks).

jax is imported inside the fixtures and tests, never at the top: a spawned
rank imports this module to find its function.
"""
import pickle

import numpy as np
import pytest
import torch

from test_torch_zero import TOL, _engine_config, _leaves

SEQ, STEPS = 32, 3
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
# (mesh, world, the JAX runs its stages are held against)
ENGINE_MESHES = {"expert2": ({"expert": 2}, 2, {1: 2, 2: 2}),
                 "data2_expert2": ({"data": 2, "expert": 2}, 4, {1: 2, 2: 2})}
LAYER_MESHES = {"expert2": ({"expert": 2}, 2),
                "data2_expert2": ({"data": 2, "expert": 2}, 4)}
SKEW = dict(B=4, S=64, H=16, F=32, E=8, k=2)


def _layer_inputs(E=4, H=16, F=32, B=4, S=8, seed=7, skew=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    gate_w = (0.5 * rng.standard_normal((H, E))).astype(np.float32)
    if skew:                         # experts 0 and 1 favoured by most tokens
        x += 1.0
        gate_w[:, :2] += 0.15
    experts = {"w_up": (0.1 * rng.standard_normal((E, H, F))).astype(
                   np.float32),
               "w_down": (0.1 * rng.standard_normal((E, F, H))).astype(
                   np.float32)}
    return x, gate_w, experts


def _jax_mesh(mesh, world):
    import jax

    from deepspeed_tpu.comm import mesh as JM

    JM.reset_mesh()
    return JM.initialize_mesh(JM.MeshConfig(**mesh),
                              devices=jax.devices()[:world])


def _jax_layer(mesh, world, skew=False):
    """JAX's moe_ffn on ``mesh``: y, aux and the gradients of the ranks'
    summed loss Σ y² + W · aux."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.moe import layer as JL

    kw = dict(SKEW) if skew else {}
    k = kw.pop("k", 2)
    x, gate_w, experts = _layer_inputs(**kw, skew=skew)
    mm = _jax_mesh(mesh, world)
    try:
        def loss(p):
            y, aux = JL.moe_ffn(p["x"], p["g"], {"w_up": p["u"],
                                                  "w_down": p["d"]},
                                k=k, dispatch="ragged")
            return jnp.sum(y ** 2) + world * aux, (y, aux)

        params = {"x": jnp.asarray(x), "g": jnp.asarray(gate_w),
                  "u": jnp.asarray(experts["w_up"]),
                  "d": jnp.asarray(experts["w_down"])}
        with mm.mesh:
            (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(params)
        out = {"y": np.asarray(y), "aux": float(aux),
               "grads": {kk: np.asarray(v) for kk, v in grads.items()}}
        if skew:
            logits = jnp.asarray(x.reshape(-1, x.shape[-1]) @ gate_w)
            out["stats"] = JL.routing_drop_stats(
                logits, k=k, capacity_factor=1.25, ep=world,
                tokens_per_shard=x.shape[0] * x.shape[1] // world)
        return out
    finally:
        JM.reset_mesh()


def _spawn_start(fn, world, tmp_path, *args):
    """``test_torch_zero._spawn`` in two halves: start the ranks, and
    (the returned function) collect their results, so that JAX's runs go
    on while the ranks run."""
    import queue

    import torch.multiprocessing as mp

    from test_torch_zero import RANK_TIMEOUT, _rank_main

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init = f"file://{tmp_path / 'pg'}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init, out, args))
             for r in range(world)]
    for p in procs:
        p.start()

    def collect():
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

    return collect


def _jax_layers(out):
    """JAX's moe_ffn at each layer mesh and the skewed case, in a process
    of its own (the conftest's 8 CPU devices come with its environment),
    so that they run beside the JAX engines."""
    try:
        res = {name: _jax_layer(mesh, world)
               for name, (mesh, world) in LAYER_MESHES.items()}
        res["expert4_skew"] = _jax_layer({"expert": 4}, 4, skew=True)
        out.put(("ok", res))
    except Exception:                                   # noqa: BLE001
        import traceback

        out.put(("error", traceback.format_exc()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' ranks started first (their layer cases need nothing of
    JAX's), and JAX's layer cases in a process of their own; the JAX
    engines' initial masters pickled for the ranks' engine cases; then,
    while the rest runs, the JAX engine at each engine mesh (losses, final
    master) → (jax runs, {world: rank results})."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.runtime.dataloader import synthetic_lm_data

    import torch.multiprocessing as mp

    from test_torch_zero import RANK_TIMEOUT

    runs = {"engine": {}, "layer": {}}
    engines = {}
    path = tmp_path_factory.mktemp("jax_ep") / "runs.pkl"
    collect = {world: _spawn_start(_world_rank, world,
                                   tmp_path_factory.mktemp(f"ep{world}"),
                                   str(path))
               for world in (2, 4)}
    ctx = mp.get_context("spawn")
    layers_out = ctx.Queue()
    layers = ctx.Process(target=_jax_layers, args=(layers_out,))
    layers.start()
    for name, (mesh, world, stages) in ENGINE_MESHES.items():
        for stage in sorted(set(stages.values())):
            spec = dst.causal_lm_spec("tiny_moe", dtype="float32")
            mm = _jax_mesh(mesh, world)
            engine, *_ = dst.initialize(
                model=spec, config=dict(_engine_config({"stage": stage}),
                                        mesh=mesh), mesh_manager=mm)
            engines[(name, stage)] = (engine, mm, world)
            runs["engine"][(name, stage)] = {
                "master0": jax.tree.map(np.asarray, engine.state["master"])}
            JM.reset_mesh()
    # written whole, then renamed: a rank reads it once it exists
    part = path.with_suffix(".part")
    part.write_bytes(pickle.dumps(runs))
    part.rename(path)
    for key, (engine, mm, world) in engines.items():
        # the MoE layer lowers by the global mesh: this engine's
        JM.set_mesh(mm.mesh)
        data = synthetic_lm_data(world, SEQ, 512, seed=3)
        runs["engine"][key].update(
            losses=[float(engine.train_batch(data)) for _ in range(STEPS)],
            master=jax.tree.map(np.asarray, engine.state["master"]))
        JM.reset_mesh()
    del engines
    try:
        status, value = layers_out.get(timeout=RANK_TIMEOUT)
    finally:
        layers.join(timeout=RANK_TIMEOUT)
        if layers.is_alive():
            layers.kill()
            layers.join()
    assert status == "ok", value
    runs["layer"] = value
    return runs, {world: c() for world, c in collect.items()}


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #

def _layer_rank(rank, world, mesh, skew=False):
    """This rank's moe_ffn at ``mesh``: its rows of y, the aux loss and
    the gradients of Σ y² + aux; with ``skew`` the drop monitor's
    readings."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.moe import layer as L

    mm = M.initialize_mesh(M.MeshConfig(**mesh))
    kw = dict(SKEW) if skew else {}
    k = kw.pop("k", 2)
    x, gate_w, experts = _layer_inputs(**kw, skew=skew)
    ep, c = mm.ep_world_size, mm.coords["expert"]
    E_l = gate_w.shape[1] // ep
    n = x.shape[0] // world
    xr = torch.from_numpy(x[rank * n:(rank + 1) * n]).requires_grad_(True)
    g = torch.from_numpy(gate_w).requires_grad_(True)
    ex = {kk: torch.from_numpy(v[c * E_l:(c + 1) * E_l]).requires_grad_(True)
          for kk, v in experts.items()}
    seen = []
    if skew:
        L.set_drop_monitor(lambda f: seen.append(float(f)))
    try:
        y, aux = L.moe_ffn(xr, g, ex, k=k, dispatch="ragged")
    finally:
        L.set_drop_monitor(None)
    ((y ** 2).sum() + aux).backward()
    out = {"y": y.detach().numpy(), "aux": float(aux),
           "dx": xr.grad.numpy(), "dg": g.grad.numpy(),
           "du": ex["w_up"].grad.numpy(), "dd": ex["w_down"].grad.numpy(),
           "expert_coord": c, "drops": seen,
           "traffic": {kk: list(v) for kk, v in dtt.comm.traffic.items()}}
    dtt.comm.reset_traffic()
    return out


def _engine_rank(rank, world, runs_path, name):
    import os
    import time

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master
    from deepspeed_tpu_torch.moe import layer as L
    from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

    deadline = time.monotonic() + 60
    while not os.path.exists(runs_path):      # JAX's masters, pickled
        assert time.monotonic() < deadline, "no JAX masters in 60 s"
        time.sleep(0.05)
    runs = pickle.loads(open(runs_path, "rb").read())
    mesh, _, stages = ENGINE_MESHES[name]
    out = {}
    for stage, jstage in stages.items():
        spec = dtt.causal_lm_spec("tiny_moe", dtype="float32", remat="full")
        engine, *_ = dtt.initialize(
            model=spec, config=dict(_engine_config({"stage": stage}),
                                    mesh=mesh), device="cpu")
        load_master(engine, runs["engine"][(name, jstage)]["master0"])
        monitored = L._DROP_MONITOR is not None
        sink, seen = L._DROP_MONITOR, []
        if monitored:                  # a spy in front of the engine's sink
            L.set_drop_monitor(lambda f: (seen.append(float(f)), sink(f)))
        data = synthetic_lm_data(world, SEQ, 512, seed=3)
        losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
        out[stage] = {"losses": losses, "master": gather_master(engine),
                      "monitored": monitored, "seen": seen,
                      "drop_max": float(engine._moe_drop_max),
                      "reduce_counts": dict(engine.reduce_counts),
                      "local_w_up": tuple(engine.state["master"]["blocks"]
                                          ["w_up"].shape)}
        engine.close()
    return out


def _refusals(mesh):
    """The expert-axis combinations this slice leaves to later ones."""
    import deepspeed_tpu_torch as dtt

    cases = {"int8": ({"stage": 2, "zero_quantized_gradients": True}, {}),
             "zero3": ({"stage": 3}, {}),
             "dense": ({"stage": 2}, {"moe_dispatch": "dense"})}
    if "data" in mesh:
        cases["hpz"] = ({"stage": 2}, {})
    out = {}
    for case, (zero, spec_kw) in cases.items():
        cfg_mesh = ({"zshard": 2, "expert": 2} if case == "hpz" else mesh)
        try:
            dtt.initialize(model=dtt.causal_lm_spec(
                "tiny_moe", dtype="float32", **spec_kw),
                config=dict(_engine_config(zero), mesh=cfg_mesh),
                device="cpu")
            out[case] = "ran"
        except NotImplementedError as e:
            out[case] = str(e)
    return out


def _mesh_facts(rank, mesh):
    from deepspeed_tpu_torch.comm import mesh as M

    mm = M.initialize_mesh(M.MeshConfig(**mesh))
    return {"coords": dict(mm.coords),
            "expert_ranks": mm.group_ranks(("expert",)),
            "replica_ranks": mm.group_ranks(("data", "zshard")),
            "labels": [M.group_label(mm.group(("expert",))),
                       M.group_label(mm.moe_group(("expert",), "expert")),
                       M.group_label(mm.moe_group(M.BATCH_AXES, "batch"))],
            "moe_is_engine": mm.moe_group(("expert",), "expert")
            is mm.group(("expert",))}


def _world_rank(rank, world, runs_path):
    """Every case of one world, in one spawn."""
    layer = [n for n, (_, w) in LAYER_MESHES.items() if w == world]
    engines = [n for n, (_, w, _) in ENGINE_MESHES.items() if w == world]
    mesh = LAYER_MESHES[layer[0]][0]
    out = {"mesh": _mesh_facts(rank, mesh),
           "layer": {n: _layer_rank(rank, world, LAYER_MESHES[n][0])
                     for n in layer}}
    if world == 4:
        out["layer"]["expert4_skew"] = _layer_rank(rank, world,
                                                   {"expert": 4}, skew=True)
    out["engine"] = {n: _engine_rank(rank, world, runs_path, n)
                     for n in engines}
    out["refusals"] = _refusals(mesh)
    return out


# --------------------------------------------------------------------------- #
# the checks
# --------------------------------------------------------------------------- #

def _layer_sums(ranks, name, E):
    """The ranks' layer results → the whole batch's y and dx, Σ dg, and
    each expert's gradient summed over its replicas."""
    got = [r["layer"][name] for r in ranks]
    ep = 1 + max(g["expert_coord"] for g in got)
    E_l = E // ep
    du = [None] * ep
    dd = [None] * ep
    for g in got:
        c = g["expert_coord"]
        du[c] = g["du"] if du[c] is None else du[c] + g["du"]
        dd[c] = g["dd"] if dd[c] is None else dd[c] + g["dd"]
    assert all(u.shape[0] == E_l for u in du)
    return {"y": np.concatenate([g["y"] for g in got]),
            "x": np.concatenate([g["dx"] for g in got]),
            "g": sum(g["dg"] for g in got), "u": np.concatenate(du),
            "d": np.concatenate(dd), "aux": [g["aux"] for g in got]}


@pytest.mark.parametrize("name", list(LAYER_MESHES))
def test_moe_ffn_expert_parallel_matches_jax(name, runs):
    runs, port_runs = runs
    want = runs["layer"][name]
    world = LAYER_MESHES[name][1]
    got = _layer_sums(port_runs[world], name, 4)
    np.testing.assert_allclose(got["y"], want["y"], **LAYER_TOL)
    np.testing.assert_allclose(got["aux"], [want["aux"]] * world,
                               rtol=1e-6, atol=0)
    for key in ("x", "g", "u", "d"):
        np.testing.assert_allclose(got[key], want["grads"][key],
                                   err_msg=key, **LAYER_TOL)
    # the rows and ids went by all-to-all on the expert group: 3 a forward
    # (rows, ids, rows back), 2 in the backward (the rows' gradients)
    t = port_runs[world][0]["layer"][name]["traffic"]
    assert t["expert/all_to_all"][0] == 5
    # the aux's mean: forward and backward
    assert t["batch/all_reduce"][0] == 2
    assert port_runs[world][0]["layer"][name]["drops"] == []


def test_moe_ffn_expert_parallel_drops_match_jax(runs):
    """{expert: 4}, a skewed router: the buffers overflow; the same choices
    are dropped as in JAX, and the monitor's fraction and
    routing_drop_stats equal JAX's."""
    from deepspeed_tpu_torch.moe import layer as L

    runs, port_runs = runs
    want = runs["layer"]["expert4_skew"]
    got = _layer_sums(port_runs[4], "expert4_skew", SKEW["E"])
    assert want["stats"]["ragged"] > 0.05       # the case does drop
    np.testing.assert_allclose(got["y"], want["y"], **LAYER_TOL)
    for key in ("x", "g", "u", "d"):
        np.testing.assert_allclose(got[key], want["grads"][key],
                                   err_msg=key, **LAYER_TOL)
    drops = [r["layer"]["expert4_skew"]["drops"] for r in port_runs[4]]
    assert all(d == drops[0] and len(d) == 1 for d in drops)
    np.testing.assert_allclose(drops[0][0], want["stats"]["ragged"],
                               rtol=1e-6)
    x, gate_w, _ = _layer_inputs(**{k: v for k, v in SKEW.items()
                                    if k != "k"}, skew=True)
    logits = torch.from_numpy(x.reshape(-1, x.shape[-1]) @ gate_w)
    stats = L.routing_drop_stats(logits, k=SKEW["k"], capacity_factor=1.25,
                                 ep=4, tokens_per_shard=logits.shape[0] // 4)
    assert stats["dense_capacity"] == want["stats"]["dense_capacity"]
    np.testing.assert_allclose(
        [stats["dense"], stats["ragged"]],
        [want["stats"]["dense"], want["stats"]["ragged"]], rtol=1e-6)


@pytest.mark.parametrize("name,stage", [(n, s) for n in ENGINE_MESHES
                                        for s in (1, 2)])
def test_engine_expert_parallel_matches_jax_engine(name, stage, runs):
    runs, port_runs = runs
    mesh, world, stages = ENGINE_MESHES[name]
    want = runs["engine"][(name, stages[stage])]
    ranks = [r["engine"][name][stage] for r in port_runs[world]]
    tol = TOL["exact"]
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"],
                               rtol=tol["loss"], atol=0)
    mine, theirs = dict(_leaves(ranks[0]["master"])), dict(
        _leaves(want["master"]))
    assert sorted(mine) == sorted(theirs)
    diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                           for k in theirs])
    assert diff.max() <= tol["master"], diff.max()
    assert diff.mean() <= tol["master_mean"], diff.mean()
    # each rank holds E / ep experts of each expert leaf
    E, ep = 4, mesh["expert"]
    assert ranks[0]["local_w_up"][1] == E // ep
    # hooked: the dense and the expert leaves of each unit reduce apart
    assert ranks[0]["reduce_counts"]["late"] == 0


def test_engine_installs_the_drop_monitor(runs):
    """As JAX's engine does under an expert axis (test_moe.py:143): the
    monitor is installed and fires at every MoE layer's dispatch (the
    forward and remat's recompute: 2 layers × 2 × gas 2 × 3 steps), each
    reading in [0, 1) — 0 on tiny_moe's dropless buffers (64 choices a
    rank: ``ep_shard_capacity`` keeps every one) — and the engine keeps
    the worst."""
    _, port_runs = runs
    for world in (2, 4):
        for r in port_runs[world]:
            for runs in r["engine"].values():
                for run in runs.values():
                    assert run["monitored"]
                    assert len(run["seen"]) == 2 * 2 * 2 * STEPS
                    assert all(0.0 <= f < 1.0 for f in run["seen"])
                    assert run["drop_max"] == max(run["seen"]) == 0.0


@pytest.mark.parametrize("world", [2, 4])
def test_expert_axis_later_slices_raise(world, runs):
    _, port_runs = runs
    refusals = port_runs[world][0]["refusals"]
    for case, msg in refusals.items():
        assert "later slice" in msg and "'expert' mesh axis" in msg, (case,
                                                                     msg)
    assert set(refusals) == ({"int8", "zero3", "dense", "hpz"} if world == 4
                             else {"int8", "zero3", "dense"})


def test_mesh_expert_axis_groups(runs):
    """Ranks take JAX's device order (expert inside data); the MoE layer's
    groups are its own, apart from the engine's."""
    _, port_runs = runs
    facts = [r["mesh"] for r in port_runs[4]]
    assert [f["coords"]["data"] for f in facts] == [0, 0, 1, 1]
    assert [f["coords"]["expert"] for f in facts] == [0, 1, 0, 1]
    assert facts[0]["expert_ranks"] == (0, 1)
    assert facts[3]["replica_ranks"] == (1, 3)
    assert facts[0]["labels"] == ["expert", "expert", "batch"]
    assert not any(f["moe_is_engine"] for f in facts)
    two = [r["mesh"] for r in port_runs[2]]
    # at {expert: 2} the engine's expert group is the default group
    assert two[0]["labels"] == ["world", "expert", "batch"]
    assert two[1]["replica_ranks"] == (1,)


# --------------------------------------------------------------------------- #
# presets and planning (no ranks)
# --------------------------------------------------------------------------- #

def test_ep_shard_capacity_and_plan_match_jax():
    from deepspeed_tpu.moe import layer as JL

    from deepspeed_tpu_torch.moe import layer as L

    for tk, ep in ((32, 4), (16384, 8), (128, 2), (1000, 3)):
        assert L.ep_shard_capacity(tk, ep) == JL.ep_shard_capacity(tk, ep)
    assert L.ragged_mesh_plan(None, 2, 8, 4) == ("local", None)
    assert L.resolve_dispatch("auto", torch.Generator(), 0.5) == "dense"
    with pytest.raises(ValueError, match="noisy gating"):
        L.resolve_dispatch("ragged", torch.Generator(), 0.5)


class _HF:
    def __init__(self, **kw):
        self.__dict__.update(kw)


HF_CONFIGS = {
    "mixtral": _HF(model_type="mixtral", num_local_experts=8,
                   num_experts_per_tok=2, intermediate_size=14336),
    "qwen2_moe": _HF(model_type="qwen2_moe", num_experts=60,
                     num_experts_per_tok=4,
                     shared_expert_intermediate_size=5632,
                     moe_intermediate_size=1408),
    "deepseek_v3": _HF(model_type="deepseek_v3", n_routed_experts=256,
                       num_experts_per_tok=8, routed_scaling_factor=2.5,
                       n_shared_experts=1, first_k_dense_replace=3,
                       moe_intermediate_size=2048),
    "generic": _HF(model_type="custom", moe_num_experts=16, moe_top_k=1),
    "dense": _HF(model_type="llama", hidden_size=64),
}


@pytest.mark.parametrize("case", list(HF_CONFIGS))
def test_presets_and_plan_ep_match_jax(case):
    from deepspeed_tpu.moe import auto_ep as JA
    from deepspeed_tpu.moe import presets as JP

    from deepspeed_tpu_torch.moe import auto_ep as PA
    from deepspeed_tpu_torch.moe import presets as PP

    cfg = HF_CONFIGS[case]
    assert sorted(PP.PRESETS) == sorted(JP.PRESETS)
    for key, preset in JP.PRESETS.items():
        assert PP.PRESETS[key].__dict__ == preset.__dict__
    jr, pr = JP.resolve_preset(cfg), PP.resolve_preset(cfg)
    assert (jr is None) == (pr is None)
    if jr is not None:
        assert pr[0].name == jr[0].name and pr[1] == jr[1]
    assert PA.detect_moe(cfg) == JA.detect_moe(cfg)
    for n_dev, max_ep, etp in ((8, None, 1), (12, 4, 1), (8, None, 2)):
        assert PA.plan_ep(cfg, n_devices=n_dev, max_ep=max_ep,
                          etp_size=etp).__dict__ == JA.plan_ep(
            cfg, n_devices=n_dev, max_ep=max_ep, etp_size=etp).__dict__
    for shape in ({"data": 2, "expert": 4}, {"data": 2, "zshard": 2,
                                             "expert": 2, "tensor": 2}):
        assert PP.ep_topology(shape).__dict__ == JP.ep_topology(
            shape).__dict__
        assert PP.fold_group_tables(shape) == JP.fold_group_tables(shape)
