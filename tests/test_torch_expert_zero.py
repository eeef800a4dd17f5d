"""The expert axis on every data-parallel engine of the PyTorch port
against the JAX package: ZeRO-3, the ZeRO++ int8 wire and hpZ / MiCS under
``expert > 1``, and the dense GShard dispatch across experts.

Ranks run as spawned gloo processes on one intra-op thread
(``test_torch_expert_parallel._spawn_start``, each joined under
``RANK_TIMEOUT``), one spawn a world: 2, 4 and 8 ranks. JAX runs the same
meshes on the conftest's 8 CPU devices meanwhile (its dense layer cases in
a process of their own).

* The engines: ``tiny_moe`` fp32, remat full, 3 steps (2 at world 8 on
  the int8 wire, below) from JAX's initial master on the same global
  batches, against the JAX engine at the same mesh: at ``{data: 2,
  expert: 2}`` ZeRO-3 exact, ZeRO-3 with qgZ + qwZ, ZeRO-2 with qgZ + qwZ +
  LoCo; at ``{zshard: 2, expert: 2}`` (hpZ) ZeRO-3 exact and ZeRO-2 with
  qgZ + qwZ; at ``{data: 2, zshard: 2, expert: 2}`` (world 8) hpZ ZeRO-3
  exact and hpZ ZeRO-2 with qgZ + qwZ + LoCo; at ``{expert: 2}`` ZeRO-2
  with ``moe_dispatch="dense"``, and with qgZ + qwZ asked for (JAX's
  manual axes hold one rank there: both packages warn and run the exact
  wire); and ZeRO-2 exact and with qgZ + qwZ at
  ``{data: 2, expert: 2}`` on batches whose ``loss_mask`` keeps a
  different number of tokens on each rank of an expert group (JAX's exact
  step takes the global masked token mean, its manual int8 step the
  expert group's; a rank with no valid token keeps the aux loss's weight).
  The losses (equal on every rank), the
  grad norm of every step, each rank's own master shard (its experts of
  an expert leaf, then its ZeRO shard: a reversed group order shows) and
  LoCo's residual (JAX's ``loco_err`` leaves, rows of ``data`` ×
  ``zshard``) by ``test_torch_zero.TOL``; the int8 wire's norm by
  ``test_torch_hpz.NORM_INT8``. JAX's int8 step is manual over ``data``
  and ``zshard`` only: it quantizes each expert leaf with every expert in
  its blocks, which the port follows (``parallel/stage3.ExpertRows``);
  with blocks of the rank's own experts instead, the first qgZ + qwZ loss
  at ``{data: 2, expert: 2}`` moved 1.4e-4 from JAX's and the master
  1.3e-2. At world 8 the int8 wire's two hops flip more elements than one:
  measured against JAX, the master's mean distance is 5e-9 after step 1,
  2.5e-7 after step 2 and 2.8e-5 after step 3, the flips' Adam steps
  spreading through the update; the world-8 int8 case holds 2 steps. So
  does the masked int8 case, whose third step trains on one rank's ten
  valid tokens of its expert group: 2.4e-9 after step 1, 8.5e-8 after
  step 2, 9.1e-6 after step 3 (its loss still within 2.8e-6; the exact
  masked case's master within 2.1e-9 on average after 3 steps).
* The dense dispatch's ``moe_ffn`` at ``{expert: 2}`` and ``{data: 2,
  expert: 2}`` against JAX's at the same mesh (its ``_expert_constraint``
  resharding): each rank gives its rows, the whole router and its own
  experts and differentiates ``Σ y² + aux`` of its rows; JAX the ranks'
  summed loss. Outputs, aux and every gradient within ``LAYER_TOL``; the
  buffers cross the expert group by 2 all-to-alls a forward and 2 a
  backward.

jax is imported inside the fixtures and tests, never at the top: a
spawned rank imports this module to find its function.
"""
import os
import pickle
import time

import numpy as np
import pytest

from test_torch_expert_parallel import (
    LAYER_TOL,
    _jax_mesh,
    _layer_inputs,
    _layer_sums,
    _spawn_start,
)
from test_torch_hpz import NORM_INT8, _want_shard
from test_torch_zero import TOL, _engine_config, _leaves

SEQ = 32
INT8 = {"zero_quantized_gradients": True, "zero_quantized_weights": True}
HPZ = {"zero_hpz_partition_size": 2}
D2E2 = {"data": 2, "expert": 2}
Z2E2 = {"zshard": 2, "expert": 2}
D2Z2E2 = {"data": 2, "zshard": 2, "expert": 2}
# name → (world, mesh, zero config, steps, spec options[, batches])
CASES = {
    "d2e2_zero3_exact": (4, D2E2, {"stage": 3}, 3, {}),
    "d2e2_zero3_int8": (4, D2E2, dict(INT8, stage=3), 3, {}),
    "d2e2_zero2_int8_loco": (4, D2E2, dict(INT8, stage=2,
                                           loco_error_feedback=True), 3, {}),
    "z2e2_hpz_zero3_exact": (4, Z2E2, dict(HPZ, stage=3), 3, {}),
    "z2e2_hpz_zero2_int8": (4, Z2E2, dict(HPZ, **INT8, stage=2), 3, {}),
    "d2z2e2_hpz_zero3_exact": (8, D2Z2E2, dict(HPZ, stage=3), 3, {}),
    "d2z2e2_hpz_zero2_int8_loco": (8, D2Z2E2, dict(
        HPZ, **INT8, stage=2, loco_error_feedback=True), 2, {}),
    "e2_zero2_dense": (2, {"expert": 2}, {"stage": 2}, 3,
                       {"moe_dispatch": "dense"}),
    # data x zshard = 1: no manual rank to quantize between; JAX warns and
    # runs the exact wire
    "e2_zero2_int8_exact_fallback": (2, {"expert": 2}, dict(INT8, stage=2),
                                     1, {}),
    "d2e2_zero2_exact_masked": (4, D2E2, {"stage": 2}, 3, {}, "masked"),
    "d2e2_zero2_int8_masked": (4, D2E2, dict(INT8, stage=2), 2, {},
                               "masked"),
}
# the dense dispatch's layer cases: name → (mesh, world)
LAYERS = {"dense_expert2": ({"expert": 2}, 2),
          "dense_data2_expert2": (D2E2, 4)}
WORLDS = (2, 4, 8)


# --------------------------------------------------------------------------- #
# JAX
# --------------------------------------------------------------------------- #

def _jax_dense_layer(mesh, world):
    """JAX's dense ``moe_ffn`` on ``mesh``: y, aux and the gradients of
    the ranks' summed loss Σ y² + W · aux."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.moe import layer as JL

    x, gate_w, experts = _layer_inputs()
    mm = _jax_mesh(mesh, world)
    try:
        def loss(p):
            y, aux = JL.moe_ffn(p["x"], p["g"], {"w_up": p["u"],
                                                  "w_down": p["d"]},
                                k=2, dispatch="dense")
            return jnp.sum(y ** 2) + world * aux, (y, aux)

        params = {"x": jnp.asarray(x), "g": jnp.asarray(gate_w),
                  "u": jnp.asarray(experts["w_up"]),
                  "d": jnp.asarray(experts["w_down"])}
        with mm.mesh:
            (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(params)
        return {"y": np.asarray(y), "aux": float(aux),
                "grads": {k: np.asarray(v) for k, v in grads.items()}}
    finally:
        JM.reset_mesh()


def _jax_layers(out):
    try:
        out.put(("ok", {name: _jax_dense_layer(mesh, world)
                        for name, (mesh, world) in LAYERS.items()}))
    except Exception:                                   # noqa: BLE001
        import traceback

        out.put(("error", traceback.format_exc()))


def _masked_batches(world, steps):
    """Batches whose ``loss_mask`` keeps a different number of tokens on
    each rank of an expert group: rank 1 a third, none in micro-batch 3,
    rank 0 none in micro-batch 4 (gas 2)."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(steps * 2):
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


def _data(name, world, synthetic):
    """A case's batches: the masked ones, or the package's ``synthetic``
    ``synthetic_lm_data``."""
    _, _, _, steps, _, *batches = CASES[name]
    if batches == ["masked"]:
        return iter(_masked_batches(world, steps))
    return synthetic(world, SEQ, 512, seed=3)


def _jax_engine(name):
    import deepspeed_tpu as dst

    world, mesh, zero, _, spec_kw, *_ = CASES[name]
    mm = _jax_mesh(mesh, world)
    engine, *_ = dst.initialize(
        model=dst.causal_lm_spec("tiny_moe", dtype="float32", **spec_kw),
        config=dict(_engine_config(zero), mesh=mesh), mesh_manager=mm)
    return engine, mm


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks started first (their layer cases need nothing
    of JAX's), JAX's layer cases in a process of their own, JAX's initial
    master pickled for the ranks' engines (the same in every case: the
    seed's), then the JAX engine of each case → (JAX runs, {world: rank
    results})."""
    import jax
    import torch.multiprocessing as mp

    from deepspeed_tpu.comm import comm as JC
    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.runtime.dataloader import synthetic_lm_data

    from test_torch_zero import RANK_TIMEOUT

    if not JC.is_initialized():     # else the engine builds a mesh of all 8
        JC.init_distributed(verbose=False)
    path = tmp_path_factory.mktemp("jax_epz") / "master0.pkl"
    collect = {world: _spawn_start(_world_rank, world,
                                   tmp_path_factory.mktemp(f"epz{world}"),
                                   str(path))
               for world in WORLDS}
    ctx = mp.get_context("spawn")
    layers_out = ctx.Queue()
    layers = ctx.Process(target=_jax_layers, args=(layers_out,))
    layers.start()
    out = {"engine": {}}
    master0 = None
    for name, (world, mesh, _, steps, *_) in CASES.items():
        engine, mm = _jax_engine(name)
        m0 = jax.tree.map(np.asarray, engine.state["master"])
        if master0 is None:
            master0 = m0
            part = path.with_suffix(".part")
            part.write_bytes(pickle.dumps(master0))
            part.rename(path)
        out["engine"][name] = {"master0_same": all(
            np.array_equal(a, b) for (_, a), (_, b) in zip(
                _leaves(master0), _leaves(m0)))}
        data = _data(name, world, synthetic_lm_data)
        losses, norms = [], []
        for _ in range(steps):
            losses.append(float(engine.train_batch(data)))
            norms.append(engine.get_global_grad_norm())
        out["engine"][name].update(
            losses=losses, norms=norms, wire=engine._wire_format(),
            compressed=engine._compressed,
            master=jax.tree.map(np.asarray, engine.state["master"]),
            loco_err=(jax.tree.map(np.asarray, engine.state["loco_err"])
                      if "loco_err" in engine.state else None))
        del engine, mm
        JM.reset_mesh()
    try:
        status, value = layers_out.get(timeout=RANK_TIMEOUT)
    finally:
        layers.join(timeout=RANK_TIMEOUT)
        if layers.is_alive():
            layers.kill()
            layers.join()
    assert status == "ok", value
    out["layer"] = value
    return out, {world: c() for world, c in collect.items()}


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #

def _dense_layer_rank(rank, world, mesh):
    """This rank's dense moe_ffn at ``mesh``: its rows of y, the aux loss,
    the gradients of Σ y² + aux and the expert group's traffic."""
    import torch

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.moe import layer as L

    mm = M.initialize_mesh(M.MeshConfig(**mesh))
    x, gate_w, experts = _layer_inputs()
    ep, c = mm.ep_world_size, mm.coords["expert"]
    E_l = gate_w.shape[1] // ep
    n = x.shape[0] // world
    xr = torch.from_numpy(x[rank * n:(rank + 1) * n]).requires_grad_(True)
    g = torch.from_numpy(gate_w).requires_grad_(True)
    ex = {k: torch.from_numpy(v[c * E_l:(c + 1) * E_l]).requires_grad_(True)
          for k, v in experts.items()}
    dtt.comm.reset_traffic()
    y, aux = L.moe_ffn(xr, g, ex, k=2, dispatch="dense")
    ((y ** 2).sum() + aux).backward()
    out = {"y": y.detach().numpy(), "aux": float(aux),
           "dx": xr.grad.numpy(), "dg": g.grad.numpy(),
           "du": ex["w_up"].grad.numpy(), "dd": ex["w_down"].grad.numpy(),
           "expert_coord": c,
           "traffic": {k: list(v) for k, v in dtt.comm.traffic.items()}}
    dtt.comm.reset_traffic()
    return out


def _engine_rank(rank, world, master0, name):
    import torch

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import load_master
    from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

    _, mesh, zero, steps, spec_kw, *_ = CASES[name]
    spec = dtt.causal_lm_spec("tiny_moe", dtype="float32", remat="full",
                              **spec_kw)
    engine, *_ = dtt.initialize(
        model=spec, config=dict(_engine_config(zero), mesh=mesh),
        device="cpu")
    load_master(engine, master0)
    data = _data(name, world, synthetic_lm_data)
    dtt.comm.reset_traffic()
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(engine.train_batch(data)))
        norms.append(engine.get_global_grad_norm())
    traffic = {k: list(v) for k, v in dtt.comm.traffic.items()}
    shard = {"/" + "/".join(sh.slot.path): (
        sh.dim, engine._local(engine.flat_master, sh).detach().numpy().copy())
        for sh in engine._shards}
    err = (engine.full_loco_err()
           if getattr(engine, "loco_err", None) is not None else None)
    out = {"type": type(engine).__name__, "losses": losses, "norms": norms,
           "shard": shard, "shard_world": engine.shard_world,
           "shard_rank": engine.shard_rank,
           "expert_coord": engine.mesh_manager.coords["expert"],
           "ep": engine.ep,
           "expert_dims": {"/" + "/".join(p): d
                           for p, d in engine._expert_dims.items()},
           "loco_err": (None if err is None or rank
                        else {k: np.asarray(v) for k, v in _leaves(err)}),
           "wire": engine._wire_format(), "compressed": engine._compressed,
           "monitored": engine._moe_drop_max is not None,
           "drop_max": float(engine._moe_drop_max),
           "counts": (dict(engine._zero3.counts)
                      if hasattr(engine, "_zero3") else None),
           "traffic": traffic}
    engine.close()
    return out


def _world_rank(rank, world, master0_path):
    """Every case of one world, in one spawn: the dense layer cases first
    (no JAX input), then the engines from JAX's initial master."""
    import torch

    # one intra-op thread, as chip_smoke.rank_entry: with more, a
    # process's first forward can give other bits, and the int8 wire's
    # flips with it
    torch.set_num_threads(1)
    out = {"layer": {n: _dense_layer_rank(rank, world, mesh)
                     for n, (mesh, w) in LAYERS.items() if w == world}}
    deadline = time.monotonic() + 90
    while not os.path.exists(master0_path):
        assert time.monotonic() < deadline, "no JAX master in 90 s"
        time.sleep(0.05)
    master0 = pickle.loads(open(master0_path, "rb").read())
    out["engine"] = {n: _engine_rank(rank, world, master0, n)
                     for n, case in CASES.items() if case[0] == world}
    return out


# --------------------------------------------------------------------------- #
# the checks
# --------------------------------------------------------------------------- #

def _want_rank_shard(leaf, got, path, dim):
    """JAX's whole leaf → this rank's experts, then its ZeRO shard."""
    edim = got["expert_dims"].get(path)
    if edim is not None:
        E_l = leaf.shape[edim] // got["ep"]
        leaf = np.take(leaf, range(got["expert_coord"] * E_l,
                                   (got["expert_coord"] + 1) * E_l),
                       axis=edim)
    return _want_shard(leaf, dim, got["shard_world"], got["shard_rank"])


@pytest.mark.parametrize("name", list(CASES))
def test_engine_expert_axis_matches_jax_engine(name, runs):
    jruns, port = runs
    world, mesh, zero, steps, *_ = CASES[name]
    want = jruns["engine"][name]
    assert want["master0_same"]
    int8 = want["wire"] != "exact"
    tol = TOL["int8" if int8 else "exact"]
    ranks = [r["engine"][name] for r in port[world]]
    for r, got in enumerate(ranks):
        assert got["type"] == ("Zero3Engine" if zero["stage"] == 3
                               else "DataParallelEngine")
        assert (got["wire"], got["compressed"]) == (want["wire"],
                                                    want["compressed"])
        assert got["losses"] == ranks[0]["losses"], (name, r)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=tol["loss"], atol=0, err_msg=name)
        np.testing.assert_allclose(got["norms"], want["norms"], atol=0,
                                   rtol=NORM_INT8 if int8 else tol["loss"],
                                   err_msg=name)
        theirs = dict(_leaves(want["master"]))
        assert sorted(got["shard"]) == sorted(theirs)
        diff = np.concatenate([
            np.abs(v - _want_rank_shard(theirs[k], got, k, dim)).ravel()
            for k, (dim, v) in got["shard"].items()])
        assert diff.max() <= tol["master"], (name, r, diff.max())
        assert diff.mean() <= tol["master_mean"], (name, r, diff.mean())
        # the drop monitor is installed and read nothing dropped
        assert got["monitored"] and got["drop_max"] == 0.0
    if want["loco_err"] is not None:
        mine, theirs = ranks[0]["loco_err"], dict(_leaves(want["loco_err"]))
        assert sorted(mine) == sorted(theirs)
        assert all(mine[k].shape == theirs[k].shape for k in theirs)
        ediff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                                for k in theirs])
        assert ediff.max() <= tol["err"], (name, ediff.max())
        assert ediff.mean() <= tol["err_mean"], (name, ediff.mean())


def test_engine_expert_axis_groups_and_gathers(runs):
    """ZeRO-3 gathers the head group and the chunk per forward and the
    chunk again in the backward's recompute, and reduces on the exact wire
    only; the dense leaves' replica hop runs on ``(data, expert)`` at
    world 8 under hpZ, the expert leaves' on ``data``; under hpZ at data
    = 1 nothing crosses a ``data`` group on the exact wire."""
    _, port = runs
    gas = _engine_config({})["gradient_accumulation_steps"]
    for name, (world, _, zero, *_) in CASES.items():
        for got in (r["engine"][name] for r in port[world]):
            if zero["stage"] == 3:
                exact = "zero_quantized_gradients" not in zero
                assert got["counts"] == {
                    "gather_fwd": 2 * gas, "gather_bwd": gas,
                    "reduce": 2 * gas if exact else 0}, (name, got["counts"])
    w8 = [r["engine"]["d2z2e2_hpz_zero3_exact"]["traffic"] for r in port[8]]
    for t in w8:
        assert t["data_expert/all_reduce"][0] > 0
        assert t["data/all_reduce"][0] > 0
    for r in port[4]:
        t = r["engine"]["z2e2_hpz_zero3_exact"]["traffic"]
        assert not any(k.startswith("data") for k in t), sorted(t)


@pytest.mark.parametrize("name", list(LAYERS))
def test_moe_ffn_dense_across_experts_matches_jax(name, runs):
    jruns, port = runs
    want = jruns["layer"][name]
    world = LAYERS[name][1]
    got = _layer_sums(port[world], name, 4)
    np.testing.assert_allclose(got["y"], want["y"], **LAYER_TOL)
    np.testing.assert_allclose(got["aux"], [want["aux"]] * world,
                               rtol=1e-6, atol=0)
    for key in ("x", "g", "u", "d"):
        np.testing.assert_allclose(got[key], want["grads"][key],
                                   err_msg=key, **LAYER_TOL)
    # the [E, C, H] buffers: to the experts and back, forward and backward
    t = port[world][0]["layer"][name]["traffic"]
    assert t["expert/all_to_all"][0] == 4
