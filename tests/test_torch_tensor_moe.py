"""MoE on the ``tensor`` axis (expert tensor parallelism), against the JAX
package: each rank holds its ``mlp`` slice of its experts (JAX's rules
``mlp → tensor``, ``expert → expert``), the experts' outputs are summed
over ``tensor``, and the gate is whole on every tensor rank.

Ranks run as spawned gloo processes on one intra-op thread, one spawn a
world (2 and 4 ranks); JAX runs in the test process on the conftest's 8
CPU devices, as in ``test_torch_seq_compose.py``, whose layer helpers this
file takes.

* ``moe_ffn`` (ragged) at ``{tensor: 2}``, ``{expert: 2, tensor: 2}`` and
  ``{data: 2, tensor: 2}`` against JAX's at the same mesh: y, the aux loss
  and every gradient within ``LAYER_TOL`` (a sliced gradient as each
  rank's slice).
* The ragged engine: JAX's engine aborts on it under ``tensor`` on the
  CPU (an XLA check failure, queue C), so each case is held by
  ``TOL["exact"]`` over 3 masked steps to JAX's engine on the same global
  batch without the ``tensor`` axis: ``{tensor: 2}`` ZeRO-1 and ZeRO-3
  against one device, ``{expert: 2, tensor: 2}`` ZeRO-2 (its mesh from
  ``auto_ep(etp_size=2)``) against ``{expert: 2}``, ``{data: 2, tensor:
  2}`` ZeRO-3 against ``{data: 2}``.
* The dense engine against JAX's at the same mesh: ``{tensor: 2}`` ZeRO-1,
  ``{expert: 2, tensor: 2}`` ZeRO-2, ``{data: 2, tensor: 2}`` ZeRO-3; one
  bf16 case (``{data: 2, tensor: 2}`` ZeRO-3) within ``LOW_VS_JAX`` of JAX's
  own bf16 run at the same mesh.
* ``auto_ep(etp_size=2)``: the mesh section and the plan equal JAX's.
* An ``{expert: 2, tensor: 2}`` tag loads bit-equal into one process.
* FastGen of an MoE model under ``tensor`` serves replicated with a
  warning (greedy tokens equal to one process's) and raises under
  ``tp=True``, naming queue A.5.

jax is imported inside the fixtures and tests, never at the top: a
spawned rank imports this module to find its function.
"""
import os
import pickle
import warnings

import numpy as np
import pytest

from test_torch_expert_parallel import _jax_mesh, _spawn_start
from test_torch_pipeline import STEPS, _wait
from test_torch_seq_compose import (_mask, check_layer, jax_layer,
                                    layer_rank, layer_sums)
from test_torch_zero import TOL, _engine_config, _leaves
from test_torch_zero3 import LOW_VS_JAX, _precision

SEQ = 32
MODEL = "tiny_moe"
DENSE = {"moe_dispatch": "dense"}
# name → world, mesh, zero stage, dtype, spec keywords, JAX's mesh (None:
# the same) and its world
_BASE = dict(world=2, mesh={"tensor": 2}, stage=1, dtype="float32",
             spec={}, jax_mesh={}, jax_world=1, micro=2)
CASES = {name: dict(_BASE, **kw) for name, kw in {
    "t2_ragged_zero1": dict(),
    "t2_ragged_zero3": dict(stage=3),
    "e2t2_ragged_zero2": dict(world=4, mesh=None, stage=2,
                              jax_mesh={"expert": 2}, jax_world=2),
    "d2t2_dense_bf16": dict(world=4, mesh={"data": 2, "tensor": 2},
                            stage=3, spec=DENSE, jax_mesh=None,
                            dtype="bfloat16"),
    "d2t2_ragged_zero3": dict(world=4, mesh={"data": 2, "tensor": 2},
                              stage=3, jax_mesh={"data": 2}, jax_world=2),
    "t2_dense_zero1": dict(spec=DENSE, jax_mesh=None),
    "e2t2_dense_zero2": dict(world=4, mesh={"expert": 2, "tensor": 2},
                             stage=2, spec=DENSE, jax_mesh=None),
    "d2t2_dense_zero3": dict(world=4, mesh={"data": 2, "tensor": 2},
                             stage=3, spec=DENSE, jax_mesh=None),
}.items()}
# JAX's ragged MoE in bf16 aborts XLA's CPU compiler under an expert
# axis too ("Invalid binary instruction opcode copy", queue C): the bf16
# case is the dense dispatch, against JAX's at the same mesh
BF16 = {"d2t2_dense_bf16": "d2t2_dense_zero3"}
# the case whose mesh section comes from auto_ep(etp_size=2)
AUTO_EP = "e2t2_ragged_zero2"
# the {expert: 2, tensor: 2} tag: saved by its ranks, loaded into ONE
# process
CKPT = "e2t2_ragged_zero2"
WORLDS = (2, 4)
LAYER_MESHES = {"tensor2": ({"tensor": 2}, 2),
                "expert2_tensor2": ({"expert": 2, "tensor": 2}, 4),
                "data2_tensor2": ({"data": 2, "tensor": 2}, 4)}


def _mesh(name):
    """The case's mesh (``auto_ep``'s section for ``AUTO_EP``)."""
    c = CASES[name]
    if c["mesh"] is not None:
        return dict(c["mesh"])
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.moe.auto_ep import auto_ep

    _, section, _ = auto_ep(dtt.causal_lm_spec(MODEL), n_devices=c["world"],
                            etp_size=2)
    return section


def _rows(name):
    """The global micro-batch: micro rows a batch rank (data × expert)."""
    c = CASES[name]
    return c["micro"] * c["world"] // 2


def _batches(name, n):
    rows = _rows(name)
    return [{"tokens": np.random.default_rng(200 + i).integers(
        0, 512, (rows, SEQ)).astype(np.int32),
        "loss_mask": _mask(rows, SEQ)} for i in range(n)]


def _config(name, mesh, micro):
    c = CASES[name]
    cfg = dict(_engine_config({"stage": c["stage"]}), mesh=mesh,
               train_micro_batch_size_per_gpu=micro)
    return _precision(cfg, c["dtype"])


# --------------------------------------------------------------------------- #
# JAX's engines
# --------------------------------------------------------------------------- #

def _jax_runs(out, tmp):
    """JAX's layers, then each case's engine (at its own mesh, or on the
    same global batch without ``tensor``): the initial master pickled
    for the ranks, then 3 steps."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm import mesh as JM

    out["layer"] = {name: jax_layer(*m) for name, m in LAYER_MESHES.items()}
    JM.reset_mesh()
    order = sorted(CASES, key=lambda n: CASES[n]["world"])
    for name in order:
        c = CASES[name]
        if c["jax_mesh"] is None:
            mesh, world, micro = c["mesh"], c["world"], c["micro"]
        else:
            mesh, world = c["jax_mesh"], c["jax_world"]
            micro = _rows(name) // world
        mm = _jax_mesh(mesh, world)
        engine, *_ = dst.initialize(
            model=dst.causal_lm_spec(MODEL, dtype=c["dtype"], **c["spec"]),
            config=_config(name, dict(mesh), micro), mesh_manager=mm)
        path = tmp / f"master0_{name}.pkl"
        part = path.with_suffix(".part")
        part.write_bytes(pickle.dumps(jax.tree.map(np.asarray,
                                                   engine.state["master"])))
        part.rename(path)
        data = iter(_batches(name, 2 * STEPS))
        losses, norms = [], []
        for _ in range(STEPS):
            losses.append(float(engine.train_batch(data)))
            norms.append(float(engine.get_global_grad_norm()))
        out[name] = {"losses": losses, "norms": norms,
                     "train_batch_size": engine.train_batch_size(),
                     "master": jax.tree.map(np.asarray,
                                            engine.state["master"])}
        del engine, mm
        JM.reset_mesh()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks started first; JAX's runs meanwhile → (JAX runs,
    {world: rank results}, tmp dir)."""
    from deepspeed_tpu.comm import comm as JC

    if not JC.is_initialized():     # else the engine builds a mesh of all 8
        JC.init_distributed(verbose=False)
    tmp = tmp_path_factory.mktemp("tmoe")
    collect = {world: _spawn_start(_world_rank, world,
                                   tmp_path_factory.mktemp(f"tmoe{world}"),
                                   str(tmp))
               for world in WORLDS}
    out = {}
    try:
        _jax_runs(out, tmp)
    finally:
        port, errors = {}, []
        for world, c in collect.items():
            try:
                port[world] = c()
            except AssertionError as e:
                errors.append(f"world {world}: {e}")
    assert not errors, "\n".join(errors)
    return out, port, tmp


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #

def _engine_rank(rank, master0, name, ckpt_dir):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    c = CASES[name]
    mesh = _mesh(name)
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(MODEL, dtype=c["dtype"], remat="full",
                                 **c["spec"]),
        config=_config(name, mesh, c["micro"]), device="cpu")
    load_master(engine, master0)
    data = iter(_batches(name, 2 * STEPS))
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(float(engine.train_batch(data)))
        norms.append(float(engine.get_global_grad_norm()))
    out = {"type": type(engine).__name__, "losses": losses, "norms": norms,
           "master": gather_master(engine), "mesh": mesh,
           "train_batch_size": engine.train_batch_size(),
           "local_up": next(tuple(s.shape) for s in engine._slots
                            if s.path == ("blocks", "w_up"))}
    if ckpt_dir is not None:
        engine.save_checkpoint(ckpt_dir, tag="tmoe")
        out["ckpt_moments"] = {
            f"{m}{k}": v for m in engine._opt_names()
            for k, v in _leaves(engine.full_tree(engine.state["opt"][m]))}
    engine.close()
    return out


def _fastgen_rank():
    """FastGen of ``tiny_moe`` at ``{tensor: 2}``: replicated with a
    warning (its greedy tokens against one process's), and ``tp=True``'s
    error."""
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.inference.fastgen import FastGenEngine

    kw = dict(n_blocks=32, block_size=16, max_blocks_per_seq=4,
              token_budget=64, temperature=0.0, seed=0, device="cpu",
              dtype="float32")
    prompts = [[5, 6, 7, 8], [9, 10, 11]]
    one = FastGenEngine(MODEL, **kw).generate_all([1, 2], prompts,
                                                  max_new_tokens=6)
    M.initialize_mesh(M.MeshConfig(tensor=2))
    out = {"one": one}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = FastGenEngine(MODEL, **kw)
    out["replicated"] = (eng.tp is None, [str(w.message) for w in caught],
                         eng.generate_all([1, 2], prompts, max_new_tokens=6))
    try:
        FastGenEngine(MODEL, tp=True, **kw)
        out["tp_true"] = None
    except NotImplementedError as e:
        out["tp_true"] = str(e)
    M.reset_mesh()
    return out


def _world_rank(rank, world, tmp):
    """The world's layer meshes first (no JAX input), FastGen at world 2,
    then every engine case of the world from JAX's initial masters."""
    import torch

    torch.set_num_threads(1)
    out = {"layer": {name: layer_rank(rank, world, m)
                     for name, (m, w) in LAYER_MESHES.items()
                     if w == world},
           "engine": {}}
    if world == 2:
        out["fastgen"] = _fastgen_rank()
    for name, case in CASES.items():
        if case["world"] != world:
            continue
        path = os.path.join(tmp, f"master0_{name}.pkl")
        _wait(path, "JAX master")
        master0 = pickle.loads(open(path, "rb").read())
        ckpt = os.path.join(tmp, "ckpt") if name == CKPT else None
        out["engine"][name] = _engine_rank(rank, master0, name, ckpt)
    return out


# --------------------------------------------------------------------------- #
# the checks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(LAYER_MESHES))
def test_moe_ffn_under_tensor_matches_jax(name, runs):
    """y, the aux loss and the gradients of x, the gate (whole and equal
    on every tensor rank) and both expert weights (each rank's ``mlp``
    slice) against JAX's layer at the same mesh; the experts' outputs
    summed over ``tensor`` once a forward (the ``tensor`` group), the
    replicated inputs' gradients once a backward: the token rows' and,
    without an expert axis, the combine weights' (under one the rows come
    back whole before the combine)."""
    jruns, port, _ = runs
    mesh, world = LAYER_MESHES[name]
    ranks = [r["layer"][name] for r in port[world]]
    check_layer(layer_sums(ranks, mesh), jruns["layer"][name], world)
    for r in ranks:
        # forward: y (or the received rows' outputs); backward: the
        # combine weights' and the token rows' gradients
        assert r["traffic"]["tensor/all_reduce"][0] == (
            2 if mesh.get("expert", 1) > 1 else 3), r["traffic"]


def _check_engine(name, got, want):
    tol = TOL["exact"]
    c = CASES[name]
    assert got["type"] == ("Zero3Engine" if c["stage"] == 3
                           else "DataParallelEngine")
    assert got["train_batch_size"] == want["train_batch_size"]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=tol["loss"], atol=0, err_msg=name)
    np.testing.assert_allclose(got["norms"], want["norms"], atol=0,
                               rtol=tol["loss"], err_msg=name)
    mine, theirs = dict(_leaves(got["master"])), dict(
        _leaves(want["master"]))
    assert sorted(mine) == sorted(theirs)
    diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                           for k in theirs])
    assert diff.max() <= tol["master"], (name, diff.max())
    assert diff.mean() <= tol["master_mean"], (name, diff.mean())


@pytest.mark.parametrize("name", [n for n in CASES if n not in BF16])
def test_engine_tensor_moe_matches_jax_engine(name, runs):
    """Every rank's losses (equal on every rank), grad norms and whole
    master against JAX's engine (the ragged dispatch's on the same global
    batch without ``tensor``, the dense one's at the same mesh); each
    rank holds E/X experts' F/T columns of ``w_up``."""
    jruns, port, _ = runs
    c = CASES[name]
    ranks = [r["engine"][name] for r in port[c["world"]]]
    X, T = ranks[0]["mesh"].get("expert", 1), ranks[0]["mesh"]["tensor"]
    for got in ranks:
        assert got["losses"] == ranks[0]["losses"], name
        assert got["local_up"] == (2, 4 // X, 64, 256 // T), got["local_up"]
        _check_engine(name, got, jruns[name])


@pytest.mark.parametrize("name", list(BF16))
def test_bf16_engine_tensor_moe_matches_jax(name, runs):
    """bf16 dense ``tiny_moe`` at ``{data: 2, tensor: 2}``: each rank's
    losses and master no further from JAX's fp32 run at the same mesh
    than ``LOW_VS_JAX`` times JAX's own bf16 run, metric by metric (a
    distance below ``TOL["exact"]``'s limit counting as that limit)."""
    jruns, port, _ = runs
    ref = jruns[BF16[name]]
    fp32 = dict(_leaves(ref["master"]))
    floor = np.array([TOL["exact"]["loss"], TOL["exact"]["master"],
                      TOL["exact"]["master_mean"]])

    def dist(losses, master):
        loss = np.max(np.abs(np.asarray(losses) - ref["losses"])
                      / np.abs(ref["losses"]))
        diff = np.concatenate([np.abs(v - fp32[k]).ravel()
                               for k, v in _leaves(master)])
        return np.array([loss, diff.max(), diff.mean()])

    theirs = np.maximum(floor, dist(jruns[name]["losses"],
                                    jruns[name]["master"]))
    for r, got in enumerate(p["engine"][name]
                            for p in port[CASES[name]["world"]]):
        mine = dist(got["losses"], got["master"])
        assert np.all(mine <= LOW_VS_JAX * theirs), (name, r, mine, theirs)


def test_auto_ep_etp_matches_jax(runs):
    """``auto_ep(etp_size=2)`` over 4 and 8 devices: the mesh section
    (``expert`` and ``tensor``) and the plan equal JAX's; the engine
    built on the 4-device section ran (its first loss JAX's
    ``{expert: 2}``'s, above)."""
    import deepspeed_tpu as dst
    from deepspeed_tpu.moe.auto_ep import auto_ep as jax_auto_ep

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.moe.auto_ep import auto_ep

    for n in (4, 8):
        _, mine, plan = auto_ep(dtt.causal_lm_spec(MODEL), n_devices=n,
                                etp_size=2)
        _, theirs, jplan = jax_auto_ep(dst.causal_lm_spec(MODEL),
                                       n_devices=n, etp_size=2)
        assert mine == theirs and mine["tensor"] == 2, (mine, theirs)
        assert plan.__dict__ == jplan.__dict__
    jruns, port, _ = runs
    for r in port[CASES[AUTO_EP]["world"]]:
        assert r["engine"][AUTO_EP]["mesh"] == {"expert": 2, "tensor": 2}
        np.testing.assert_allclose(r["engine"][AUTO_EP]["losses"][0],
                                   jruns[AUTO_EP]["losses"][0],
                                   rtol=TOL["exact"]["loss"], atol=0)


def test_expert_tensor_tag_loads_into_one_process(runs):
    """The ``{expert: 2, tensor: 2}`` tag holds every leaf whole (its
    experts gathered over ``expert`` and its ``mlp`` slices over
    ``tensor``): one process loads its master and both moments
    bit-equal."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as PM
    from deepspeed_tpu_torch.models.convert import gather_master

    _, port, tmp = runs
    got = port[CASES[CKPT]["world"]][0]["engine"][CKPT]
    PM.reset_mesh()
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(MODEL, dtype="float32", remat="full"),
        config=dict(_engine_config({"stage": 1}),
                    train_micro_batch_size_per_gpu=2), device="cpu")
    engine.load_checkpoint(str(tmp / "ckpt"), tag="tmoe")
    mine = dict(_leaves(gather_master(engine)))
    theirs = dict(_leaves(got["master"]))
    assert sorted(mine) == sorted(theirs)
    assert all(np.array_equal(mine[k], theirs[k]) for k in theirs)
    moments = {f"{m}{k}": v for m in engine._opt_names()
               for k, v in _leaves(engine._views(engine.state["opt"][m]))}
    assert sorted(moments) == sorted(got["ckpt_moments"])
    assert all(np.array_equal(np.asarray(moments[k]),
                              np.asarray(got["ckpt_moments"][k]))
               for k in moments)
    assert engine.global_steps == STEPS
    engine.close()


def test_fastgen_moe_under_tensor_serves_replicated(runs):
    """FastGen does not serve an MoE model tensor-parallel (queue A.5):
    under ``{tensor: 2}`` it serves it replicated with a warning naming
    the model (the same greedy tokens as one process), and ``tp=True``
    raises naming queue A.5."""
    _, port, _ = runs
    for r in port[2]:
        got = r["fastgen"]
        replicated, caught, tokens = got["replicated"]
        assert replicated
        assert any("FastGen TP disabled" in m and "an MoE model" in m
                   for m in caught), caught
        assert tokens == got["one"]
        assert got["tp_true"] is not None and "queue A.5" in got["tp_true"]
