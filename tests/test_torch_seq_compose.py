"""The ``seq`` axis composed with what JAX composes it with, against the
JAX package: hpZ / MiCS, MoE (an MoE model on the ragged and the dense
dispatch, an ``expert`` axis), the offload tiers, the host step and
ZenFlow, and ``pipe`` with hpZ.

Ranks run as spawned gloo processes on one intra-op thread, one spawn a
world (2, 4 and 8 ranks); JAX runs the same meshes on the conftest's 8
CPU devices, its engines in the test process in the order the ranks need
their initial masters, as in ``test_torch_pipe_compose.py``.

* ``moe_ffn`` at ``{seq: 2}`` and ``{expert: 2, seq: 2}`` against JAX's at
  the same mesh: y, the aux loss and every gradient within
  ``LAYER_TOL``, the drop monitor's share equal.
* Each engine case: 3 masked steps from JAX's initial master against
  JAX's engine at the same mesh by ``test_torch_zero.TOL["exact"]`` (the
  losses equal on every rank, the grad norms, the whole master). World 2:
  ``tiny_moe`` at ``{seq: 2}`` (ZeRO-1, ragged; ZeRO-2, dense), and
  ``tiny_llama`` with ``offload_optimizer`` cpu (ZeRO-1) and nvme (ZeRO-2),
  ``offload_param`` cpu (ZeRO-3), the sync host step and ZenFlow. World 4:
  ``tiny_moe`` at ``{expert: 2, seq: 2}`` (ZeRO-2 ragged and dense,
  ZeRO-3), hpZ at ``{zshard: 2, seq: 2}`` (ZeRO-3). World 8: MiCS at
  ``{data: 2, zshard: 2, seq: 2}`` (ZeRO-2), ``tiny_moe`` hpZ at
  ``{zshard: 2, expert: 2, seq: 2}`` (ZeRO-3), hpZ at ``{pipe: 2, zshard:
  2, seq: 2}`` (ZeRO-3). One bf16 case (the dense dispatch at ``{seq:
  2}``) within ``LOW_VS_JAX`` of JAX's own bf16 run; one (the dense
  dispatch at ``{expert: 2, seq: 2}``) over three batch seeds within
  ``LOW_VS_JAX`` of the largest of JAX's bf16 distances at the same mesh
  and on one device over those seeds.
* The ``{zshard: 2, seq: 2}`` ZeRO-3 tag loads bit-equal into one process.

jax is imported inside the fixtures and tests, never at the top: a
spawned rank imports this module to find its function.
"""
import os
import pickle

import numpy as np
import pytest

from test_torch_expert_parallel import _jax_mesh, _spawn_start
from test_torch_pipeline import STEPS, _wait
from test_torch_zero import TOL, _engine_config, _leaves
from test_torch_zero3 import LOW_VS_JAX, _precision

SEQ = 32
NVME = "<nvme>"
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
ZF = {"enabled": True, "topk_ratio": 0.1, "update_interval": 2}
Z3 = {"stage": 3}
HPZ3 = dict(Z3, zero_hpz_partition_size=2)
_BASE = dict(world=2, mesh={"seq": 2}, zero={"stage": 1},
             model="tiny_llama", dtype="float32", micro=2, layers=2,
             spec={}, schedule="1f1b")
CASES = {name: dict(_BASE, **kw) for name, kw in {
    "s2_moe": dict(model="tiny_moe"),
    "s2_moe_dense": dict(model="tiny_moe", zero={"stage": 2},
                         spec={"moe_dispatch": "dense"}),
    "s2_moe_dense_bf16": dict(model="tiny_moe", zero={"stage": 2},
                              spec={"moe_dispatch": "dense"},
                              dtype="bfloat16"),
    "s2_offload_cpu": dict(zero={"stage": 1, "offload_optimizer": {
        "device": "cpu"}}),
    "s2_offload_nvme": dict(zero={"stage": 2, "offload_optimizer": {
        "device": "nvme", "nvme_path": NVME}}),
    "s2_offload_param_cpu": dict(zero=dict(Z3, offload_param={
        "device": "cpu"})),
    "s2_host_step": dict(zero={"stage": 1, "offload_optimizer": {
        "device": "cpu", "host_step": True}}),
    "s2_zenflow": dict(zero={"stage": 1, "zenflow": ZF}),
    "e2s2_moe_zero2": dict(world=4, mesh={"expert": 2, "seq": 2},
                           zero={"stage": 2}, model="tiny_moe"),
    "e2s2_moe_dense_zero2": dict(world=4, mesh={"expert": 2, "seq": 2},
                                 zero={"stage": 2}, model="tiny_moe",
                                 spec={"moe_dispatch": "dense"}),
    "e2s2_moe_dense_bf16": dict(world=4, mesh={"expert": 2, "seq": 2},
                                zero={"stage": 2}, model="tiny_moe",
                                spec={"moe_dispatch": "dense"},
                                dtype="bfloat16"),
    "e2s2_moe_zero3": dict(world=4, mesh={"expert": 2, "seq": 2}, zero=Z3,
                           model="tiny_moe"),
    "z2s2_hpz_zero3": dict(world=4, mesh={"zshard": 2, "seq": 2},
                           zero=HPZ3),
    "d2z2s2_mics_zero2": dict(world=8, mesh={"data": 2, "zshard": 2,
                                             "seq": 2},
                              zero={"stage": 2, "mics_shard_size": 2}),
    "z2e2s2_moe_hpz_zero3": dict(world=8, mesh={"zshard": 2, "expert": 2,
                                                "seq": 2},
                                 zero=HPZ3, model="tiny_moe"),
    "p2z2s2_hpz_zero3": dict(world=8, mesh={"pipe": 2, "zshard": 2,
                                            "seq": 2},
                             zero=HPZ3, layers=4),
}.items()}
# JAX's ragged MoE in bf16 under seq aborts XLA's CPU compiler ("Invalid
# binary instruction opcode copy", queue C): the bf16 cases are the dense
# dispatch's (name → its fp32 case)
BF16 = {"s2_moe_dense_bf16": "s2_moe_dense",
        "e2s2_moe_dense_bf16": "e2s2_moe_dense_zero2"}
# bf16 cases held over several batch seeds (seed 0: the other cases'
# batches), against JAX's bf16 runs at the same mesh (seed 0) and on one
# device (every seed): a
# few of the gate's routes flip under bf16 rounding, each package's
# others, and Adam (eps 1e-3) magnifies the small gradients this moves,
# so one seed's distance is one draw of that noise
# (tests/torch_bf16_witness.py measures it)
WITNESS = {"e2s2_moe_dense_bf16": (0, 1, 2)}
# the {zshard: 2, seq: 2} ZeRO-3 tag: saved by its ranks, loaded into ONE
# process
CKPT = "z2s2_hpz_zero3"
PIPE_FIRST = "p2z2s2_hpz_zero3"
WORLDS = (2, 4, 8)
# moe_ffn's meshes: name → (mesh, world)
LAYER_MESHES = {"seq2": ({"seq": 2}, 2),
                "expert2_seq2": ({"expert": 2, "seq": 2}, 4)}


def _jax_order():
    """The JAX engines in the order the ranks need their initial masters:
    each world's next case in turn, the pipelined one first (JAX's
    pipeline engine built after the others in one pytest process hung in
    its CPU collectives' rendezvous)."""
    need = {w: [n for n, c in CASES.items() if c["world"] == w
                and n != PIPE_FIRST] for w in WORLDS}
    return [PIPE_FIRST] + [need[w][k] for k in range(max(map(
        len, need.values()))) for w in WORLDS if k < len(need[w])]


def _mask(rows, seq):
    """Row r keeps every (r % 4 + 1)-th position, the last row of four
    none past the first quarter (another count on each seq shard)."""
    mask = np.zeros((rows, seq), np.float32)
    for r in range(rows):
        mask[r, ::r % 4 + 1] = 1.0
        if r % 4 == 3:
            mask[r, seq // 4:] = 0.0
    return mask


def _rows(name):
    """The global micro-batch: micro rows a batch rank (data × zshard ×
    expert)."""
    c = CASES[name]
    world = c["world"] // c["mesh"].get("seq", 1) // c["mesh"].get(
        "pipe", 1)
    return c["micro"] * world


def _batches(name, n, seed=0):
    rows = _rows(name)
    return [{"tokens": np.random.default_rng(1000 * seed + 100 + i).integers(
        0, 512, (rows, SEQ)).astype(np.int32),
        "loss_mask": _mask(rows, SEQ)} for i in range(n)]


def _spec_kw(name):
    c = CASES[name]
    kw = dict(dtype=c["dtype"], attention="ulysses", **c["spec"])
    if c["model"] != "tiny_moe":
        kw["num_layers"] = c["layers"]
    return kw


def _case_config(name, nvme):
    c = CASES[name]
    zero = pickle.loads(pickle.dumps(c["zero"]))
    for off in ("offload_optimizer", "offload_param"):
        if zero.get(off, {}).get("nvme_path") == NVME:
            zero[off]["nvme_path"] = str(nvme)
    cfg = dict(_engine_config(zero), mesh=dict(c["mesh"]),
               train_micro_batch_size_per_gpu=c["micro"])
    return _precision(cfg, c["dtype"])


# --------------------------------------------------------------------------- #
# moe_ffn: inputs, JAX's layer, a rank's layer, the ranks' sums
# --------------------------------------------------------------------------- #

def layer_inputs(E=4, H=16, F=32, B=4, S=8, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    gate_w = (0.5 * rng.standard_normal((H, E))).astype(np.float32)
    experts = {"w_up": (0.1 * rng.standard_normal((E, H, F))).astype(
                   np.float32),
               "w_down": (0.1 * rng.standard_normal((E, F, H))).astype(
                   np.float32)}
    return x, gate_w, experts


def jax_layer(mesh, world, dispatch="ragged"):
    """JAX's moe_ffn on ``mesh``: y, aux, the drop monitor's readings and
    the gradients of Σ y² + N · aux, N the ranks off ``tensor`` (the
    ranks of the aux's mean)."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.moe import layer as JL

    x, gate_w, experts = layer_inputs()
    n = world // mesh.get("tensor", 1)
    mm = _jax_mesh(mesh, world)
    seen = []
    JL.set_drop_monitor(lambda f: seen.append(float(f)))
    try:
        def loss(p):
            y, aux = JL.moe_ffn(p["x"], p["g"], {"w_up": p["u"],
                                                  "w_down": p["d"]},
                                k=2, dispatch=dispatch)
            return jnp.sum(y ** 2) + n * aux, (y, aux)

        params = {"x": jnp.asarray(x), "g": jnp.asarray(gate_w),
                  "u": jnp.asarray(experts["w_up"]),
                  "d": jnp.asarray(experts["w_down"])}
        with mm.mesh:
            (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(params)
            jax.effects_barrier()
        return {"y": np.asarray(y), "aux": float(aux), "drops": seen,
                "grads": {kk: np.asarray(v) for kk, v in grads.items()}}
    finally:
        JL.set_drop_monitor(None)


def layer_rank(rank, world, mesh, dispatch="ragged"):
    """This rank's moe_ffn at ``mesh``: its rows and positions of x (its
    batch index's rows, its seq coordinate's positions), its experts'
    ``mlp`` slices (its expert and tensor coordinates); y, the aux loss,
    the gradients of Σ y² + aux, the drop monitor's readings and the
    traffic."""
    import torch

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.moe import layer as L

    mm = M.initialize_mesh(M.MeshConfig(**mesh))
    x, gate_w, experts = layer_inputs()
    B, S = x.shape[:2]
    c, q, t = (mm.coords[a] for a in ("expert", "seq", "tensor"))
    X, Q, T = mm.ep_world_size, mm.sp_world_size, mm.tp_world_size
    bw, bi = mm.batch_world_size, mm.batch_rank
    n, s = B // bw, S // Q
    xr = torch.from_numpy(np.ascontiguousarray(
        x[bi * n:(bi + 1) * n, q * s:(q + 1) * s])).requires_grad_(True)
    g = torch.from_numpy(gate_w).requires_grad_(True)
    E_l, F_l = gate_w.shape[1] // X, experts["w_up"].shape[-1] // T
    ex = {"w_up": experts["w_up"][c * E_l:(c + 1) * E_l, :,
                                  t * F_l:(t + 1) * F_l],
          "w_down": experts["w_down"][c * E_l:(c + 1) * E_l,
                                      t * F_l:(t + 1) * F_l]}
    ex = {kk: torch.from_numpy(np.ascontiguousarray(v)).requires_grad_(True)
          for kk, v in ex.items()}
    seen = []
    L.set_drop_monitor(lambda f: seen.append(float(f)))
    dtt.comm.reset_traffic()
    try:
        y, aux = L.moe_ffn(xr, g, ex, k=2, dispatch=dispatch,
                           tp=mm.tensor())
    finally:
        L.set_drop_monitor(None)
    ((y ** 2).sum() + aux).backward()
    out = {"y": y.detach().numpy(), "aux": float(aux),
           "dx": xr.grad.numpy(), "dg": g.grad.numpy(),
           "du": ex["w_up"].grad.numpy(), "dd": ex["w_down"].grad.numpy(),
           "coords": (bi, q, c, t), "drops": seen,
           "traffic": {kk: list(v) for kk, v in dtt.comm.traffic.items()}}
    dtt.comm.reset_traffic()
    M.reset_mesh()
    return out


def layer_sums(ranks, mesh):
    """The ranks' layer results as JAX's: y and dx laid out by each rank's
    rows and positions (every tensor rank's the same), the gate's
    gradient summed over the ranks of one tensor coordinate (equal on
    each), the experts' summed over the ranks of one expert and tensor
    coordinate and laid out by both."""
    x, gate_w, experts = layer_inputs()
    B, S, _ = x.shape
    Q, X, T = (mesh.get(a, 1) for a in ("seq", "expert", "tensor"))
    bw = len(ranks) // (Q * T)
    n, s = B // bw, S // Q
    E_l, F_l = gate_w.shape[1] // X, experts["w_up"].shape[-1] // T
    y = {t: np.zeros_like(x) for t in range(T)}
    dx = {t: np.zeros_like(x) for t in range(T)}
    dg = {t: np.zeros_like(gate_w) for t in range(T)}
    du = np.zeros_like(experts["w_up"])
    dd = np.zeros_like(experts["w_down"])
    for r in ranks:
        bi, q, c, t = r["coords"]
        y[t][bi * n:(bi + 1) * n, q * s:(q + 1) * s] = r["y"]
        dx[t][bi * n:(bi + 1) * n, q * s:(q + 1) * s] = r["dx"]
        dg[t] += r["dg"]
        du[c * E_l:(c + 1) * E_l, :, t * F_l:(t + 1) * F_l] += r["du"]
        dd[c * E_l:(c + 1) * E_l, t * F_l:(t + 1) * F_l] += r["dd"]
    for t in range(1, T):
        for a in (y, dx, dg):
            np.testing.assert_array_equal(a[t], a[0], err_msg=f"tensor {t}")
    return {"y": y[0], "aux": [r["aux"] for r in ranks], "x": dx[0],
            "g": dg[0], "u": du, "d": dd}


def check_layer(got, want, world):
    np.testing.assert_allclose(got["y"], want["y"], **LAYER_TOL)
    np.testing.assert_allclose(got["aux"], [want["aux"]] * world,
                               rtol=1e-6, atol=0)
    for key in ("x", "g", "u", "d"):
        np.testing.assert_allclose(got[key], want["grads"][key],
                                   err_msg=key, **LAYER_TOL)


# --------------------------------------------------------------------------- #
# JAX's engines
# --------------------------------------------------------------------------- #

def _jax_engine(name, nvme, one=False):
    """JAX's engine of case ``name`` at its mesh, or (``one``) on one
    device with the same global batch."""
    import deepspeed_tpu as dst

    c = CASES[name]
    cfg, kw = _case_config(name, nvme), _spec_kw(name)
    if one:
        cfg.update(mesh={}, train_micro_batch_size_per_gpu=_rows(name))
        kw.pop("attention")
    mm = _jax_mesh(cfg["mesh"], 1 if one else c["world"])
    engine, *_ = dst.initialize(
        model=dst.causal_lm_spec(c["model"], **kw), config=cfg,
        mesh_manager=mm)
    return engine, mm


def _jax_train(engine, name, seed=0):
    """JAX's 3 steps on seed ``seed``'s batches → losses, grad norms and
    the master."""
    import jax

    data = iter(_batches(name, 2 * STEPS, seed))
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(float(engine.train_batch(data)))
        norms.append(float(engine.get_global_grad_norm()))
    return {"losses": losses, "norms": norms,
            "master": jax.tree.map(np.asarray, engine.state["master"])}


def _jax_witness(name, tmp_path_factory):
    """A ``WITNESS`` case's runs on one device, seed by seed: JAX's bf16
    run, and for seeds past 0 its fp32 run (seed 0's fp32 run is the
    fp32 case's at the mesh; on one device JAX's fp32 losses and master
    are its same-mesh ones within ``TOL["exact"]``)."""
    from deepspeed_tpu.comm import mesh as JM

    out = {}
    for seed in WITNESS[name]:
        for key, case in [("16o", name)] + ([("32o", BF16[name])]
                                            if seed else []):
            engine, mm = _jax_engine(case, tmp_path_factory.mktemp("jw"),
                                     one=True)
            out[(seed, key)] = _jax_train(engine, case, seed)
            del engine, mm
            JM.reset_mesh()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks started first; JAX's layers, then its initial
    master of each case pickled for them (in ``_jax_order``) and its 3
    steps → (JAX runs, {world: rank results}, tmp dir)."""
    from deepspeed_tpu.comm import comm as JC

    if not JC.is_initialized():     # else the engine builds a mesh of all 8
        JC.init_distributed(verbose=False)
    tmp = tmp_path_factory.mktemp("sqc")
    collect = {world: _spawn_start(_world_rank, world,
                                   tmp_path_factory.mktemp(f"sqc{world}"),
                                   str(tmp))
               for world in WORLDS}
    out = {}
    try:
        _jax_runs(out, tmp, tmp_path_factory)
    finally:
        # every world collected (its ranks stopped) whatever failed
        port, errors = {}, []
        for world, c in collect.items():
            try:
                port[world] = c()
            except AssertionError as e:
                errors.append(f"world {world}: {e}")
    assert not errors, "\n".join(errors)
    return out, port, tmp


def _jax_runs(out, tmp, tmp_path_factory):
    import jax

    from deepspeed_tpu.comm import mesh as JM

    out["layer"] = {name: jax_layer(*m) for name, m in LAYER_MESHES.items()}
    JM.reset_mesh()
    for name in _jax_order():
        nvme = tmp_path_factory.mktemp("jax_nvme")
        engine, mm = _jax_engine(name, nvme)
        m0 = jax.tree.map(np.asarray, engine.state["master"])
        path = tmp / f"master0_{name}.pkl"
        part = path.with_suffix(".part")
        part.write_bytes(pickle.dumps(m0))
        part.rename(path)
        out[name] = dict(_jax_train(engine, name),
                         wire=engine._wire_format(),
                         train_batch_size=engine.train_batch_size())
        del engine, mm
        JM.reset_mesh()
        if name in WITNESS:
            out[name]["witness"] = _jax_witness(name, tmp_path_factory)


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #

def _engine_rank(rank, master0, name, tmp, ckpt_dir, seed=0):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    c = CASES[name]
    spec = dtt.causal_lm_spec(c["model"], remat="full", **_spec_kw(name))
    engine, *_ = dtt.initialize(
        model=spec, config=_case_config(name, os.path.join(
            tmp, f"nvme_{name}_{rank}")), device="cpu")
    load_master(engine, master0)
    data = iter(_batches(name, 2 * STEPS, seed))
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(float(engine.train_batch(data)))
        norms.append(float(engine.get_global_grad_norm()))
    out = {"type": type(engine).__name__, "losses": losses, "norms": norms,
           "master": gather_master(engine), "wire": engine._wire_format(),
           "train_batch_size": engine.train_batch_size(),
           "host_state": (engine.flat_master.device.type
                          if engine._host_runner is not None else None)}
    if ckpt_dir is not None:
        engine.save_checkpoint(ckpt_dir, tag="sqc")
        out["ckpt_moments"] = {
            f"{m}{k}": v for m in engine._opt_names()
            for k, v in _leaves(engine.full_tree(engine.state["opt"][m]))}
    engine.close()
    return out


def _world_rank(rank, world, tmp):
    """The world's layer meshes first (no JAX input), then every engine
    case of the world from JAX's initial masters."""
    import torch

    torch.set_num_threads(1)
    out = {"layer": {name: layer_rank(rank, world, m)
                     for name, (m, w) in LAYER_MESHES.items()
                     if w == world},
           "engine": {}}
    for name in _jax_order():
        if CASES[name]["world"] != world:
            continue
        path = os.path.join(tmp, f"master0_{name}.pkl")
        _wait(path, "JAX master")
        master0 = pickle.loads(open(path, "rb").read())
        ckpt = os.path.join(tmp, "ckpt") if name == CKPT else None
        out["engine"][name] = _engine_rank(rank, master0, name, tmp, ckpt)
        for seed in WITNESS.get(name, (0,))[1:]:
            out["engine"][name][f"seed{seed}"] = _engine_rank(
                rank, master0, name, tmp, None, seed)
    return out


# --------------------------------------------------------------------------- #
# the checks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(LAYER_MESHES))
def test_moe_ffn_under_seq_matches_jax(name, runs):
    """y, the aux loss (equal on every rank) and the gradients of x, the
    gate and both expert weights against JAX's layer at the same mesh;
    the drop monitor's shares equal JAX's (each rank's the global one)."""
    jruns, port, _ = runs
    mesh, world = LAYER_MESHES[name]
    want = jruns["layer"][name]
    ranks = [r["layer"][name] for r in port[world]]
    check_layer(layer_sums(ranks, mesh), want, world)
    for r in ranks:
        np.testing.assert_allclose(r["drops"], want["drops"], rtol=1e-6,
                                   atol=0)
        # the aux's token means over the batch axes and seq: forward and
        # backward on the layer's own group
        assert r["traffic"]["batch/all_reduce"][0] == (
            3 if mesh.get("expert", 1) > 1 else 2), r["traffic"]


def _check_engine(name, got, want, rank):
    tol = TOL["exact"]
    c = CASES[name]
    assert got["type"] == ("Zero3Engine" if c["zero"]["stage"] == 3
                           else "DataParallelEngine")
    assert got["wire"] == want["wire"] == "exact"
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
    assert diff.max() <= tol["master"], (name, rank, diff.max())
    assert diff.mean() <= tol["master_mean"], (name, rank, diff.mean())


@pytest.mark.parametrize("name", [n for n in CASES if n not in BF16])
def test_engine_seq_compose_matches_jax_engine(name, runs):
    """Every rank's losses (equal on every rank), grad norms and whole
    master against JAX's engine at the same mesh; the host step's master
    lives in host memory."""
    jruns, port, _ = runs
    ranks = [r["engine"][name] for r in port[CASES[name]["world"]]]
    for r, got in enumerate(ranks):
        assert got["losses"] == ranks[0]["losses"], (name, r)
        _check_engine(name, got, jruns[name], r)
        assert got["host_state"] == ("cpu" if name == "s2_host_step"
                                     else None)


def _dist(ref, run):
    """(relative loss, master max, master mean) of ``run`` from ``ref``."""
    fp32 = dict(_leaves(ref["master"]))
    loss = np.max(np.abs(np.asarray(run["losses"]) - ref["losses"])
                  / np.abs(ref["losses"]))
    diff = np.concatenate([np.abs(v - fp32[k]).ravel()
                           for k, v in _leaves(run["master"])])
    return np.array([loss, diff.max(), diff.mean()])


@pytest.mark.parametrize("name", list(BF16))
def test_bf16_engine_seq_compose_matches_jax(name, runs):
    """bf16 dense ``tiny_moe``: each rank's losses and master no further
    from JAX's fp32 run than ``LOW_VS_JAX`` times JAX's own bf16 run at the
    same mesh, metric by metric (a distance below ``TOL["exact"]``'s limit
    counting as that limit); a ``WITNESS`` case on each of its batch
    seeds (seeds past 0 against JAX's fp32 run on one device), against
    the largest of JAX's bf16 distances at the same mesh (seed 0) and on
    one device (every seed)."""
    jruns, port, _ = runs
    floor = np.array([TOL["exact"]["loss"], TOL["exact"]["master"],
                      TOL["exact"]["master_mean"]])
    ranks = [p["engine"][name] for p in port[CASES[name]["world"]]]
    seeds = WITNESS.get(name, (0,))
    w = jruns[name].get("witness", {})
    ref = {s: w[(s, "32o")] if s else jruns[BF16[name]] for s in seeds}
    theirs = np.maximum(floor, _dist(ref[0], jruns[name]))
    for s in seeds:
        if w:
            theirs = np.maximum(theirs, _dist(ref[s], w[(s, "16o")]))
    for s in seeds:
        for r, got in enumerate(ranks):
            mine = _dist(ref[s], got[f"seed{s}"] if s else got)
            assert np.all(mine <= LOW_VS_JAX * theirs), (name, s, r, mine,
                                                         theirs)


def test_hpz_seq_tag_loads_into_one_process(runs):
    """The ``{zshard: 2, seq: 2}`` ZeRO-3 tag holds every leaf whole: one
    process loads its master and both moments bit-equal."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as PM
    from deepspeed_tpu_torch.models.convert import gather_master

    _, port, tmp = runs
    got = port[CASES[CKPT]["world"]][0]["engine"][CKPT]
    PM.reset_mesh()
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(CASES[CKPT]["model"], remat="full",
                                 **dict(_spec_kw(CKPT), attention=None)),
        config=dict(_engine_config({"stage": 1}),
                    train_micro_batch_size_per_gpu=2), device="cpu")
    engine.load_checkpoint(str(tmp / "ckpt"), tag="sqc")
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
