"""The ``pipe`` axis composed with what JAX composes it with, against the
JAX package: ZeRO-3 and hpZ / MiCS, the ``expert`` and ``seq`` axes, the
offload tiers and ZenFlow, block-sparse attention and ``loss_tiles``.

Ranks run as spawned gloo processes on one intra-op thread, one spawn a
world (2, 4 and 8 ranks); JAX runs the same meshes on the conftest's 8
CPU devices, its engines in the test process in the order the ranks need
their initial masters (``_jax_order``), as in ``test_torch_pipeline.py``,
whose helpers this file takes.

* Each case: 3 masked steps from JAX's initial master against JAX's engine
  at the same mesh by ``test_torch_zero.TOL["exact"]`` (the losses equal
  on every rank, the grad norms, the whole master). World 2: ZeRO-3 with
  both schedules, ``offload_optimizer`` cpu (ZeRO-1) and nvme (ZeRO-2),
  ZeRO-3 with ``offload_param`` cpu, ZenFlow, ``sparse:fixed`` at a length
  whose layout leaves squares out (its loss differs from the dense one),
  ``loss_tiles`` 4 (not read under ``pipe``, as in JAX). World 4: ZeRO-3 at
  ``{pipe: 2, data: 2}`` on the uneven mask, hpZ at ``{pipe: 2, zshard:
  2}``, ``tiny_moe`` at ``{pipe: 2, expert: 2}`` (ZeRO-3), Ulysses at
  ``{pipe: 2, seq: 2}`` (ZeRO-1 and ZeRO-3). World 8: hpZ / MiCS at
  ``{pipe: 2, data: 2, zshard: 2}``, AutoSP at ``{pipe: 2, data: 2, seq:
  2}`` (ZeRO-2, a gpt2-style ``tiny``: learned positions, tied
  embeddings; AutoSP plans Ulysses). One bf16 case within ``LOW_VS_JAX``
  of JAX's own bf16 run.
* The ring attention under ``pipe`` raises a ``ValueError`` in both
  packages (JAX's ring shard_map does not nest in its pipeline's).
* ZeRO-3 under ``pipe`` gathers and reduces by formula (the head group
  once a schedule, each chunk of the stage's layers once a pass).
* A ``{pipe: 2, data: 2}`` ZeRO-3 tag loads bit-equal into one process
  and into ``{pipe: 2}`` ZeRO-1.

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
# sparse:fixed's causal layout at block 64 holds every square up to 5
# blocks; at 8 (512 tokens) it leaves 6 of 36 out
SPARSE_SEQ = 512
NVME = "<nvme>"
# tiny_llama: 49,984 elements a layer, so two chunks of a stage's two
# layers
Z3 = {"stage": 3, "stage3_prefetch_bucket_size": 20000}
HPZ = dict(Z3, zero_hpz_partition_size=2)
ZF = {"enabled": True, "topk_ratio": 0.1, "update_interval": 2}
_BASE = dict(world=2, mesh={"pipe": 2}, zero={"stage": 1},
             model="tiny_llama", schedule="1f1b", dtype="float32", micro=2,
             M=None, layers=4, spec={}, config={}, seq=SEQ)
CASES = {name: dict(_BASE, **kw) for name, kw in {
    "p2_zero3_1f1b": dict(zero=Z3),
    "p2_zero3_gpipe": dict(zero=Z3, schedule="gpipe"),
    "p2_offload_cpu": dict(zero={"stage": 1, "offload_optimizer": {
        "device": "cpu"}}),
    "p2_offload_nvme": dict(zero={"stage": 2, "offload_optimizer": {
        "device": "nvme", "nvme_path": NVME}}),
    "p2_zero3_offload_param_cpu": dict(zero=dict(Z3, offload_param={
        "device": "cpu"})),
    "p2_zenflow": dict(zero={"stage": 1, "zenflow": ZF}),
    "p2_sparse_fixed": dict(spec={"attention": "sparse:fixed",
                                  "max_seq_len": SPARSE_SEQ},
                            seq=SPARSE_SEQ, layers=2),
    "p2_loss_tiles4": dict(spec={"loss_tiles": 4}),
    "p2d2_zero3_uneven": dict(world=4, mesh={"pipe": 2, "data": 2},
                              zero=Z3),
    "p2d2_zero3_bf16": dict(world=4, mesh={"pipe": 2, "data": 2}, zero=Z3,
                            dtype="bfloat16"),
    "p2z2_zero3": dict(world=4, mesh={"pipe": 2, "zshard": 2}, zero=HPZ),
    "p2e2_moe": dict(world=4, mesh={"pipe": 2, "expert": 2},
                     zero={"stage": 3}, model="tiny_moe", layers=2),
    "p2s2_ulysses": dict(world=4, mesh={"pipe": 2, "seq": 2},
                         spec={"attention": "ulysses"}),
    "p2s2_ulysses_zero3": dict(world=4, mesh={"pipe": 2, "seq": 2},
                               zero=Z3, spec={"attention": "ulysses"}),
    "p2d2z2_zero3": dict(world=8, mesh={"pipe": 2, "data": 2, "zshard": 2},
                         zero=HPZ),
    "p2d2s2_zero2": dict(world=8, mesh={"pipe": 2, "data": 2, "seq": 2},
                         zero={"stage": 2}, model="tiny", config={
                             "sequence_parallel": {"auto": True,
                                                   "size": 2}}),
}.items()}
BF16 = {"p2d2_zero3_bf16": "p2d2_zero3_uneven"}
# the port cases each JAX engine (its default schedule, 1F1B) stands for
JAX_OF = {"p2_zero3_gpipe": "p2_zero3_1f1b"}
# the {pipe: 2, data: 2} ZeRO-3 tag: saved by CKPT's ranks, loaded into
# ONE process and into {pipe: 2} ZeRO-1
CKPT = "p2d2_zero3_uneven"
WORLDS = (2, 4, 8)
# the case whose mesh and model try the ring attention (which raises under
# pipe in both packages)
RING_OF = "p2s2_ulysses"


def _jax_order():
    """The JAX engines in the order the ranks need their initial masters:
    each world's next case in turn."""
    need = {w: [] for w in WORLDS}
    for name, case in CASES.items():
        src = JAX_OF.get(name, name)
        if src not in need[case["world"]]:
            need[case["world"]].append(src)
    return [need[w][k] for k in range(max(map(len, need.values())))
            for w in WORLDS if k < len(need[w])]


def _mask(rows, seq):
    """``test_torch_pipeline._uneven_mask`` at ``seq`` positions: row r
    keeps every (r % 4 + 1)-th position, the last row of four none past
    the first quarter."""
    mask = np.zeros((rows, seq), np.float32)
    for r in range(rows):
        mask[r, ::r % 4 + 1] = 1.0
        if r % 4 == 3:
            mask[r, seq // 4:] = 0.0
    return mask


def _batches(name, n):
    c = CASES[name]
    rows = _rows(name)
    return [{"tokens": np.random.default_rng(100 + i).integers(
        0, 512, (rows, c["seq"])).astype(np.int32),
        "loss_mask": _mask(rows, c["seq"])} for i in range(n)]


def _rows(name):
    """The global micro-batch: micro rows a batch rank (data × zshard ×
    expert)."""
    c = CASES[name]
    m = c["mesh"]
    return c["micro"] * m.get("data", 1) * m.get("zshard", 1) * m.get(
        "expert", 1)


def _spec_kw(name):
    c = CASES[name]
    kw = dict(dtype=c["dtype"], pipeline_schedule=c["schedule"],
              pipeline_micro_batches=c["M"], **c["spec"])
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
               train_micro_batch_size_per_gpu=c["micro"], **c["config"])
    return _precision(cfg, c["dtype"])


# --------------------------------------------------------------------------- #
# JAX's engines
# --------------------------------------------------------------------------- #

def _jax_engine(name, nvme):
    import deepspeed_tpu as dst

    c = CASES[name]
    mm = _jax_mesh(c["mesh"], c["world"])
    kw = _spec_kw(name)
    kw["pipeline_schedule"] = "1f1b"
    engine, *_ = dst.initialize(model=dst.causal_lm_spec(c["model"], **kw),
                                config=_case_config(name, nvme),
                                mesh_manager=mm)
    return engine, mm


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks started first; JAX's initial master of each case
    pickled for them (in ``_jax_order``), then its 3 steps → (JAX runs,
    {world: rank results}, tmp dir)."""
    from deepspeed_tpu.comm import comm as JC

    if not JC.is_initialized():     # else the engine builds a mesh of all 8
        JC.init_distributed(verbose=False)
    tmp = tmp_path_factory.mktemp("ppc")
    collect = {world: _spawn_start(_world_rank, world,
                                   tmp_path_factory.mktemp(f"ppc{world}"),
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
    """JAX's engines in ``_jax_order``: each initial master pickled for the
    ranks, then 3 steps; then its ring attention's error."""
    import jax

    from deepspeed_tpu.comm import mesh as JM

    for name in _jax_order():
        nvme = tmp_path_factory.mktemp("jax_nvme")
        engine, mm = _jax_engine(name, nvme)
        m0 = jax.tree.map(np.asarray, engine.state["master"])
        path = tmp / f"master0_{name}.pkl"
        part = path.with_suffix(".part")
        part.write_bytes(pickle.dumps(m0))
        part.rename(path)
        data = iter(_batches(name, 2 * STEPS))
        losses, norms = [], []
        for _ in range(STEPS):
            losses.append(float(engine.train_batch(data)))
            norms.append(engine.get_global_grad_norm())
        if engine._offload_param_nvme:
            engine._param_nvme_swapper().swap_in_params()
        out[name] = {
            "losses": losses, "norms": norms, "wire": engine._wire_format(),
            "train_batch_size": engine.train_batch_size(),
            "master": jax.tree.map(np.asarray, engine.state["master"])}
        del engine, mm
        JM.reset_mesh()
    out["ring"] = _jax_ring_error()


def _jax_ring_error():
    """JAX's ring attention at ``{pipe: 2, seq: 2}``: the error its first
    step raises (None if it ran)."""
    import deepspeed_tpu as dst
    from deepspeed_tpu.comm import mesh as JM

    name = RING_OF
    c = CASES[name]
    mm = _jax_mesh(c["mesh"], c["world"])
    try:
        engine, *_ = dst.initialize(
            model=dst.causal_lm_spec(c["model"], **dict(
                _spec_kw(name), attention="ring")),
            config=_case_config(name, None), mesh_manager=mm)
        engine.train_batch(iter(_batches(name, 2)))
    except ValueError as e:
        return type(e).__name__, str(e)
    finally:
        JM.reset_mesh()
    return None


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #

def _engine_rank(rank, master0, name, tmp, ckpt_dir):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    c = CASES[name]
    spec = dtt.causal_lm_spec(c["model"], remat="full", **_spec_kw(name))
    engine, *_ = dtt.initialize(
        model=spec, config=_case_config(name, os.path.join(
            tmp, f"nvme_{name}_{rank}")), device="cpu")
    load_master(engine, master0)
    data = iter(_batches(name, 2 * STEPS))
    losses, norms, counts = [], [], []
    for _ in range(STEPS):
        losses.append(float(engine.train_batch(data)))
        norms.append(engine.get_global_grad_norm())
        z = getattr(engine, "_zero3", None)
        counts.append(None if z is None else dict(z.counts))
    out = {"type": type(engine).__name__, "losses": losses, "norms": norms,
           "master": gather_master(engine), "wire": engine._wire_format(),
           "train_batch_size": engine.train_batch_size(),
           "stage": engine.mesh_manager.stage, "counts": counts,
           "chunks": (None if z is None else len(z.groups) - 1),
           "local_layers": engine._slots[0].shape[0]}
    if ckpt_dir is not None:
        engine.save_checkpoint(ckpt_dir, tag="ppc")
        if rank == 0:
            with open(ckpt_dir + "_ready", "w") as f:
                f.write("1")
        out["ckpt_moments"] = {
            f"{m}{k}": v for m in engine._opt_names()
            for k, v in _leaves(engine.full_tree(engine.state["opt"][m]))}
    if name == "p2_sparse_fixed":
        # the same model and steps with dense attention
        spec = dtt.causal_lm_spec(c["model"], remat="full", **dict(
            _spec_kw(name), attention=None))
        dense, *_ = dtt.initialize(model=spec,
                                   config=_case_config(name, None),
                                   device="cpu")
        load_master(dense, master0)
        data = iter(_batches(name, 2 * STEPS))
        out["dense_losses"] = [float(dense.train_batch(data))
                               for _ in range(STEPS)]
        out["dense_master"] = gather_master(dense)
        dense.close()
    engine.close()
    return out


def _load_rank(tmp):
    """The ZeRO-3 tag loaded at ``{pipe: 2}`` ZeRO-1: the gathered master
    and moments."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master

    _wait(os.path.join(tmp, "ckpt_ready"), "the ZeRO-3 tag")
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(CASES[CKPT]["model"], remat="full",
                                 **_spec_kw(CKPT)),
        config=dict(_engine_config({"stage": 1}), mesh={"pipe": 2},
                    train_micro_batch_size_per_gpu=_rows(CKPT)),
        device="cpu")
    engine.load_checkpoint(os.path.join(tmp, "ckpt"), tag="ppc")
    out = {"master": gather_master(engine), "moments": {
        f"{m}{k}": v for m in engine._opt_names()
        for k, v in _leaves(engine.full_tree(engine.state["opt"][m]))},
        "global_steps": engine.global_steps}
    engine.close()
    return out


def _world_rank(rank, world, tmp):
    """Every case of one world, in one spawn, from JAX's initial masters;
    world 2 then loads world 4's ZeRO-3 tag at ``{pipe: 2}`` ZeRO-1."""
    import torch

    torch.set_num_threads(1)
    out = {"engine": {}}
    masters = {}
    for name, case in CASES.items():
        if case["world"] != world:
            continue
        src = JAX_OF.get(name, name)
        path = os.path.join(tmp, f"master0_{src}.pkl")
        _wait(path, "JAX master")
        if path not in masters:
            masters[path] = pickle.loads(open(path, "rb").read())
        ckpt = os.path.join(tmp, "ckpt") if name == CKPT else None
        out["engine"][name] = _engine_rank(rank, masters[path], name, tmp,
                                           ckpt)
    if world == 2:
        out["zero3_into_p2_zero1"] = _load_rank(tmp)
    if world == CASES[RING_OF]["world"]:
        out["ring"] = _ring_rank()
    return out


def _ring_rank():
    """The port's ring attention at ``{pipe: 2, seq: 2}``: the error its
    first step raises (None if it ran)."""
    import deepspeed_tpu_torch as dtt

    c = CASES[RING_OF]
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(c["model"], remat="full", **dict(
            _spec_kw(RING_OF), attention="ring")),
        config=_case_config(RING_OF, None), device="cpu")
    try:
        engine.train_batch(iter(_batches(RING_OF, 2)))
    except ValueError as e:
        return type(e).__name__, str(e)
    finally:
        engine.close()
    return None


# --------------------------------------------------------------------------- #
# the checks
# --------------------------------------------------------------------------- #

def _check_engine(name, got, want, world, rank):
    tol = TOL["exact"]
    c = CASES[name]
    assert got["type"] == ("Zero3Engine" if c["zero"]["stage"] == 3
                           else "DataParallelEngine")
    assert got["wire"] == want["wire"] == "exact"
    assert got["train_batch_size"] == want["train_batch_size"]
    P = c["mesh"]["pipe"]
    assert got["stage"] == rank // (world // P)
    assert got["local_layers"] == c["layers"] // P
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
def test_engine_pipe_compose_matches_jax_engine(name, runs):
    """Every rank's losses (equal on every rank), grad norms and whole
    master against JAX's engine at the same mesh; each rank holds its
    stage's L/P layers."""
    jruns, port, _ = runs
    world = CASES[name]["world"]
    want = jruns[JAX_OF.get(name, name)]
    ranks = [r["engine"][name] for r in port[world]]
    for r, got in enumerate(ranks):
        assert got["losses"] == ranks[0]["losses"], (name, r)
        _check_engine(name, got, want, world, r)


@pytest.mark.parametrize("name", list(BF16))
def test_bf16_engine_pipe_compose_matches_jax(name, runs):
    """bf16 ZeRO-3 at ``{pipe: 2, data: 2}``: each rank's losses and master
    no further from JAX's fp32 run than ``LOW_VS_JAX`` times JAX's own
    bf16 run, metric by metric (a distance below ``TOL["exact"]``'s limit
    counting as that limit)."""
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

    want = jruns[name]
    theirs = np.maximum(floor, dist(want["losses"], want["master"]))
    for r, got in enumerate(p["engine"][name]
                            for p in port[CASES[name]["world"]]):
        mine = dist(got["losses"], got["master"])
        assert np.all(mine <= LOW_VS_JAX * theirs), (name, r, mine, theirs)


def test_sparse_layout_leaves_squares_out(runs):
    """``sparse:fixed`` at ``SPARSE_SEQ``: its layout leaves squares out,
    its losses differ from the same steps' with dense attention (by less
    than the loss tolerance on a model at its initial weights: 2e-7-5e-6
    relative), and the master after 3 steps differs from dense
    attention's by far more than the parity check's master tolerance, so
    the parity case could not pass on dense attention."""
    from deepspeed_tpu_torch.ops import block_sparse as B

    n = SPARSE_SEQ // 64
    assert B.causal_layout(B.fixed_layout(n)).sum() < n * (n + 1) // 2
    _, port, _ = runs
    tol = TOL["exact"]
    for r in port[2]:
        got = r["engine"]["p2_sparse_fixed"]
        loss = np.abs(np.asarray(got["losses"]) - got["dense_losses"]) \
            / np.abs(got["losses"])
        assert loss.min() > 0, (loss, got["losses"])
        dense = dict(_leaves(got["dense_master"]))
        diff = max(float(np.abs(v - dense[k]).max())
                   for k, v in _leaves(got["master"]))
        assert diff > 100 * tol["master"], diff


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n]["zero"]["stage"] == 3
                                  and CASES[n]["schedule"] == "1f1b"])
def test_zero3_pipe_gathers_by_formula(name, runs):
    """ZeRO-3 under 1F1B, a step of gas micro-batches of M pipeline
    micro-batches, c chunks a stage (remat full): the head group gathered
    once a schedule and reduced once (the extras' sums); each chunk
    gathered in the no-grad forward (not on the last stage), in each VJP's
    forward and in its recompute, and reduced once a VJP."""
    _, port, _ = runs
    c = CASES[name]
    P = c["mesh"]["pipe"]
    M = c["M"] or P
    gas = _engine_config({})["gradient_accumulation_steps"]
    for r in port[c["world"]]:
        got = r["engine"][name]
        ch, last = got["chunks"], got["stage"] == P - 1
        assert ch == (1 if c["model"] == "tiny_moe" else 2)
        want = {"gather_fwd": gas * (1 + M * ch * (1 if last else 2)),
                "gather_bwd": gas * M * ch, "reduce": gas * (M * ch + 1)}
        assert all(cnt == want for cnt in got["counts"]), (name, got)


def test_zero3_tag_loads_into_one_process(runs):
    """The ``{pipe: 2, data: 2}`` ZeRO-3 tag holds every leaf whole: one
    process loads its master and both moments bit-equal."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as PM
    from deepspeed_tpu_torch.models.convert import gather_master

    _, port, tmp = runs
    got = port[4][0]["engine"][CKPT]
    PM.reset_mesh()
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(CASES[CKPT]["model"], dtype="float32",
                                 remat="full", num_layers=4),
        config=dict(_engine_config({"stage": 1}),
                    train_micro_batch_size_per_gpu=2), device="cpu")
    engine.load_checkpoint(str(tmp / "ckpt"), tag="ppc")
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


def test_zero3_tag_loads_into_pipe2_zero1(runs):
    """The same tag at ``{pipe: 2}`` ZeRO-1: every rank's gathered master
    and moments bit-equal to the saver's."""
    _, port, _ = runs
    src = port[4][0]["engine"][CKPT]
    theirs = dict(_leaves(src["master"]))
    for got in (r["zero3_into_p2_zero1"] for r in port[2]):
        assert got["global_steps"] == STEPS
        mine = dict(_leaves(got["master"]))
        assert sorted(mine) == sorted(theirs)
        assert all(np.array_equal(mine[k], theirs[k]) for k in theirs)
        assert sorted(got["moments"]) == sorted(src["ckpt_moments"])
        assert all(np.array_equal(np.asarray(got["moments"][k]),
                                  np.asarray(src["ckpt_moments"][k]))
                   for k in src["ckpt_moments"])


def test_ring_attention_under_pipe_raises_as_jax(runs):
    """The ring attention under ``pipe``: JAX's first step raises a
    ``ValueError`` (its ring shard_map's mesh against the pipeline's
    context mesh), and so does the port's, naming it."""
    jruns, port, _ = runs
    assert jruns["ring"] is not None and jruns["ring"][0] == "ValueError"
    for r in port[CASES[RING_OF]["world"]]:
        kind, msg = r["ring"]
        assert kind == "ValueError" and "attention='ring'" in msg, r["ring"]
