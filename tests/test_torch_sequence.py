"""Sequence parallelism of the PyTorch port (the ``seq`` mesh axis)
against the JAX package.

Ranks run as spawned gloo processes on one intra-op thread
(``test_torch_expert_parallel._spawn_start``), one spawn a world: 2 and 4
ranks. JAX runs the same meshes on the conftest's 8 CPU devices
meanwhile.

* The attentions: ``ulysses_attention``, ``ulysses_attention_shard_map``
  and ``ring_attention`` at ``sp`` 2 and 4, causal and not, with GQA at
  ``kv_heads < sp`` (Ulysses repeats the KV heads up to sp, the ring
  repeats them locally). Each rank gives its positions of q, k and v and
  differentiates Σ o·w of its positions; JAX the whole arrays on a
  ``{seq: sp}`` mesh. Outputs and q, k, v gradients within ``ATOL``.
* One process: ``chunked_attention``, ``fpdt_attention``,
  ``tiled_lm_loss`` with and without a loss mask (a length the tiles do
  not divide: padded) and ``sequence_tiled_compute``, values and
  gradients against JAX.
* The engines: ``tiny_llama`` (RoPE, RMSNorm, GQA) and ``tiny`` (learned
  positions, LayerNorm) fp32, remat full, 3 steps from JAX's initial
  master on batches whose ``loss_mask`` keeps a different number of
  tokens on each seq shard (and none on one shard in one micro-batch),
  against the JAX engine at the same mesh: ``{seq: 2}`` (ulysses,
  ulysses_flash, ring; ZeRO-1 and ZeRO-2), ``{seq: 4}`` (ring),
  ``{data: 2, seq: 2}`` (ulysses; ZeRO-2 exact with ``overlap_comm`` on,
  and ZeRO-3 exact), ZeRO-2 with qgZ + qwZ asked for at ``{seq: 2}``
  (both packages warn and run the exact wire) and
  ``{"sequence_parallel": {"auto": true}}`` at ``{seq: 2}``. Losses
  (equal on every rank), the grad norm and the whole master by
  ``test_torch_zero.TOL["exact"]``; the batch triad over data × zshard ×
  expert as JAX's (``train_batch_size``); the traffic on the attentions'
  ``seq`` group by count.
* A checkpoint saved at ``{seq: 2}`` and at ``{data: 2, seq: 2}`` loads
  into one process bit-equal to the ranks' master and moments.
* AutoSP: ``detect_sp_info`` / ``plan_sp`` / ``auto_sp`` against JAX's on
  the cases of ``tests/unit/test_auto_sp_ep.py``.

jax is imported inside the fixtures and tests, never at the top: a
spawned rank imports this module to find its function.
"""
import dataclasses
import os
import pickle
import time

import numpy as np
import pytest

from test_torch_expert_parallel import _jax_mesh, _spawn_start
from test_torch_zero import TOL, _engine_config, _leaves

SEQ = 32
ATOL = 2e-5
# (B, S, N, K, D) of the attention cases; K < sp at both sp
ATT_SHAPE = {2: (2, 16, 4, 1, 8), 4: (1, 16, 4, 2, 8)}
ATT_FNS = ("ulysses", "ulysses_shard_map", "ring")
ATT_CASES = [(sp, fn, causal) for sp in (2, 4) for fn in ATT_FNS
             for causal in (True, False)]
INT8 = {"zero_quantized_gradients": True, "zero_quantized_weights": True}
# name → (world, mesh, zero, model, port attention, JAX attention, extra)
CASES = {
    "s2_ulysses_zero1": (2, {"seq": 2}, {"stage": 1}, "tiny_llama",
                         "ulysses", "ulysses", {}),
    "s2_ulysses_flash_gpt2": (2, {"seq": 2}, {"stage": 1}, "tiny",
                              "ulysses_flash", "ulysses", {}),
    "s2_ring_zero2": (2, {"seq": 2}, {"stage": 2}, "tiny_llama", "ring",
                      "ring", {}),
    "s2_int8_exact_fallback": (2, {"seq": 2}, dict(INT8, stage=2),
                               "tiny_llama", "ulysses", "ulysses", {}),
    "s2_autosp": (2, {"seq": 2}, {"stage": 1}, "tiny_llama", None, None,
                  {"sequence_parallel": {"auto": True, "size": 2}}),
    "s2_autosp_flash": (2, {"seq": 2}, {"stage": 1}, "tiny_llama", "flash",
                        "flash",
                        {"sequence_parallel": {"auto": True, "size": 2}}),
    "s4_ring_zero2": (4, {"seq": 4}, {"stage": 2}, "tiny_llama", "ring",
                      "ring", {}),
    "d2s2_ulysses_zero2_overlap": (4, {"data": 2, "seq": 2},
                                   {"stage": 2, "overlap_comm": True},
                                   "tiny_llama", "ulysses", "ulysses", {}),
    "d2s2_ulysses_zero3": (4, {"data": 2, "seq": 2}, {"stage": 3},
                           "tiny_llama", "ulysses", "ulysses", {}),
}
STEPS = 3
CKPT = {2: "s2_ulysses_zero1", 4: "d2s2_ulysses_zero2_overlap"}
# what a seq axis does not compose with yet (queue A.4): name → (world,
# mesh, extra config, model, what the error names). Every composition JAX
# runs under seq is a parity case of tests/test_torch_seq_compose.py; a
# tensor axis beside seq stays refused
REFUSED = {
    "tensor": (4, {"seq": 2, "tensor": 2}, {}, "tiny_llama", "seq > 1"),
}
WORLDS = (2, 4)


def _att_inputs(sp):
    B, S, N, K, D = ATT_SHAPE[sp]
    rng = np.random.default_rng(sp)
    return {"q": rng.standard_normal((B, S, N, D), np.float32),
            "k": rng.standard_normal((B, S, K, D), np.float32),
            "v": rng.standard_normal((B, S, K, D), np.float32),
            "w": rng.standard_normal((B, S, N, D), np.float32)}


def _masked_batches(rows, steps):
    """A loss mask keeping every token of the first half of the positions
    and every third of the second (a different count on each seq shard),
    and none of the second half in micro-batch 3 (gas 2)."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(steps * 2):
        mask = np.ones((rows, SEQ), np.float32)
        mask[:, SEQ // 2:] = np.arange(SEQ // 2, SEQ) % 3 == 0
        if i == 3:
            mask[:, SEQ // 2:] = 0.0
        out.append({"tokens": rng.integers(0, 512, (rows, SEQ),
                                           dtype=np.int32),
                    "loss_mask": mask})
    return out


def _rows(world, mesh):
    return world // mesh.get("seq", 1)


def _case_config(name):
    world, mesh, zero, *_, extra = CASES[name]
    return dict(_engine_config(zero), mesh=mesh, **extra)


# --------------------------------------------------------------------------- #
# JAX
# --------------------------------------------------------------------------- #

def _jax_attention(sp, fn, causal):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.sequence import ring as JR
    from deepspeed_tpu.sequence import ulysses as JU

    x = _att_inputs(sp)
    mm = _jax_mesh({"seq": sp}, sp)
    try:
        attn = {"ulysses": JU.ulysses_attention,
                "ulysses_shard_map": JU.ulysses_attention_shard_map,
                "ring": JR.ring_attention}[fn]()

        def loss(q, k, v):
            o = attn(q, k, v, causal=causal)
            return jnp.sum(o * x["w"]), o

        with mm.mesh:
            (_, o), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(
                    *(jnp.asarray(x[n]) for n in "qkv"))
        return {"o": np.asarray(o),
                **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}
    finally:
        JM.reset_mesh()


def _jax_engine(name):
    import deepspeed_tpu as dst

    world, mesh, _, model, _, attention, _ = CASES[name]
    mm = _jax_mesh(mesh, world)
    engine, *_ = dst.initialize(
        model=dst.causal_lm_spec(model, dtype="float32",
                                 attention=attention),
        config=_case_config(name), mesh_manager=mm)
    return engine, mm


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks started first (their attention cases need
    nothing of JAX's), JAX's initial master pickled for the ranks' engines
    (the same in every case of a model: the seed's), then JAX's attention
    cases and engines → (JAX runs, {world: rank results}, tmp dir)."""
    import jax

    from deepspeed_tpu.comm import comm as JC
    from deepspeed_tpu.comm import mesh as JM

    if not JC.is_initialized():     # else the engine builds a mesh of all 8
        JC.init_distributed(verbose=False)
    tmp = tmp_path_factory.mktemp("seq")
    collect = {world: _spawn_start(_world_rank, world,
                                   tmp_path_factory.mktemp(f"seq{world}"),
                                   str(tmp))
               for world in WORLDS}
    out = {"engine": {}, "att": {}}
    masters = {}
    for name, (world, mesh, _, model, *_) in CASES.items():
        engine, mm = _jax_engine(name)
        m0 = jax.tree.map(np.asarray, engine.state["master"])
        if model not in masters:
            masters[model] = m0
            path = tmp / f"master0_{model}.pkl"
            part = path.with_suffix(".part")
            part.write_bytes(pickle.dumps(m0))
            part.rename(path)
        data = iter(_masked_batches(_rows(world, mesh), STEPS))
        losses, norms = [], []
        for _ in range(STEPS):
            losses.append(float(engine.train_batch(data)))
            norms.append(engine.get_global_grad_norm())
        out["engine"][name] = {
            "master0_same": all(np.array_equal(a, b) for (_, a), (_, b) in
                                zip(_leaves(masters[model]), _leaves(m0))),
            "losses": losses, "norms": norms, "wire": engine._wire_format(),
            "train_batch_size": engine.train_batch_size(),
            "dp_world_size": engine.dp_world_size,
            "sp_plan": (None if engine.sp_plan is None else
                        (engine.sp_plan.enabled, engine.sp_plan.mechanism,
                         engine.sp_plan.loss_tiles)),
            "master": jax.tree.map(np.asarray, engine.state["master"])}
        del engine, mm
        JM.reset_mesh()
    for case in ATT_CASES:
        out["att"][case] = _jax_attention(*case)
    return out, {world: c() for world, c in collect.items()}, tmp


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #

def _attention_rank(rank, sp, fn, causal):
    """This rank's positions of the attention's output and of the q, k, v
    gradients of Σ o·w, and the seq group's traffic."""
    import torch

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.sequence import ring as R
    from deepspeed_tpu_torch.sequence import ulysses as U

    M.initialize_mesh(M.MeshConfig(seq=sp))
    x = _att_inputs(sp)
    n = x["q"].shape[1] // sp
    mine = {k: torch.from_numpy(v[:, rank * n:(rank + 1) * n].copy())
            for k, v in x.items()}
    q, k, v = (mine[n_].requires_grad_(True) for n_ in "qkv")
    attn = {"ulysses": U.ulysses_attention,
            "ulysses_shard_map": U.ulysses_attention_shard_map,
            "ring": R.ring_attention}[fn]()
    dtt.comm.reset_traffic()
    o = attn(q, k, v, causal=causal)
    (o * mine["w"]).sum().backward()
    out = {"o": o.detach().numpy(), "dq": q.grad.numpy(),
           "dk": k.grad.numpy(), "dv": v.grad.numpy(),
           "traffic": {k_: list(v_) for k_, v_ in dtt.comm.traffic.items()}}
    dtt.comm.reset_traffic()
    return out


def _engine_rank(rank, world, master0, name, ckpt_dir):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    _, mesh, zero, model, attention, *_ = CASES[name]
    spec = dtt.causal_lm_spec(model, dtype="float32", remat="full",
                              attention=attention)
    engine, *_ = dtt.initialize(model=spec, config=_case_config(name),
                                device="cpu")
    load_master(engine, master0)
    data = iter(_masked_batches(_rows(world, mesh), STEPS))
    dtt.comm.reset_traffic()
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(float(engine.train_batch(data)))
        norms.append(engine.get_global_grad_norm())
    traffic = {k: list(v) for k, v in dtt.comm.traffic.items()}
    out = {"type": type(engine).__name__, "losses": losses, "norms": norms,
           "master": gather_master(engine), "wire": engine._wire_format(),
           "train_batch_size": engine.train_batch_size(),
           "dp_world_size": engine.dp_world_size,
           "model_name": engine.model_spec.name,
           "attention": engine.model_spec.attention,
           "sp_plan": (None if engine.sp_plan is None else
                       (engine.sp_plan.enabled, engine.sp_plan.mechanism,
                        engine.sp_plan.loss_tiles)),
           "counts": (dict(engine._zero3.counts)
                      if hasattr(engine, "_zero3") else None),
           "traffic": traffic}
    if ckpt_dir is not None:
        engine.save_checkpoint(ckpt_dir, tag="seq")
        out["ckpt_moments"] = {
            f"{m}{k}": v for m in engine._opt_names()
            for k, v in _leaves(engine.full_tree(engine.state["opt"][m]))}
    engine.close()
    return out


def _refused_rank(name):
    """The error ``initialize`` raises for a combination left out."""
    import deepspeed_tpu_torch as dtt

    _, mesh, extra, model, _ = REFUSED[name]
    try:
        dtt.initialize(model=dtt.causal_lm_spec(model, dtype="float32",
                                                attention="ulysses"),
                       config=dict(_engine_config({"stage": 1}), mesh=mesh,
                                   **extra), device="cpu")
    except NotImplementedError as e:
        return str(e)
    return None


def _world_rank(rank, world, tmp):
    """Every case of one world, in one spawn: the attention cases first
    (no JAX input), the combinations left out, then the engines from
    JAX's initial masters."""
    import torch

    torch.set_num_threads(1)
    out = {"att": {case: _attention_rank(rank, *case)
                   for case in ATT_CASES if case[0] == world},
           "refused": {name: _refused_rank(name)
                       for name, case in REFUSED.items()
                       if case[0] == world}}
    masters = {}
    out["engine"] = {}
    for name, case in CASES.items():
        if case[0] != world:
            continue
        path = os.path.join(tmp, f"master0_{case[3]}.pkl")
        deadline = time.monotonic() + 90
        while not os.path.exists(path):
            assert time.monotonic() < deadline, "no JAX master in 90 s"
            time.sleep(0.05)
        if path not in masters:
            masters[path] = pickle.loads(open(path, "rb").read())
        ckpt = (os.path.join(tmp, f"ckpt{world}") if CKPT[world] == name
                else None)
        out["engine"][name] = _engine_rank(rank, world, masters[path], name,
                                           ckpt)
    return out


# --------------------------------------------------------------------------- #
# the checks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("sp,fn,causal", ATT_CASES)
def test_attention_across_seq_ranks_matches_jax(sp, fn, causal, runs):
    jruns, port, _ = runs
    want = jruns["att"][(sp, fn, causal)]
    ranks = [r["att"][(sp, fn, causal)] for r in port[sp]]
    for key in ("o", "dq", "dk", "dv"):
        got = np.concatenate([r[key] for r in ranks], axis=1)
        np.testing.assert_allclose(got, want[key], atol=ATOL, rtol=0,
                                   err_msg=f"{fn} {key}")
    # each exchange on the attentions' own seq group: Ulysses' 4
    # all-to-alls forward and 4 backward, the ring's K/V hops (sp - 1
    # each way, forward and backward)
    t = ranks[0]["traffic"]
    if fn == "ring":
        assert t == {"seq/permute": [4 * (sp - 1), t["seq/permute"][1],
                                     t["seq/permute"][2]]}
    else:
        assert list(t) == ["seq/all_to_all"] and t["seq/all_to_all"][0] == 8


@pytest.mark.parametrize("name", list(CASES))
def test_engine_seq_axis_matches_jax_engine(name, runs):
    jruns, port, _ = runs
    world, mesh, zero, *_ = CASES[name]
    want = jruns["engine"][name]
    assert want["master0_same"]
    tol = TOL["exact"]
    ranks = [r["engine"][name] for r in port[world]]
    for r, got in enumerate(ranks):
        assert got["type"] == ("Zero3Engine" if zero["stage"] == 3
                               else "DataParallelEngine")
        assert got["wire"] == want["wire"] == "exact"
        # the batch triad over data x zshard x expert, as JAX's
        assert (got["train_batch_size"], got["dp_world_size"]) == (
            want["train_batch_size"], want["dp_world_size"])
        assert got["sp_plan"] == want["sp_plan"]
        assert got["losses"] == ranks[0]["losses"], (name, r)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=tol["loss"], atol=0, err_msg=name)
        np.testing.assert_allclose(got["norms"], want["norms"], atol=0,
                                   rtol=tol["loss"], err_msg=name)
        mine, theirs = dict(_leaves(got["master"])), dict(
            _leaves(want["master"]))
        assert sorted(mine) == sorted(theirs)
        diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                               for k in theirs])
        assert diff.max() <= tol["master"], (name, r, diff.max())
        assert diff.mean() <= tol["master_mean"], (name, r, diff.mean())
        # attention traffic on the attentions' own seq group only
        seq = {k for k in got["traffic"] if k.startswith("seq/")}
        assert seq <= {"seq/all_to_all", "seq/permute"}, sorted(seq)
    if zero["stage"] == 3:
        gas = _engine_config({})["gradient_accumulation_steps"]
        assert ranks[0]["counts"] == {"gather_fwd": 2 * gas,
                                      "gather_bwd": gas, "reduce": 2 * gas}


@pytest.mark.parametrize("name", list(REFUSED))
def test_seq_combinations_left_out_raise(name, runs):
    _, port, _ = runs
    world, *_, what = REFUSED[name]
    for r in port[world]:
        msg = r["refused"][name]
        assert msg is not None, name
        assert "later slice" in msg and "queue A.4" in msg, msg
        assert what in msg, msg


@pytest.mark.parametrize("name,ulysses", [("s2_autosp", "ulysses"),
                                          ("s2_autosp_flash",
                                           "ulysses_flash")])
def test_autosp_engine_rewrites_the_spec(name, ulysses, runs):
    """``{"sequence_parallel": {"auto": true}}`` at ``{seq: 2}``: the plan
    JAX's engine makes, the spec renamed and rebuilt with the plan's
    attention (Ulysses around the flash kernels for a flash spec), and its
    mechanism's exchanges on the seq group."""
    jruns, port, _ = runs
    got = port[2][0]["engine"][name]
    enabled, mechanism, _ = got["sp_plan"]
    assert enabled and got["model_name"].endswith(f"+autosp:{mechanism}")
    assert got["attention"] == (ulysses if mechanism == "ulysses"
                                else "ring")
    kind = "all_to_all" if mechanism == "ulysses" else "permute"
    assert got["traffic"][f"seq/{kind}"][0] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_seq_checkpoint_loads_into_one_process(world, runs, tmp_path):
    """The tag of a ``{seq: 2}`` (``{data: 2, seq: 2}``) engine is the tag
    of the same state at seq = 1: one process loads its master and both
    moments bit-equal."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.models.convert import gather_master

    _, port, tmp = runs
    name = CKPT[world]
    _, mesh, _, model, *_ = CASES[name]
    got = port[world][0]["engine"][name]
    M.reset_mesh()
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(model, dtype="float32", remat="full"),
        config=dict(_engine_config({"stage": 1}),
                    train_micro_batch_size_per_gpu=_rows(world, mesh)),
        device="cpu")
    engine.load_checkpoint(str(tmp / f"ckpt{world}"), tag="seq")
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


# --------------------------------------------------------------------------- #
# one process: chunked / FPDT attention, the tiled loss and compute
# --------------------------------------------------------------------------- #

def _one_inputs(B=2, S=32, N=4, K=2, D=8, seed=5):
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((B, S, N, D), np.float32),
            "k": rng.standard_normal((B, S, K, D), np.float32),
            "v": rng.standard_normal((B, S, K, D), np.float32),
            "w": rng.standard_normal((B, S, N, D), np.float32)}


def _port_grads(fn, x, names):
    import torch

    args = {n: torch.from_numpy(x[n]).requires_grad_(True) for n in names}
    o = fn(*args.values())
    loss = (o * torch.from_numpy(x["w"])).sum() if "w" in x else o
    loss.backward()
    return {"o": o.detach().numpy(),
            **{f"d{n}": args[n].grad.numpy() for n in names}}


def _jax_grads(fn, x, names):
    import jax
    import jax.numpy as jnp

    def loss(*args):
        o = fn(*args)
        return (jnp.sum(o * x["w"]) if "w" in x else o), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True))(
            *(jnp.asarray(x[n]) for n in names))
    return {"o": np.asarray(o),
            **{f"d{n}": np.asarray(g) for n, g in zip(names, grads)}}


def _assert_same(got, want):
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("kind,causal", [("chunked", True),
                                         ("chunked", False),
                                         ("fpdt", True), ("fpdt", False)])
def test_chunked_and_fpdt_attention_match_jax(kind, causal):
    from deepspeed_tpu.sequence import tiled as JT

    from deepspeed_tpu_torch.sequence import tiled as PT

    x = _one_inputs()
    kw = {"chunked": dict(num_chunks=4),
          "fpdt": dict(num_chunks=4, kv_chunks=2)}[kind]
    fn = {"chunked": "chunked_attention", "fpdt": "fpdt_attention"}[kind]
    got = _port_grads(lambda q, k, v: getattr(PT, fn)(
        q, k, v, causal=causal, **kw), x, "qkv")
    want = _jax_grads(lambda q, k, v: getattr(JT, fn)(
        q, k, v, causal=causal, **kw), x, "qkv")
    _assert_same(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_tiled_lm_loss_matches_jax(masked):
    """31 targets over 4 tiles: the last tile padded, as JAX pads it."""
    import jax.numpy as jnp
    import torch
    from deepspeed_tpu.sequence import tiled as JT

    from deepspeed_tpu_torch.sequence import tiled as PT

    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 32, 16), np.float32)
    w = rng.standard_normal((16, 64), np.float32) * 0.3
    tok = rng.integers(0, 64, (2, 32)).astype(np.int32)
    mask = (rng.random((2, 32)) < 0.6).astype(np.float32) if masked else None
    x = {"h": h, "head": w}
    got = _port_grads(lambda a, b: PT.tiled_lm_loss(
        a, b, torch.from_numpy(tok),
        None if mask is None else torch.from_numpy(mask), num_tiles=4),
        x, ("h", "head"))
    want = _jax_grads(lambda a, b: JT.tiled_lm_loss(
        a, b, jnp.asarray(tok), None if mask is None else jnp.asarray(mask),
        num_tiles=4), x, ("h", "head"))
    _assert_same(got, want)


def test_sequence_tiled_compute_matches_jax():
    import jax
    import torch
    from deepspeed_tpu.sequence import tiled as JT

    from deepspeed_tpu_torch.sequence import tiled as PT

    rng = np.random.default_rng(4)
    x = {"x": rng.standard_normal((2, 32, 16), np.float32),
         "m": rng.standard_normal((16, 16), np.float32) * 0.3,
         "w": rng.standard_normal((2, 32, 16), np.float32)}
    got = _port_grads(lambda a, m: PT.sequence_tiled_compute(
        lambda t: torch.tanh(t @ m), a, num_tiles=4), x, ("x", "m"))
    want = _jax_grads(lambda a, m: JT.sequence_tiled_compute(
        lambda t: jax.numpy.tanh(t @ m), a, num_tiles=4), x, ("x", "m"))
    _assert_same(got, want)


# --------------------------------------------------------------------------- #
# AutoSP planning (tests/unit/test_auto_sp_ep.py's cases)
# --------------------------------------------------------------------------- #

class _FakeHFConfig:
    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def _plan_cases():
    text = dict(model_type="llama", num_attention_heads=8,
                num_key_value_heads=8, hidden_size=512,
                max_position_embeddings=4096)
    return {
        "disabled": dict(num_heads=8, sp_size=1),
        "ulysses_divisible": dict(num_heads=8, sp_size=4),
        "ring_indivisible": dict(num_heads=6, sp_size=4),
        "loss_tiling": dict(num_heads=8, seq_len=32768, sp_size=2),
        "mha_ulysses": dict(info=("site", dict(num_heads=16, kv_heads=16,
                                               head_dim=128, seq_len=8192)),
                            sp_size=4),
        "mqa_ring": dict(info=("site", dict(num_heads=32, kv_heads=1,
                                            head_dim=128, seq_len=8192)),
                         sp_size=8),
        "nothing_feasible": dict(info=("site", dict(
            num_heads=6, kv_heads=6, head_dim=64, seq_len=102)), sp_size=4),
        "multimodal": dict(info=("hf", dict(model_type="llava",
                                            text_config=("hf", text))),
                           sp_size=2),
        "hf_qwen2": dict(info=("hf", dict(
            model_type="qwen2", num_attention_heads=16,
            num_key_value_heads=4, hidden_size=1024,
            max_position_embeddings=8192)), sp_size=4),
    }


def _build(mod, spec):
    """A plan case's arguments in one package's types."""
    if isinstance(spec, tuple):
        kind, kw = spec
        kw = {k: _build(mod, v) for k, v in kw.items()}
        return mod.SPSiteInfo(**kw) if kind == "site" else _FakeHFConfig(**kw)
    return spec


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_plan_sp_matches_jax(case):
    from deepspeed_tpu.sequence import auto_sp as JA

    from deepspeed_tpu_torch.sequence import auto_sp as PA

    plans = []
    for mod in (JA, PA):
        kw = {k: _build(mod, v) for k, v in _plan_cases()[case].items()}
        if isinstance(kw.get("info"), _FakeHFConfig):
            info = mod.detect_sp_info(kw["info"])
            kw["info"] = info
            plans.append(dataclasses.astuple(info))
        plans.append(dataclasses.astuple(mod.plan_sp(**kw)))
    half = len(plans) // 2
    assert plans[:half] == plans[half:]


@pytest.mark.parametrize("cfg", [
    dict(model_type="qwen2", num_attention_heads=16, num_key_value_heads=4,
         hidden_size=1024, max_position_embeddings=8192),
    dict(foo=1)])
def test_detect_sp_info_matches_jax(cfg):
    from deepspeed_tpu.sequence import auto_sp as JA

    from deepspeed_tpu_torch.sequence import auto_sp as PA

    out = []
    for mod in (JA, PA):
        try:
            out.append(dataclasses.astuple(
                mod.detect_sp_info(_FakeHFConfig(**cfg))))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0] == out[1]


def test_auto_sp_of_a_zoo_spec_matches_jax():
    """``auto_sp`` of ``tiny_llama`` at sp 2 and 4 and without a seq axis:
    JAX's plan, the spec rebuilt with the plan's attention and tiles."""
    import deepspeed_tpu as dst
    from deepspeed_tpu.sequence import auto_sp as JA

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.sequence import auto_sp as PA

    for sp, seq_len in ((1, None), (2, None), (4, 32768)):
        jspec, jplan = JA.auto_sp(dst.causal_lm_spec("tiny_llama"),
                                  seq_len=seq_len, sp_size=sp)
        pspec, pplan = PA.auto_sp(dtt.causal_lm_spec("tiny_llama"),
                                  seq_len=seq_len, sp_size=sp)
        assert dataclasses.astuple(pplan) == dataclasses.astuple(jplan)
        assert pspec.name == jspec.name


@pytest.mark.parametrize("mesh", [{"seq": 2}, {"data": 2, "seq": 2},
                                  {"data": 4}])
def test_batch_spec_matches_jax(mesh):
    """Rows over ``(data, zshard, expert)``, positions over ``seq`` where
    that axis is above 1 (JAX ``partitioning.py:164 batch_spec``)."""
    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.parallel.partitioning import ShardingPolicy as JS

    from deepspeed_tpu_torch.comm.mesh import MeshConfig
    from deepspeed_tpu_torch.parallel.partitioning import ShardingPolicy

    world = int(np.prod(list(mesh.values())))
    mm = _jax_mesh(mesh, world)
    try:
        want = tuple(JS(mm.mesh, 1).batch_spec())
    finally:
        JM.reset_mesh()
    sizes = MeshConfig(**mesh).resolve(world)
    assert ShardingPolicy(sizes, 1).batch_spec() == want
