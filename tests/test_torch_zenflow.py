"""ZenFlow's importance-split update in the PyTorch port against JAX's.

Counterpart of ``tests/unit/test_domino_zenflow.py::TestZenFlow``.

* The hot mask: the port's ``hot_mask`` (``torch.topk``'s k-th largest
  |g|, ``>=``) equal to JAX's ``_hot_mask`` (``lax.top_k``) on leaves
  with ties at the threshold, so both select more than k, an empty leaf
  and a leaf smaller than 1 / ``topk_ratio``.
* The optimizer over a flat buffer of two leaves (with pads between them,
  as the engines lay them out) against JAX's over the same two leaves,
  through warm-up rounds and two boundaries: each step's hot masks equal,
  the master and ``cold_acc`` within 1e-6; the pads never move.
* JAX's ``TestZenFlow`` cases on the port: convergence, warm-up equal to
  plain Adam, the cold accumulator drained at each boundary, the engine
  wiring.
* The engine: tiny, fp32, ZenFlow at stage 1 against the JAX engine over 6
  steps (losses, grad norms, master and ``cold_acc`` within
  ``test_torch_train.TOL["float32"]``), and at world 2 on gloo CPU ranks
  against the JAX engine at ``data = 2``: a sharded leaf's threshold is
  taken over the whole leaf (its rows gathered).
"""
import itertools
import pickle

import numpy as np
import pytest
import torch

from test_torch_zero import _leaves, _spawn

SEQ, ROWS, STEPS = 32, 16, 6
ZF = {"enabled": True, "topk_ratio": 0.05, "update_interval": 2,
      "full_warm_up_rounds": 1}


def _leaf(rng, n, ties):
    """A gradient leaf; ``ties`` rounds it to a coarse grid so many
    elements share the threshold's value."""
    g = rng.standard_normal(n).astype(np.float32)
    return np.round(g * 4) / 4 if ties else g


@pytest.mark.parametrize("n,ratio,ties", [
    (1000, 0.01, True), (1000, 0.05, False), (4096, 0.1, True),
    (7, 0.05, False), (0, 0.1, False), (33, 1.0, True)])
def test_hot_mask_matches_jax(n, ratio, ties):
    import jax.numpy as jnp

    from deepspeed_tpu.ops.optimizer import FusedAdam as JAdam
    from deepspeed_tpu.runtime.zenflow import ZenFlowOptimizer as JZ

    from deepspeed_tpu_torch.ops.optimizer import FusedAdam
    from deepspeed_tpu_torch.runtime.zenflow import ZenFlowOptimizer

    g = _leaf(np.random.default_rng(n), n, ties)
    want = np.asarray(JZ(inner=JAdam(), topk_ratio=ratio)._hot_mask(
        jnp.asarray(g)))
    got = ZenFlowOptimizer(inner=FusedAdam(), topk_ratio=ratio).hot_mask(
        torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got.astype(np.float32), want)
    if ties and 0 < n * ratio < n:
        assert got.sum() > max(1, int(n * ratio))     # ties select more


def test_optimizer_matches_jax_through_warmup_and_boundaries():
    import jax.numpy as jnp

    from deepspeed_tpu.ops.optimizer import FusedAdam as JAdam
    from deepspeed_tpu.runtime.zenflow import ZenFlowOptimizer as JZ

    from deepspeed_tpu_torch.ops.optimizer import FusedAdam
    from deepspeed_tpu_torch.runtime.zenflow import Segment, ZenFlowOptimizer

    rng = np.random.default_rng(0)
    shapes = {"a": (48, 20), "b": (300,)}
    offs = {"a": 0, "b": 1024}                 # pads between and after
    n_flat = 1024 + 320
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    kw = dict(topk_ratio=0.02, update_interval=3, full_warm_up_rounds=2)
    jz = JZ(inner=JAdam(lr=1e-2, weight_decay=0.01), **kw)
    pz = ZenFlowOptimizer(inner=FusedAdam(lr=1e-2, weight_decay=0.01), **kw)
    pz.bind([Segment(offs[k], int(np.prod(s))) for k, s in shapes.items()])
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jz.init(jp)
    flat = torch.zeros(n_flat)
    for k, v in p0.items():
        flat[offs[k]:offs[k] + v.size] = torch.from_numpy(v.ravel())
    ps = pz.init(flat)
    for step in range(1, 8):
        g = {k: _leaf(rng, int(np.prod(s)), True).reshape(s)
             for k, s in shapes.items()}
        masks = {k: np.asarray(jz._hot_mask(jnp.asarray(v)))
                 for k, v in g.items()}
        jp, js = jz.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        gf = torch.zeros(n_flat)
        for k, v in g.items():
            gf[offs[k]:offs[k] + v.size] = torch.from_numpy(v.ravel())
        for k, v in g.items():
            m = pz.hot_mask(gf[offs[k]:offs[k] + v.size]).float().numpy()
            np.testing.assert_array_equal(m, masks[k].ravel())
        pz.update(gf, ps, flat)
        assert ps["step"] == step
        for k, s in shapes.items():
            sl = slice(offs[k], offs[k] + int(np.prod(s)))
            np.testing.assert_allclose(flat[sl].numpy().reshape(s),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6)
            np.testing.assert_allclose(
                ps["cold_acc"][sl].numpy().reshape(s),
                np.asarray(js["cold_acc"][k]), rtol=0, atol=1e-6)
        pads = torch.cat([flat[960:1024], flat[1324:]])
        assert not pads.any() and not ps["cold_acc"][960:1024].any()
        cold = float(ps["cold_acc"].abs().max())
        assert (cold == 0.0) == (step <= 2 or step % 3 == 0), step


def _adam_flat(n, lr):
    from deepspeed_tpu_torch.ops.optimizer import FusedAdam
    from deepspeed_tpu_torch.runtime.zenflow import Segment, ZenFlowOptimizer

    def zf(**kw):
        z = ZenFlowOptimizer(inner=FusedAdam(lr=lr), **kw)
        z.bind([Segment(0, n)])
        return z
    return zf


def test_converges():
    """JAX's ``test_converges``: a quadratic's loss falls below 5 % of its
    start at topk 0.1, interval 4."""
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(128)
                              .astype(np.float32))
    opt = _adam_flat(128, 0.05)(topk_ratio=0.1, update_interval=4)
    p = torch.zeros(128)
    st = opt.init(p)
    for _ in range(80):
        opt.update(2 * (p - target), st, p)
    assert float(((p - target) ** 2).sum() / (target ** 2).sum()) < 0.05


def test_warmup_matches_plain_adam():
    from deepspeed_tpu_torch.ops.optimizer import FusedAdam

    rng = np.random.default_rng(1)
    p0 = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    zf = _adam_flat(32, 1e-2)(topk_ratio=0.1, update_interval=4,
                              full_warm_up_rounds=10)
    ad = FusedAdam(lr=1e-2)
    p1, p2 = p0.clone(), p0.clone()
    zf.update(g.clone(), zf.init(p1), p1)
    ad.update(g.clone(), ad.init(p2), p2)
    assert torch.equal(p1, p2)


def test_cold_accumulator_drains_at_boundary():
    zf = _adam_flat(64, 1e-3)(topk_ratio=0.05, update_interval=3)
    p = torch.zeros(64)
    st = zf.init(p)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(64)
                         .astype(np.float32))
    for i in range(1, 7):
        zf.update(g.clone(), st, p)
        acc = float(st["cold_acc"].abs().max())
        assert (acc == 0.0) == (i % 3 == 0), i


def _config(micro, zenflow=ZF):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "adam", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 1, "zenflow": zenflow},
            "steps_per_print": 10 ** 9}


def _tokens(rows):
    return np.random.default_rng(7).integers(0, 512, (rows, SEQ)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_zenflow():
    """The JAX engine with ZenFlow at 8 devices (micro 2) and at data = 2
    (micro 1): initial master, losses, grad norms, master, cold_acc."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm import mesh as mesh_mod

    out = {}
    for name, data, micro in (("dp8", 8, 2), ("dp2", 2, 1)):
        mesh_mod.reset_mesh()
        spec = dst.causal_lm_spec("tiny", dtype="float32", max_seq_len=SEQ)
        mm = mesh_mod.initialize_mesh(mesh_mod.MeshConfig(data=data),
                                      devices=jax.devices()[:data])
        engine, *_ = dst.initialize(model=spec, config=_config(micro),
                                    mesh_manager=mm)
        master0 = jax.tree.map(np.asarray, engine.state["master"])
        toks = _tokens(data * micro)
        it = iter(lambda: {"tokens": toks}, None)
        losses, norms = [], []
        for _ in range(STEPS):
            losses.append(float(engine.train_batch(it)))
            norms.append(float(engine.get_global_grad_norm()))
        out[name] = {"master0": master0, "losses": losses, "norms": norms,
                     "master": jax.tree.map(np.asarray,
                                            engine.state["master"]),
                     "cold_acc": jax.tree.map(
                         np.asarray, engine.state["opt"]["cold_acc"])}
    mesh_mod.reset_mesh()
    return out


def _port_run(rows, master0, steps=STEPS):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master
    from deepspeed_tpu_torch.runtime.zenflow import ZenFlowOptimizer

    spec = dtt.causal_lm_spec("tiny", dtype="float32", max_seq_len=SEQ)
    engine, *_ = dtt.initialize(model=spec, config=_config(rows),
                                device="cpu")
    assert isinstance(engine.optimizer, ZenFlowOptimizer)
    load_master(engine, master0)
    world = engine.dp_world_size
    data = itertools.repeat({"tokens": _tokens(rows * world)})
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(engine.train_batch(data)))
        norms.append(engine.get_global_grad_norm())
    if world > 1:
        cold = engine.full_tree(engine.state["opt"]["cold_acc"])
    else:
        cold = engine._views(engine.state["opt"]["cold_acc"])
    return {"losses": losses, "norms": norms,
            "master": gather_master(engine), "cold_acc": _numpy(cold)}


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in tree.items()}


def _check(got, want):
    from test_torch_train import TOL

    tol = TOL["float32"]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=tol["loss"], atol=0)
    assert got["losses"][-1] < got["losses"][0]
    np.testing.assert_allclose(got["norms"], want["norms"],
                               rtol=10 * tol["loss"])
    for part in ("master", "cold_acc"):
        mine = dict(_leaves(got[part]))
        for key, w in _leaves(want[part]):
            np.testing.assert_allclose(mine[key], w, rtol=0,
                                       atol=tol["master"],
                                       err_msg=f"{part}{key}")
            assert np.abs(mine[key] - w).mean() <= tol["master_mean"], key


def test_engine_matches_jax(jax_zenflow):
    want = jax_zenflow["dp8"]
    _check(_port_run(ROWS, want["master0"]), want)


def _world2_rank(rank, world, path):
    torch.set_num_threads(1)
    want = pickle.loads(open(path, "rb").read())
    return _port_run(1, want["master0"])


def test_engine_world2_matches_jax(jax_zenflow, tmp_path):
    """At world 2 the sharded leaves' thresholds come from the gathered
    whole leaf, as JAX's GSPMD ``top_k`` over the leaf."""
    path = tmp_path / "want.pkl"
    path.write_bytes(pickle.dumps(jax_zenflow["dp2"]))
    ranks = _spawn(_world2_rank, 2, tmp_path, str(path))
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for r in ranks:
        _check(r, jax_zenflow["dp2"])
