"""The dense GShard dispatch and noisy gating of the PyTorch port against the
JAX package.

* ``topk_gating`` (k 1-3, tight capacity so choices drop, sigmoid scores,
  a selection bias, node-limited groups), ``top1_gating`` and
  ``top2_gating``: the same numpy logits through JAX's gate and the port's
  — combine within 1e-6, dispatch, counts and capacity equal, aux loss
  and probabilities within 1e-6.
* ``moe_ffn(dispatch="dense")`` on one process, forward and the gradients
  of x, ``gate_w`` and every expert weight against ``jax.grad`` of JAX's
  (gelu and swiglu, choices dropped), within 2e-5.
* Noisy gating: JAX draws ``jax.random.normal(key, logits.shape)``; the
  port draws from a ``torch.Generator`` (other numbers for one seed), so
  JAX's draw is put in place of ``gating.gate_noise`` and the rest of the
  gate and layer is held against JAX's.
* World 2 (spawned gloo ranks, ``test_torch_zero._spawn``) against JAX at
  ``data = 2``: the dense layer over the sharded batch (JAX's gate is one
  GSPMD gate over the global batch: capacity from the global token count,
  locations after the earlier ranks' choices), with noise; and the
  ``tiny_moe`` engine with ``moe_dispatch="dense"`` at a capacity factor
  that drops choices, 3 steps of stage 2 from JAX's initial master, within
  ``TOL["exact"]``.

jax is imported inside the fixtures and tests, never at the top: a spawned
rank imports this module to find its function.
"""
import pickle

import numpy as np
import pytest
import torch

from test_torch_zero import TOL, _engine_config, _leaves, _spawn

GATE_TOL = dict(rtol=1e-6, atol=1e-6)
FFN_TOL = dict(rtol=2e-5, atol=2e-5)
GATE_CASES = {
    "k1": dict(k=1, capacity_factor=1.0, normalize=False),
    "k2_tight": dict(k=2, capacity_factor=1.0),
    "k3_tight": dict(k=3, capacity_factor=0.5),
    "sigmoid": dict(k=2, capacity_factor=1.0, score_func="sigmoid"),
    "select_bias": dict(k=2, capacity_factor=1.0, score_func="sigmoid",
                        bias=True),
    "groups": dict(k=2, capacity_factor=1.0, n_group=2, topk_group=1),
}
SEQ, STEPS, WORLD = 32, 3, 2
DENSE_SPEC = dict(moe_dispatch="dense", moe_capacity_factor=1.0)
NOISE_STD = 0.5


def _logits(seed=0, T=64, E=8):
    return np.random.default_rng(seed).standard_normal((T, E)).astype(
        np.float32)


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_topk_gating_matches_jax(case):
    import jax.numpy as jnp

    from deepspeed_tpu.moe import gating as JG

    from deepspeed_tpu_torch.moe import gating as PG

    kw = dict(GATE_CASES[case])
    logits = _logits()
    bias = (0.5 * np.random.default_rng(1).standard_normal(8)).astype(
        np.float32) if kw.pop("bias", False) else None
    want = JG.topk_gating(jnp.asarray(logits), select_bias=None
                          if bias is None else jnp.asarray(bias), **kw)
    got = PG.topk_gating(torch.from_numpy(logits), select_bias=None
                         if bias is None else torch.from_numpy(bias), **kw)
    assert got.combine.shape == want.combine.shape
    np.testing.assert_array_equal(got.dispatch.numpy(),
                                  np.asarray(want.dispatch))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    for name in ("combine", "aux_loss", "probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **GATE_TOL)
    kept = int(got.dispatch.sum())
    assert kept < 64 * kw["k"] or case == "k1"    # capacity dropped some


def test_top1_top2_gating_match_jax():
    import jax.numpy as jnp

    from deepspeed_tpu.moe import gating as JG

    from deepspeed_tpu_torch.moe import gating as PG

    logits = _logits(2)
    for jfn, pfn in ((JG.top1_gating, PG.top1_gating),
                     (JG.top2_gating, PG.top2_gating)):
        want = jfn(jnp.asarray(logits), capacity_factor=1.0)
        got = pfn(torch.from_numpy(logits), capacity_factor=1.0)
        np.testing.assert_allclose(got.combine.numpy(),
                                   np.asarray(want.combine), **GATE_TOL)
        np.testing.assert_array_equal(got.dispatch.numpy(),
                                      np.asarray(want.dispatch))


def _ffn_inputs(swiglu=False, B=2, S=16, H=16, F=32, E=4, seed=5):
    rng = np.random.default_rng(seed)
    p = {"x": rng.standard_normal((B, S, H)),
         "gate_w": 0.5 * rng.standard_normal((H, E)),
         "w_up": 0.1 * rng.standard_normal((E, H, F)),
         "w_down": 0.1 * rng.standard_normal((E, F, H))}
    if swiglu:
        p["w_gate"] = 0.1 * rng.standard_normal((E, H, F))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _experts(p):
    return {k: p[k] for k in ("w_up", "w_down", "w_gate") if k in p}


def _jax_dense(params, activation, key=None, world=1):
    """JAX's dense moe_ffn (jax.grad of Σ y² + world · aux) on a mesh of
    ``world`` CPU devices over ``data``; with ``key``, noisy gating."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.moe import layer as JL

    JM.reset_mesh()
    mm = JM.initialize_mesh(JM.MeshConfig(data=world),
                            devices=jax.devices()[:world])
    try:
        def loss(p):
            y, aux = JL.moe_ffn(p["x"], p["gate_w"], _experts(p),
                                activation=activation, k=2,
                                capacity_factor=1.0, dispatch="dense",
                                rng=key, noise_std=NOISE_STD if key is not
                                None else 0.0)
            return jnp.sum(y ** 2) + world * aux, (y, aux)

        jp = {k: jnp.asarray(v) for k, v in params.items()}
        with mm.mesh:
            (_, (y, aux)), g = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(jp)
        return {"y": np.asarray(y), "aux": float(aux),
                "grads": {k: np.asarray(v) for k, v in g.items()}}
    finally:
        JM.reset_mesh()


def _port_dense(params, activation, rows=None, noise=None):
    """The port's dense moe_ffn on ``rows`` of the batch (all of it by
    default): y, aux and the gradients of Σ y² + aux; ``noise`` (JAX's
    draw) in place of ``gate_noise``."""
    from deepspeed_tpu_torch.moe import gating as PG
    from deepspeed_tpu_torch.moe import layer as PL

    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    if rows is not None:
        x = tp["x"].detach()[rows].clone().requires_grad_(True)
        tp["x"] = x
    saved = PG.gate_noise
    if noise is not None:
        PG.gate_noise = lambda rng, shape: torch.from_numpy(noise.copy())
    try:
        y, aux = PL.moe_ffn(tp["x"], tp["gate_w"], _experts(tp),
                            activation=activation, k=2, capacity_factor=1.0,
                            dispatch="dense",
                            rng=torch.Generator() if noise is not None
                            else None,
                            noise_std=NOISE_STD if noise is not None
                            else 0.0)
    finally:
        PG.gate_noise = saved
    ((y ** 2).sum() + aux).backward()
    return {"y": y.detach().numpy(), "aux": float(aux.detach()),
            "grads": {k: v.grad.numpy() for k, v in tp.items()}}


def _jax_noise(shape):
    import jax

    return np.asarray(jax.random.normal(jax.random.PRNGKey(4), shape))


@pytest.mark.parametrize("activation", ["gelu", "swiglu", "noisy"])
def test_dense_moe_ffn_and_grads_match_jax(activation):
    import jax

    params = _ffn_inputs(swiglu=activation == "swiglu")
    act = "gelu" if activation == "noisy" else activation
    noisy = activation == "noisy"
    T, E = 32, 4
    want = _jax_dense(params, act, key=jax.random.PRNGKey(4) if noisy
                      else None)
    got = _port_dense(params, act, noise=_jax_noise((T, E)) if noisy
                      else None)
    np.testing.assert_allclose(got["y"], want["y"], **FFN_TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(got["grads"][k], want["grads"][k],
                                   err_msg=k, **FFN_TOL)
    if noisy:       # the noise moved some selection: the noiseless differs
        quiet = _port_dense(params, act)
        assert not np.allclose(quiet["y"], got["y"])


# --------------------------------------------------------------------------- #
# world 2
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def world2_runs(tmp_path_factory):
    """JAX at data = 2: the dense layer (plain and noisy) over the sharded
    batch and the dense tiny_moe engine; then the port's two ranks."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh
    from deepspeed_tpu.runtime.dataloader import synthetic_lm_data

    params = _ffn_inputs(B=4)
    noise = _jax_noise((64, 4))
    runs = {"params": params, "noise": noise,
            "layer": _jax_dense(params, "gelu", world=WORLD),
            "noisy": _jax_dense(params, "gelu", key=jax.random.PRNGKey(4),
                                world=WORLD)}
    spec = dst.causal_lm_spec("tiny_moe", dtype="float32", **DENSE_SPEC)
    mm = initialize_mesh(MeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    engine, *_ = dst.initialize(model=spec,
                                config=_engine_config({"stage": 2}),
                                mesh_manager=mm)
    JM.set_mesh(mm.mesh)
    runs["master0"] = jax.tree.map(np.asarray, engine.state["master"])
    data = synthetic_lm_data(WORLD, SEQ, 512, seed=3)
    runs["losses"] = [float(engine.train_batch(data)) for _ in range(STEPS)]
    runs["master"] = jax.tree.map(np.asarray, engine.state["master"])
    JM.reset_mesh()
    tmp = tmp_path_factory.mktemp("dense")
    path = tmp / "runs.pkl"
    path.write_bytes(pickle.dumps(runs))
    return runs, _spawn(_dense_rank, WORLD, tmp, str(path))


def _dense_rank(rank, world, runs_path):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master
    from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

    runs = pickle.loads(open(runs_path, "rb").read())
    params = runs["params"]
    n = params["x"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    out = {"layer": _port_dense(params, "gelu", rows),
           "noisy": _port_dense(params, "gelu", rows, runs["noise"])}
    spec = dtt.causal_lm_spec("tiny_moe", dtype="float32", **DENSE_SPEC)
    engine, *_ = dtt.initialize(model=spec,
                                config=_engine_config({"stage": 2}),
                                device="cpu")
    load_master(engine, runs["master0"])
    data = synthetic_lm_data(world, SEQ, 512, seed=3)
    out["losses"] = [float(engine.train_batch(data)) for _ in range(STEPS)]
    out["master"] = gather_master(engine)
    engine.close()
    return out


@pytest.mark.parametrize("case", ["layer", "noisy"])
def test_dense_layer_world2_matches_jax_global_gate(case, world2_runs):
    runs, ranks = world2_runs
    want = runs[case]
    got = [r[case] for r in ranks]
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]),
                               want["y"], **FFN_TOL)
    np.testing.assert_allclose([g["aux"] for g in got],
                               [want["aux"]] * WORLD, rtol=1e-6)
    np.testing.assert_allclose(np.concatenate([g["grads"]["x"] for g in got]),
                               want["grads"]["x"], **FFN_TOL)
    for k in ("gate_w", "w_up", "w_down"):
        np.testing.assert_allclose(sum(g["grads"][k] for g in got),
                                   want["grads"][k], err_msg=k, **FFN_TOL)


def test_dense_engine_world2_with_drops_matches_jax(world2_runs):
    """tiny_moe, the dense dispatch at capacity factor 1.0 (64 tokens a
    micro-batch over the two ranks: C = 32 a expert, so choices drop),
    stage 2 exact at world 2 against JAX at data = 2."""
    from deepspeed_tpu_torch.moe import gating as PG

    runs, ranks = world2_runs
    assert PG.gate_capacity(2 * SEQ, 4, 2, 1.0) == 32
    tol = TOL["exact"]
    assert ranks[1]["losses"] == ranks[0]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], runs["losses"],
                               rtol=tol["loss"], atol=0)
    mine, theirs = dict(_leaves(ranks[0]["master"])), dict(
        _leaves(runs["master"]))
    diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                           for k in theirs])
    assert diff.max() <= tol["master"], diff.max()
    assert diff.mean() <= tol["master_mean"], diff.mean()
