"""The MoE slice of the PyTorch port against the JAX package.

* ``topk_gating_indices`` (softmax and sigmoid, ``route_norm`` on and off,
  ``select_bias``, ``n_group`` 2 / ``topk_group`` 1) and ``expert_sort`` on
  the same numpy inputs: exact selections, fp32 weights within 1e-6.
* ``moe_ffn`` forward and gradients (x, ``gate_w``, every expert and shared
  weight) against ``jax.grad`` of the JAX ``moe_ffn``: gelu, swiglu, a
  shared expert with its sigmoid gate, ``route_scale``, a gate bias; fp32
  within 2e-5 (the same products summed in other orders).
* A ``tiny_moe`` engine (fp32, flash attention, remat full) started from
  the JAX engine's master via ``load_master``: losses (the aux term
  included) and grad norms over three steps match the JAX engine's.
* MoE leaves carry across (``load_master``, ``params_from_numpy``), the
  port's ``init_params`` has JAX's MoE keys and shapes, and FastGen takes
  an MoE model (served against JAX in ``tests/test_torch_moe_serving.py``).

The JAX ``moe_ffn`` lowers according to the process's global mesh, which a
JAX engine run earlier in the same worker leaves behind (an expert axis
would take the expert-parallel all-to-all). The ``moe_ffn`` comparisons
therefore install a one-device mesh first, so JAX runs its local program
— the port's path; the engine comparison keeps the engine's 8-way data
mesh, where each micro-batch of 8 sequences divides the data axis and JAX
sorts per shard. The math is the same either way.
"""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu as dst
import deepspeed_tpu_torch as dtt
from deepspeed_tpu.comm import mesh as JM
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.moe import gating as JG
from deepspeed_tpu.moe import layer as JL
from deepspeed_tpu.runtime.dataloader import synthetic_lm_data as jax_data
from deepspeed_tpu_torch.inference.fastgen import FastGenEngine
from deepspeed_tpu_torch.models import paged as PPG
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import load_master, params_from_numpy
from deepspeed_tpu_torch.moe import gating as PGt
from deepspeed_tpu_torch.moe import layer as PL
from deepspeed_tpu_torch.ops import grouped_gemm as GG
from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

GATE_TOL = dict(rtol=1e-6, atol=1e-6)
FFN_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def one_device_mesh():
    """A one-device JAX mesh for the test: the JAX ``moe_ffn`` then lowers
    its local program whatever an earlier test left behind."""
    axes = JM.DEFAULT_AXIS_ORDER
    JM.set_mesh(jax.make_mesh((1,) * len(axes), axes,
                              devices=jax.devices()[:1]))
    yield
    JM.reset_mesh()


GATE_CASES = {
    "softmax": dict(score_func="softmax", normalize=True),
    "softmax_no_norm": dict(score_func="softmax", normalize=False),
    "sigmoid": dict(score_func="sigmoid", normalize=True),
    "sigmoid_no_norm": dict(score_func="sigmoid", normalize=False),
    "select_bias": dict(score_func="sigmoid", normalize=True, bias=True),
    "group_limited": dict(score_func="softmax", normalize=True, n_group=2,
                          topk_group=1),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_topk_gating_indices_matches_jax(case):
    kw = dict(GATE_CASES[case])
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(8)).astype(np.float32) \
        if kw.pop("bias", False) else None
    want = JG.topk_gating_indices(
        jnp.asarray(logits), k=2,
        select_bias=None if bias is None else jnp.asarray(bias), **kw)
    got = PGt.topk_gating_indices(
        torch.from_numpy(logits), k=2,
        select_bias=None if bias is None else torch.from_numpy(bias), **kw)
    np.testing.assert_array_equal(got.experts.numpy(),
                                  np.asarray(want.experts))
    for name in ("weights", "probs", "aux_loss"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **GATE_TOL)
    if kw.get("n_group", 1) > 1:       # every choice inside the best group
        groups = got.experts.numpy() // 4
        assert (groups == groups[:, :1]).all()
    assert PGt.gate_capacity(64, 8, 2, 1.25) == JG.gate_capacity(64, 8, 2,
                                                                 1.25)


def test_gate_later_slices_raise():
    """Noisy gating and the dense gate run (held against JAX in
    ``tests/test_torch_moe_dense.py``); what stays for a later slice is
    AutoEP on an HF model (the HF importer)."""
    from deepspeed_tpu_torch.moe import auto_ep

    logits = torch.zeros(4, 4)
    noisy = PGt.topk_gating_indices(logits, rng=torch.Generator(),
                                    noise_std=1.0)
    assert noisy.experts.shape == (4, 2)
    assert PGt.topk_gating(logits).combine.shape == (4, 4, 4)
    with pytest.raises(NotImplementedError, match="later slice"):
        auto_ep.auto_ep(object())


def test_expert_sort_matches_jax():
    flat = np.random.default_rng(1).integers(0, 6, 200).astype(np.int32)
    flat[flat == 3] = 4                                   # an empty expert
    jo, ji, jc = JL.expert_sort(jnp.asarray(flat), 6)
    po, pi, pc = PL.expert_sort(torch.from_numpy(flat).long(), 6)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert pc.dtype == torch.int32 and int(pc[3]) == 0


FFN_CASES = {
    "gelu": dict(activation="gelu"),
    "swiglu": dict(activation="swiglu"),
    "shared_gated": dict(activation="swiglu", shared=64, shared_gate=True),
    "route_scale_sigmoid_bias": dict(activation="gelu", route_scale=2.5,
                                     score_func="sigmoid", bias=True,
                                     route_norm=False),
}
B, S, H, E, F, K = 2, 8, 32, 4, 48, 2


def _ffn_inputs(case):
    kw = FFN_CASES[case]
    rng = np.random.default_rng(2)

    def n(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    params = {"x": n(B, S, H), "gate_w": n(H, E, s=0.5),
              "w_up": n(E, H, F, s=H ** -0.5),
              "w_down": n(E, F, H, s=F ** -0.5)}
    if kw["activation"] == "swiglu":
        params["w_gate"] = n(E, H, F, s=H ** -0.5)
    if kw.get("shared"):
        fs = kw["shared"]
        params.update(sw_up=n(H, fs, s=H ** -0.5), sw_down=n(fs, H, s=fs ** -0.5),
                      sw_gate=n(H, fs, s=H ** -0.5))
        if kw.get("shared_gate"):
            params["shared_gate_w"] = n(H, 1, s=0.5)
    if kw.get("bias"):
        params["gate_bias"] = n(E, s=0.3)
    return kw, params, n(B, S, H)


def _split(p):
    experts = {k: p[k] for k in ("w_up", "w_down", "w_gate") if k in p}
    shared = {k: p[k] for k in ("sw_up", "sw_down", "sw_gate",
                                "shared_gate_w") if k in p}
    return experts, shared or None


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_and_grads_match_jax(case, one_device_mesh):
    kw, params, cot = _ffn_inputs(case)
    opts = dict(activation=kw["activation"], k=K,
                score_func=kw.get("score_func", "softmax"),
                route_norm=kw.get("route_norm", True),
                route_scale=kw.get("route_scale", 1.0))
    aux_coef = 0.7

    def jloss(p):
        experts, shared = _split(p)
        y, aux = JL.moe_ffn(p["x"], p["gate_w"], experts, shared=shared,
                            gate_bias=p.get("gate_bias"), **opts)
        return jnp.sum(y * cot) + aux_coef * aux, (y, aux)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (jl, (jy, jaux)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)

    tp = {k: torch.from_numpy(v).requires_grad_(k != "gate_bias")
          for k, v in params.items()}
    experts, shared = _split(tp)
    y, aux = PL.moe_ffn(tp["x"], tp["gate_w"], experts, shared=shared,
                        gate_bias=tp.get("gate_bias"), **opts)
    loss = (y * torch.from_numpy(cot)).sum() + aux_coef * aux
    loss.backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **FFN_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **FFN_TOL)
    for name, t in tp.items():
        if name == "gate_bias":        # steers selection only: no gradient
            continue
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrads[name]),
                                   err_msg=name, **FFN_TOL)


def test_moe_ffn_plain_path_and_dispatch_modes(one_device_mesh):
    """``use_kernels=False`` is the same function on the CPU; 'auto'
    resolves to ragged, and to dense with noisy gating; 'ragged' with
    noisy gating raises JAX's error."""
    _, params, _ = _ffn_inputs("swiglu")
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    experts, _ = _split(tp)
    a = PL.moe_ffn(tp["x"], tp["gate_w"], experts, activation="swiglu")
    b = PL.moe_ffn(tp["x"], tp["gate_w"], experts, activation="swiglu",
                   dispatch="ragged", use_kernels=False)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert JL.resolve_dispatch("auto", None, 0.0, B, S, E) == "ragged"
    assert PL.resolve_dispatch("auto") == "ragged"
    assert PL.resolve_dispatch("auto", torch.Generator(), 0.1) == "dense"
    y, _ = PL.moe_ffn(tp["x"], tp["gate_w"], experts, dispatch="dense")
    assert y.shape == tp["x"].shape
    with pytest.raises(ValueError, match="noisy gating"):
        PL.moe_ffn(tp["x"], tp["gate_w"], experts, rng=torch.Generator(),
                   noise_std=0.1, dispatch="ragged")
    with pytest.raises(ValueError, match="auto\\|ragged\\|dense"):
        PL.moe_ffn(tp["x"], tp["gate_w"], experts, dispatch="nope")


# --------------------------------------------------------------------------- #
# the model: init, carrying weights across, serving
# --------------------------------------------------------------------------- #

MOE_VARIANT = dict(activation="swiglu", moe_shared_size=32,
                   moe_shared_gate=True, moe_gate_bias=True,
                   moe_score_func="sigmoid", moe_route_scale=1.5)


def _flat_keys_shapes(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat_keys_shapes(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", tuple(v.shape)


@pytest.mark.parametrize("overrides", [{}, MOE_VARIANT],
                         ids=["tiny_moe", "variant"])
def test_init_params_moe_keys_and_shapes_match_jax(overrides):
    pcfg = PT.get_model_config("tiny_moe", **overrides)
    got = PT.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    want = JT.init_params(JT.get_model_config("tiny_moe", **overrides),
                          jax.random.PRNGKey(0))
    assert list(_flat_keys_shapes(got)) == list(_flat_keys_shapes(want))
    assert torch.all(got["blocks"]["gate_bias"] == 0) if overrides \
        else "gate_bias" not in got["blocks"]


def test_moe_leaves_carry_across_and_serving_refuses():
    jcfg = JT.get_model_config("tiny_moe", dtype="float32", **MOE_VARIANT)
    pcfg = PT.get_model_config("tiny_moe", dtype="float32", **MOE_VARIANT)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(3)))
    model = params_from_numpy(tree, pcfg, device="cpu")
    got = model.tree()
    for key in ("gate_w", "w_up", "w_down", "w_gate", "sw_up", "sw_down",
                "sw_gate", "shared_gate_w", "gate_bias"):
        np.testing.assert_array_equal(got["blocks"][key].numpy(),
                                      tree["blocks"][key], err_msg=key)
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(pcfg, attention="flash"),
        config={"train_micro_batch_size_per_gpu": 2,
                "optimizer": {"type": "adam", "params": {"lr": 1e-3}}},
        device="cpu")
    load_master(engine, tree)
    for key in ("gate_w", "w_up", "w_down", "sw_gate", "gate_bias"):
        np.testing.assert_array_equal(
            engine.state["master"]["blocks"][key].numpy(),
            tree["blocks"][key], err_msg=key)
        # the forward's per-layer leaves view the same values
        np.testing.assert_array_equal(
            engine._params["blocks"][1][key].detach().numpy(),
            tree["blocks"][key][1], err_msg=key)
    # serving takes MoE models now (tokens against JAX's in
    # tests/test_torch_moe_serving.py): a tick over one token runs
    pool = PPG.init_paged_kv(pcfg, 4, 8, device="cpu")
    logits, _ = PPG.forward_paged(got, torch.zeros(1, dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32),
                                  torch.ones(1, 1, dtype=torch.int32),
                                  pool, pcfg)
    assert logits.shape == (1, pcfg.vocab_size)
    assert torch.isfinite(logits).all()
    eng = FastGenEngine("tiny_moe", device="cpu", n_blocks=8, block_size=8,
                        max_blocks_per_seq=4, token_budget=8)
    assert len(eng.generate_all([1], [[1, 2, 3]], max_new_tokens=2)[1]) == 2


# --------------------------------------------------------------------------- #
# training parity with the JAX engine
# --------------------------------------------------------------------------- #

SEQ, STEPS, DP = 32, 3, 8


def _config(micro):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adam", "params": {"lr": 1e-2}},
            "gradient_clipping": 1.0,
            "zero_optimization": {"stage": 1},
            "steps_per_print": 10 ** 6}


def test_tiny_moe_training_matches_jax_engine():
    """fp32 tiny_moe, gas 2, clipping: losses (LM + 0.01 × aux) within
    2e-5 relative and grad norms within 2e-4 relative over three steps —
    the tolerances of the dense engine test, on a model whose routing
    must agree exactly for them to hold."""
    spec = dst.causal_lm_spec("tiny_moe", attention="flash", remat="full",
                              dtype="float32")
    jeng, *_ = dst.initialize(model=spec, config=_config(1))
    master0 = jax.tree.map(np.asarray, jeng.state["master"])
    jdata = jax_data(DP, SEQ, 512, seed=5)
    jlosses, jnorms = [], []
    for _ in range(STEPS):
        jlosses.append(float(jeng.train_batch(jdata)))
        jnorms.append(float(jeng.get_global_grad_norm()))

    pspec = dtt.causal_lm_spec("tiny_moe", attention="flash", remat="full",
                               dtype="float32")
    peng, *_ = dtt.initialize(model=pspec, config=_config(DP), device="cpu")
    load_master(peng, master0)
    pdata = synthetic_lm_data(DP, SEQ, 512, seed=5)
    plosses, pnorms = [], []
    for _ in range(STEPS):
        plosses.append(float(peng.train_batch(pdata)))
        pnorms.append(peng.get_global_grad_norm())
    np.testing.assert_allclose(plosses, jlosses, rtol=2e-5, atol=0)
    np.testing.assert_allclose(pnorms, jnorms, rtol=2e-4)
    # the aux term is in the loss: the same weights without it differ
    nospec = dtt.causal_lm_spec("tiny_moe", attention="flash",
                                dtype="float32", moe_aux_coef=0.0)
    neng, *_ = dtt.initialize(model=nospec, config=_config(DP), device="cpu")
    load_master(neng, master0)
    first = float(neng.train_batch(synthetic_lm_data(DP, SEQ, 512, seed=5)))
    assert first < jlosses[0] - 1e-3


@pytest.mark.parametrize("precision", ["float32", "bfloat16", "float16"])
def test_moe_training_runs_the_grouped_gemm_path(precision):
    """On the CPU the wrappers run the plain versions (no launch counted);
    the step trains in every precision (fp16: the aux term under the loss
    scale), and the per-layer [E, H, F] leaves and the router get
    gradients."""
    spec = dtt.causal_lm_spec("tiny_moe", attention="flash", remat="full",
                              dtype=precision)
    config = _config(4)
    if precision == "bfloat16":
        config["bf16"] = {"enabled": True}
    elif precision == "float16":
        config["fp16"] = {"enabled": True, "initial_scale_power": 8}
    engine, *_ = dtt.initialize(model=spec, config=config, device="cpu")
    master = engine.state["master"]["blocks"]
    start = {k: master[k].clone() for k in ("gate_w", "w_up", "w_down")}
    before = dict(GG.launches)
    batch = next(synthetic_lm_data(4, SEQ, 512, seed=0))
    losses = [float(engine.train_batch(itertools.repeat(batch)))
              for _ in range(4)]
    assert GG.launches == before
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert engine.skipped_steps == 0
    for key, value in start.items():
        assert not torch.equal(master[key], value), key
