"""MoE serving of the PyTorch port against the JAX package.

FastGen serves ``tiny_moe`` (4 experts, top-2, the dropless ragged
dispatch over each tick's token rows) and the ``MOE_VARIANT`` of
``tests/test_torch_moe.py`` (swiglu experts, a shared expert with its
sigmoid gate, sigmoid routing with a selection bias, ``route_scale`` 1.5)
greedy, token for token, against the JAX FastGen on the same weights and
prompts (a pool small enough to push back, a prompt split over ticks).

JAX's paged forward hands ``moe_ffn`` a tick's flat [T, H] rows, which its
[B, S, H] unpacking refuses (``deepspeed_tpu/models/paged.py:295`` into
``moe/layer.py:777``). The JAX package is the reference and stays as it
is: the test runs JAX's tick with its ``_ffn`` called on the rows as one
batch row, [1, T, H], which is what the port's ``_ffn`` does with them.
The one-tick logits of the port's ``forward_paged`` against JAX's are held
within 1e-5, and the variant's through the wrappers and through the plain
versions bit for bit on the CPU (the wrappers run their plain versions
there).
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.comm import mesh as JM
from deepspeed_tpu.inference.fastgen import FastGenEngine as JaxFastGen
from deepspeed_tpu.models import paged as JP
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.inference.fastgen import FastGenEngine
from deepspeed_tpu_torch.models import paged as PP
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import tree_from_numpy

ENGINE = dict(n_blocks=10, block_size=16, max_blocks_per_seq=8,
              token_budget=32, temperature=0.0, seed=0)
LENS = [5, 19, 70, 33]
MOE_VARIANT = dict(activation="swiglu", moe_shared_size=32,
                   moe_shared_gate=True, moe_gate_bias=True,
                   moe_score_func="sigmoid", moe_route_scale=1.5)
MODELS = {"tiny_moe": {}, "variant": MOE_VARIANT}


def _prompts(seed=0, lens=LENS, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _params(overrides):
    cfg = JT.get_model_config("tiny_moe", dtype="float32", **overrides)
    tree = jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.PRNGKey(0)))
    if "moe_gate_bias" in overrides:       # a bias that moves the routing
        tree["blocks"]["gate_bias"] = np.random.default_rng(2).standard_normal(
            tree["blocks"]["gate_bias"].shape).astype(np.float32)
    return tree


@contextlib.contextmanager
def _jax_rows_as_batch():
    """JAX's ``_ffn`` with a tick's [T, H] rows taken as one [1, T, H]
    batch row, and a one-device mesh (the JAX ``moe_ffn`` lowers by the
    global mesh); both restored after."""
    orig = JT._ffn

    def ffn(h, lp, cfg):
        if h.ndim == 2 and cfg.n_experts > 0:
            y, aux = orig(h[None], lp, cfg)
            return y[0], aux
        return orig(h, lp, cfg)

    axes = JM.DEFAULT_AXIS_ORDER
    JM.set_mesh(jax.make_mesh((1,) * len(axes), axes,
                              devices=jax.devices()[:1]))
    JT._ffn = ffn
    try:
        yield
    finally:
        JT._ffn = orig
        JM.reset_mesh()


@pytest.mark.parametrize("name", list(MODELS))
def test_moe_greedy_generate_all_matches_jax(name):
    overrides = MODELS[name]
    params = _params(overrides)
    uids = [1, 2, 3, 4]
    prompts = _prompts()
    with _jax_rows_as_batch():
        want = JaxFastGen(JT.get_model_config("tiny_moe", dtype="float32",
                                              **overrides),
                          params=params, use_pallas_kernel=False,
                          **ENGINE).generate_all(uids, prompts,
                                                 max_new_tokens=12,
                                                 planned=False)
    cfg = PT.get_model_config("tiny_moe", dtype="float32", **overrides)
    eng = FastGenEngine(cfg, params=params, device="cpu", **ENGINE)
    got = eng.generate_all(uids, prompts, max_new_tokens=12)
    assert got == want
    assert all(len(v) == 12 for v in got.values())
    assert eng.allocator.free_blocks == ENGINE["n_blocks"] - 1


@pytest.mark.parametrize("name", list(MODELS))
def test_moe_paged_tick_logits_match_jax(name):
    """One mixed tick (a 20-token prompt chunk and a 6-token prompt) from
    an empty pool: logits within 1e-5 of JAX's; the wrappers' path equals
    the plain versions' bit for bit on the CPU."""
    overrides = MODELS[name]
    params = _params(overrides)
    jcfg = JT.get_model_config("tiny_moe", dtype="float32", **overrides)
    pcfg = PT.get_model_config("tiny_moe", dtype="float32", **overrides)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 512, 26).astype(np.int32)
    positions = np.concatenate([np.arange(20), np.arange(6)]).astype(
        np.int32)
    tables = np.zeros((26, 4), np.int32)
    tables[:20, :2] = [1, 2]
    tables[20:, 0] = 3
    with _jax_rows_as_batch():
        jpool = JP.init_paged_kv(jcfg, 8, 16)
        want, _ = JP.forward_paged(jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(tokens),
                                   jnp.asarray(positions),
                                   jnp.asarray(tables), jpool, jcfg)
    tree = tree_from_numpy(params, torch.float32, torch.device("cpu"))
    outs = []
    for use_kernels in (True, False):
        pool = PP.init_paged_kv(pcfg, 8, 16, device="cpu")
        logits, _ = PP.forward_paged(tree, torch.from_numpy(tokens),
                                     torch.from_numpy(positions),
                                     torch.from_numpy(tables), pool, pcfg,
                                     use_kernels=use_kernels)
        outs.append(logits)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(outs[0], outs[1])
