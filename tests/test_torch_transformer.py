"""Model pieces of the PyTorch port against the JAX package: presets, init,
rope tables, and one paged forward tick (logits and KV pool)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import paged as JPG
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.models import paged as PPG
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy

ATOL = 1e-4       # fp32 through two layers, other summation order


def test_presets_equal_field_by_field():
    assert sorted(PT.PRESETS) == sorted(JT.PRESETS)
    for name, jcfg in JT.PRESETS.items():
        pcfg = PT.PRESETS[name]
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg), name
        for prop in ("kv_heads", "head_dim", "ffn_size", "rope_dim",
                     "has_ln2", "attn_bias_enabled", "moe_ffn"):
            assert getattr(pcfg, prop) == getattr(jcfg, prop), (name, prop)
        assert pcfg.num_params() == jcfg.num_params(), name
        assert str(pcfg.compute_dtype).split(".")[-1] == jcfg.dtype
    over = dict(dtype="float32", max_seq_len=512, num_kv_heads=2)
    assert dataclasses.asdict(PT.get_model_config("tiny", **over)) == \
        dataclasses.asdict(JT.get_model_config("tiny", **over))
    with pytest.raises(ValueError, match="unknown model preset"):
        PT.get_model_config("no_such_model")


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "linear", "factor": 4.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
    {"rope_type": "yarn", "factor": 4.0,
     "original_max_position_embeddings": 64},
])
def test_rope_table_matches(scaling):
    cos, sin = PT.rope_table(300, 32, 10000.0, scaling, device="cpu")
    jcos, jsin = JT.rope_table(300, 32, 10000.0, scaling)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["tiny", "tiny_llama"])
def test_init_params_keys_shapes_and_scale(name):
    cfg = PT.get_model_config(name)
    got = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = JT.init_params(JT.get_model_config(name), jax.random.PRNGKey(0))
    flat_p = dict(PPG._ParamTree(got).named_parameters())
    flat_j = {"/".join(str(k.key) for k in path): v for path, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(k.replace(".", "/") for k in flat_p) == sorted(flat_j)
    for key, v in flat_p.items():
        assert tuple(v.shape) == flat_j[key.replace(".", "/")].shape, key
        assert v.dtype == torch.float32
    L = cfg.num_layers
    assert abs(float(got["blocks"]["wq"].std()) - cfg.init_std) < 2e-3
    assert abs(float(got["blocks"]["wo"].std())
               - cfg.init_std / np.sqrt(2 * L)) < 2e-3
    assert torch.all(got["final_norm"]["scale"] == 1)
    bf = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                        dtype=torch.bfloat16)
    assert bf["blocks"]["w_up"].dtype == torch.bfloat16
    torch.testing.assert_close(bf["blocks"]["w_up"].float(),
                               got["blocks"]["w_up"], rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("option", [
    dict(pos_emb="alibi"), dict(qk_norm=True), dict(parallel_block=True),
    dict(emb_norm=True), dict(n_experts=4),
    dict(mla=True, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
         v_head_dim=8)])
def test_unsupported_options_raise(option):
    cfg = PT.get_model_config("tiny", **option)
    with pytest.raises(NotImplementedError, match="later slice"):
        PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        PPG.init_paged_kv(cfg, 4, 8, device="cpu")


def test_head_matmul_returns_fp32_logits():
    x = torch.randn(3, 16).bfloat16()
    w = torch.randn(16, 50).bfloat16()
    out = PT.head_matmul(x, w)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, x.float() @ w.float())


def _tick_inputs(bs, MB, NB):
    """A mixed tick: seq A decodes at pos 21 over context already in the
    pool, seq B prefills positions 0..9, then two pad rows."""
    tokens = np.array([7] + list(range(30, 40)) + [0, 0], np.int32)
    positions = np.array([21] + list(range(10)) + [0, 0], np.int32)
    tables = np.zeros((len(tokens), MB), np.int32)
    tables[0, :3] = [3, 5, 2]            # seq A: blocks for slots 0..23
    tables[1:11, :2] = [4, 6]            # seq B: blocks for slots 0..15
    return tokens, positions, tables, 11


@pytest.mark.parametrize("name", ["tiny", "tiny_llama"])
def test_forward_paged_tick_matches_jax(name):
    jcfg = JT.get_model_config(name, dtype="float32")
    pcfg = PT.get_model_config(name, dtype="float32")
    params = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                     jax.random.PRNGKey(1)))
    model = params_from_numpy(params, pcfg, device="cpu")
    bs, MB, NB = 8, 4, 8
    rng = np.random.default_rng(0)
    shape = (jcfg.num_layers, NB, bs, jcfg.kv_heads, jcfg.head_dim)
    pool = {k: rng.normal(size=shape).astype(np.float32) for k in "kv"}
    tokens, positions, tables, real = _tick_inputs(bs, MB, NB)

    jlogits, jpool = JPG.forward_paged(
        params, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(tables), {k: jnp.asarray(v) for k, v in pool.items()},
        jcfg)
    ppool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    plogits, out_pool = PPG.forward_paged(
        model.tree(), torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(tables), ppool, model.cfg)
    assert out_pool is ppool                 # written in place
    assert plogits.dtype == torch.float32
    np.testing.assert_allclose(plogits[:real].numpy(),
                               np.asarray(jlogits)[:real], rtol=0, atol=ATOL)
    for k in "kv":                           # block 0 = pad trash
        np.testing.assert_allclose(ppool[k][:, 1:].numpy(),
                                   np.asarray(jpool[k])[:, 1:], rtol=0,
                                   atol=1e-5)
    # the plain path (use_kernels=False) is the same function on the CPU
    again = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    plain, _ = PPG.forward_paged(
        model.tree(), torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(tables), again, model.cfg, use_kernels=False)
    torch.testing.assert_close(plain, plogits, rtol=0, atol=0)


def test_params_from_numpy_casts_to_compute_dtype():
    jcfg = JT.get_model_config("tiny_llama")            # bf16 compute
    params = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
    model = params_from_numpy(params, PT.get_model_config("tiny_llama"),
                              device="cpu")
    assert model.blocks.wq.dtype == torch.bfloat16
    assert tuple(model.blocks.wq.shape) == params["blocks"]["wq"].shape
    assert not model.blocks.wq.requires_grad
    assert model.lm_head.shape == params["lm_head"].shape
