"""The int8 wire's kernels of the PyTorch port against the JAX package.

* ``quantize_int8_blocks_ref`` (the CUDA kernel's plain version, reached
  through the wrapper on CPU tensors) against the jnp ``quantize_int8``
  (the function the JAX engine's wire runs, and the Pallas kernel's stated
  contract) and the Pallas ``quantize_int8_blocks`` in interpret mode: q
  bit-equal to both; the scales equal to jnp's (rtol 0) and within one ulp
  of the interpreted kernel's — XLA's CPU compiler turns that kernel's
  ``amax / 127`` into ``amax * (1/127)`` (measured: 1 ulp on one block of
  four), where the jnp function divides. Cases: normal data, exact .5
  ties, an all-zero block, a block at ±amax, one block, bf16 input and a
  block holding inf.
  A block holding NaN is the port's one deviation (ROADMAP queue C): JAX
  gives it scale 1 and loses the NaN, the port a NaN scale.
* ``dequant_reduce_ref`` at W 1, 2, 4, 8, ``mean`` on and off: bit-equal
  to the jnp dequantize-and-sum that the JAX engine's qgZ wire runs
  (``parallel/compressed._q_reduce_scatter``); against the Pallas kernel in
  interpret mode bit-equal at W 1 and within W - 1 fp32 ulps beyond —
  XLA's CPU compiler contracts one product of the interpreted kernel's sum
  into a fused multiply-add (measured: fma(q0, s0, q1·s1) at W 2).
* The wrappers' ``ValueError``\\ s; ``pad_to_block``, ``pack_signs`` /
  ``unpack_signs`` bit-equal to JAX's and ``onebit_compress``'s signs too
  (its scales to 1e-6: a mean in XLA's summation order); the world-1
  entry points.
* The ZeRO layout: each leaf's sharded dim equal to JAX's
  ``ShardingPolicy(..., zero_stage=2).zero_spec`` for tiny, gpt2_125m,
  llama_750m and moe_350m at worlds 2, 4 and 8 (shapes only).

The CUDA kernels run only on a GPU; ``chip_smoke.py`` holds them against
these plain versions there, bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from deepspeed_tpu.comm import mesh as JM
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import quantization as JQ
from deepspeed_tpu.ops.pallas import quantization as JPQ
from deepspeed_tpu.parallel.partitioning import ShardingPolicy as JPolicy
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import quant_kernels as QK
from deepspeed_tpu_torch.ops import quantization as PQ
from deepspeed_tpu_torch.parallel.partitioning import ShardingPolicy

B = 2048


def _blocks(case):
    rng = np.random.default_rng(len(case))
    if case.startswith("normal"):
        n = {"normal_a": 4, "normal_b": 8, "normal_c": 3}[case]
        return (rng.standard_normal(n * B) * 10.0 ** rng.integers(
            -3, 3, n).repeat(B)).astype(np.float32)
    if case == "ties":
        # x = (k + 1/2) scale with scale = 0.5 exactly (amax 63.5): every
        # quotient is an exact half, rounded to even
        k = np.arange(-127, 127, dtype=np.float32)
        x = np.zeros(B, np.float32)
        x[:k.size] = (k + 0.5) * 0.5
        x[-1] = 63.5
        return x
    if case == "zero_block":
        x = rng.standard_normal(3 * B).astype(np.float32)
        x[B:2 * B] = 0.0
        return x
    if case == "pm_amax":
        x = rng.uniform(-1, 1, 2 * B).astype(np.float32)
        x[7], x[B + 9] = 3.0, -3.0
        return x
    if case == "one_block":
        return rng.standard_normal(B).astype(np.float32) * 1e-3
    if case == "inf_block":
        x = rng.standard_normal(3 * B).astype(np.float32)
        x[B + 5], x[2 * B + 1] = np.inf, -np.inf
        return x
    raise KeyError(case)


CASES = ("normal_a", "normal_b", "normal_c", "ties", "zero_block", "pm_amax",
         "one_block", "inf_block")


def _check_against_jax(q, s, x):
    jq, js = JQ.quantize_int8(x)
    pq, ps = JPQ.quantize_int8_blocks(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(pq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(ps), maxulp=1)


@pytest.mark.parametrize("case", CASES)
def test_quantize_matches_pallas_and_jnp(case):
    x = _blocks(case)
    before = dict(QK.launches)
    q, s = QK.quantize_int8_blocks(torch.from_numpy(x))
    assert QK.launches == before                 # CPU: the plain version
    _check_against_jax(q, s, jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    if case == "ties":
        assert s.item() == 0.5
        assert q[:4].tolist() == [-126, -126, -124, -124]  # half to even
    if case == "zero_block":
        assert s[1].item() == 1.0 and not q[B:2 * B].any()
    if case == "inf_block":
        assert np.isinf(s[1:].numpy()).all() and not q[B:].any()


def test_quantize_bf16_input_matches_pallas_and_jnp():
    x = np.random.default_rng(5).standard_normal(4 * B).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    q, s = PQ.quantize_int8(xb)
    _check_against_jax(q, s, jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16))


def test_nan_block_gets_a_nan_scale_where_jax_loses_the_nan():
    """The queue C deviation: JAX's scale is 1 for a block whose amax is
    NaN (``NaN > 0`` is false) and the NaN becomes q 0, so the block's
    small values are re-quantized with step 1 and the NaN vanishes; the
    port gives the block a NaN scale (q 0), so it dequantizes to NaN and
    the overflow skip sees it. The other blocks are JAX's bits."""
    x = np.random.default_rng(6).standard_normal(3 * B).astype(np.float32)
    x *= 1e-3
    x[B + 11] = np.nan
    q, s = QK.quantize_int8_blocks(torch.from_numpy(x))
    for jq, js in (JPQ.quantize_int8_blocks(jnp.asarray(x)),
                   JQ.quantize_int8(jnp.asarray(x))):
        jq, js = np.asarray(jq), np.asarray(js)
        assert js[1] == 1.0 and jq[B + 11] == 0        # the reference
        assert not jq[B:2 * B].any()                   # 1e-3 → 0 at step 1
        keep = np.r_[0:B, 2 * B:3 * B]
        np.testing.assert_array_equal(q.numpy()[keep], jq[keep])
        np.testing.assert_array_max_ulp(s.numpy()[[0, 2]], js[[0, 2]], 1)
    assert np.isnan(s[1].item()) and not q[B:2 * B].any()
    deq = PQ.dequantize_int8(q, s)
    assert torch.isnan(deq[B:2 * B]).all() and torch.isfinite(deq[:B]).all()


def _jnp_sum(q, s, mean):
    deq = jax.vmap(lambda a, b: JQ.dequantize_int8(a, b, B))(
        jnp.asarray(q), jnp.asarray(s))
    out = jnp.sum(deq, axis=0)
    return np.asarray(out / q.shape[0] if mean else out)


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("mean", [False, True])
def test_dequant_reduce_matches_jnp_sum_and_pallas(W, mean):
    rng = np.random.default_rng(10 * W + mean)
    q = rng.integers(-127, 128, (W, 3 * B)).astype(np.int8)
    s = (rng.random((W, 3)) + 0.01).astype(np.float32)
    before = dict(QK.launches)
    got = QK.dequant_reduce(torch.from_numpy(q), torch.from_numpy(s),
                            mean=mean).numpy()
    assert QK.launches == before and got.dtype == np.float32
    np.testing.assert_array_equal(got, _jnp_sum(q, s, mean))
    pallas = np.asarray(JPQ.dequant_reduce(jnp.asarray(q), jnp.asarray(s),
                                           mean=mean))
    # in ulps of the largest partial sum: an FMA skips one rounding of a
    # product, the sum near 0 has a finer ulp than its terms
    terms = np.abs(q.astype(np.float32) * np.repeat(s, B, axis=1)).sum(0)
    ulps = np.abs(got - pallas) / np.spacing(terms / (W if mean else 1))
    assert ulps.max() <= max(W - 1, 0), ulps.max()
    out = torch.full((3 * B,), 7.0)
    assert QK.dequant_reduce(torch.from_numpy(q), torch.from_numpy(s),
                             mean=mean, out=out) is out
    np.testing.assert_array_equal(out.numpy(), got)


def test_wrappers_raise_jax_value_errors():
    x = np.zeros(B + 8, np.float32)
    for fn in (QK.quantize_int8_blocks, JPQ.quantize_int8_blocks):
        with pytest.raises(ValueError, match="multiple of block=2048"):
            fn(torch.from_numpy(x) if fn is QK.quantize_int8_blocks
               else jnp.asarray(x))
    q = np.zeros((2, B + 4), np.int8)
    s = np.ones((2, 1), np.float32)
    with pytest.raises(ValueError, match="multiple of block=2048"):
        QK.dequant_reduce(torch.from_numpy(q), torch.from_numpy(s))
    with pytest.raises(ValueError, match="multiple of block=2048"):
        JPQ.dequant_reduce(jnp.asarray(q), jnp.asarray(s))
    with pytest.raises(ValueError, match="unsupported device"):
        QK.quantize_int8_blocks(torch.zeros(B, device="meta"))
    with pytest.raises(ValueError, match="must divide world"):
        # the entry point's own check needs world > 1: the JAX message
        JQ.quantized_reduce_scatter(
            jnp.zeros((2, B)), Mesh(np.array(jax.devices()[:2]), ("data",)))


def test_pad_signs_and_onebit_compress_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal(3000).astype(np.float32)
    got, pad = PQ.pad_to_block(torch.from_numpy(x))
    want, jpad = JQ.pad_to_block(jnp.asarray(x))
    assert pad == jpad == 2 * B - 3000
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sign = rng.random(8 * 64) > 0.5
    packed = PQ.pack_signs(torch.from_numpy(sign))
    jpacked = JQ.pack_signs(jnp.asarray(sign))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(PQ.unpack_signs(packed).numpy(),
                                  np.asarray(JQ.unpack_signs(jpacked)))
    g = rng.standard_normal(2 * B).astype(np.float32)
    e = (0.1 * rng.standard_normal(2 * B)).astype(np.float32)
    sign, scale, err = PQ.onebit_compress(torch.from_numpy(g),
                                          torch.from_numpy(e))
    jsign, jscale, jerr = JQ.onebit_compress(jnp.asarray(g), jnp.asarray(e))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    # the per-block mean |x| is a 2048-term fp32 sum in an order XLA picks
    # (neither sequential nor one fixed lane tree, measured): 1e-6 relative
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-6)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=0,
                               atol=1e-6)


def test_entry_points_at_world_one():
    """No process group: ``quantized_reduce_scatter`` returns ``x`` itself
    and ``onebit_allreduce`` (x + error, zeros), as JAX at world 1."""
    x = torch.randn(2 * B)
    assert PQ.quantized_reduce_scatter(x) is x
    e = torch.randn(2 * B)
    red, err = PQ.onebit_allreduce(x, e)
    jred, jerr = JQ.onebit_allreduce(
        jnp.asarray(x.numpy())[None], jnp.asarray(e.numpy())[None],
        Mesh(np.array(jax.devices()[:1]), ("data",)))
    np.testing.assert_array_equal(red.numpy(), np.asarray(jred))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr)[0])


# --------------------------------------------------------------------------- #
# the ZeRO layout
# --------------------------------------------------------------------------- #

def _jax_mesh(world):
    shape = tuple(world if a == JM.DATA_AXIS else 1
                  for a in JM.DEFAULT_AXIS_ORDER)
    return Mesh(np.array(jax.devices()[:world]).reshape(shape),
                JM.DEFAULT_AXIS_ORDER)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("model", ["tiny", "gpt2_125m", "llama_750m",
                                   "moe_350m"])
def test_zero_dims_match_jax_sharding_policy(model):
    jcfg = JT.get_model_config(model)
    jaxes = JT.param_logical_axes(jcfg)
    paxes = PT.param_logical_axes(PT.get_model_config(model))
    assert dict(_leaves(paxes)) == dict(_leaves(jaxes))
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    pshapes = jax.tree.map(lambda s: tuple(s.shape), shapes)
    for world in (2, 4, 8):
        want = JPolicy(_jax_mesh(world), zero_stage=2).zero_spec(jaxes,
                                                                 shapes)
        got = ShardingPolicy({"data": world}, zero_stage=2).zero_spec(
            paxes, pshapes)
        want = {path: tuple(spec) for path, spec in _leaves(want)}
        assert dict(_leaves(got)) == want, (model, world)
        assert any(e is not None for s in want.values() for e in s)
