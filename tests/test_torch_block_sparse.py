"""Block-sparse attention of the PyTorch port against the JAX package.

* The layout builders give the JAX builders' int32 arrays bit for bit
  (bigbird's ``RandomState`` draws included), and the device lists the
  kernels walk (CSR rows, CSC columns) rebuild the layout exactly.
* The plain versions (``block_sparse_fwd_ref`` / ``block_sparse_bwd_ref``,
  run by ``block_sparse_attention`` for CPU tensors) against the Pallas
  ``block_sparse_attention`` (interpret mode, as
  ``tests/unit/test_block_sparse.py`` runs it) and its jnp reference,
  forward and ``jax.vjp`` gradients, at block 64 with layouts that leave
  squares inactive; an inactive row, gradients outside the layout, GQA
  against JAX's repeat, the ``ValueError``s, and a tiny_llama model with
  ``attention="sparse:bslongformer"``. Tolerances: fp32 forward 1e-5,
  gradients 1e-4, bf16 3e-2.

The CUDA kernels run only on a GPU; ``chip_smoke.py`` holds them against
the plain versions there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import api as JAPI
from deepspeed_tpu.ops.pallas import block_sparse as JB
import deepspeed_tpu as dst
import deepspeed_tpu_torch as dtt
from deepspeed_tpu_torch.models import api as PAPI
from deepspeed_tpu_torch.ops import block_sparse as BS
from deepspeed_tpu_torch.ops import flash_attention as PF

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)

BUILDERS = ["dense", "fixed", "bslongformer", "variable", "causal_fixed"]


def _build(mod, name, n):
    if name == "causal_fixed":
        return mod.causal_layout(mod.fixed_layout(n))
    return getattr(mod, f"{name}_layout")(n)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 32])
@pytest.mark.parametrize("name", BUILDERS)
def test_layout_builders_are_bit_equal(name, n):
    got, want = _build(BS, name, n), _build(JB, name, n)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 32])
@pytest.mark.parametrize("seed", [0, 7])
def test_bigbird_draws_are_bit_equal(seed, n):
    got = BS.bigbird_layout(n, seed=seed)
    want = JB.bigbird_layout(n, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["causal_fixed", "bslongformer", "variable"])
def test_layout_lists_rebuild_the_layout(name):
    lay = _build(BS, name, 32)
    row_ptr, col_idx, col_ptr, row_idx = (
        t.numpy() for t in BS.layout_lists(lay, "cpu"))
    assert all(a.dtype == np.int32 for a in (row_ptr, col_idx, col_ptr,
                                             row_idx))
    by_rows, by_cols = np.zeros_like(lay), np.zeros_like(lay)
    for i in range(32):
        cols = col_idx[row_ptr[i]:row_ptr[i + 1]]
        assert (np.diff(cols) > 0).all()
        by_rows[i, cols] = 1
        rows = row_idx[col_ptr[i]:col_ptr[i + 1]]
        assert (np.diff(rows) > 0).all()
        by_cols[rows, i] = 1
    np.testing.assert_array_equal(by_rows, lay)
    np.testing.assert_array_equal(by_cols, lay)
    assert BS.layout_lists(lay, "cpu")[0] is BS.layout_lists(lay.copy(),
                                                            "cpu")[0]


def _bhsd(B, H, S, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, S, D)).astype(dtype) for _ in range(4)]


def _sparse_case(kind, S, block):
    n = S // block
    if kind == "fixed":
        return JB.causal_layout(JB.fixed_layout(n)), True
    if kind == "bigbird":
        return JB.bigbird_layout(n), False
    if kind == "causal_bigbird":
        return JB.causal_layout(JB.bigbird_layout(n)), True
    if kind == "bslongformer":
        return JB.bslongformer_layout(n), False
    if kind == "inactive_row":
        lay = JB.bslongformer_layout(n)
        lay[1] = 0
        return lay, False
    return JB.dense_layout(n), True


# (kind, S): block 64; the causal fixed and bigbird layouts need S 512 to
# leave squares inactive
CASES = [("fixed", 512), ("bigbird", 256), ("causal_bigbird", 512),
         ("bslongformer", 256), ("inactive_row", 256), ("dense", 128)]


@pytest.mark.parametrize("kind,S", CASES)
def test_plain_matches_pallas_kernel_and_reference(kind, S):
    B, D, block = 1, 32, 64
    H = 1 if S > 256 else 2
    lay, causal = _sparse_case(kind, S, block)
    if kind != "dense":
        allowed = np.tril(np.ones_like(lay)) if causal else np.ones_like(lay)
        assert lay.sum() < allowed.sum()     # the layout really is sparse
    q, k, v, do = _bhsd(B, H, S, D, seed=S + len(kind))
    jin = [jnp.asarray(x) for x in (q, k, v)]
    jout, vjp = jax.vjp(lambda a, b, c: JB.block_sparse_attention(
        a, b, c, lay, block, causal=causal), *jin)
    jgrads = vjp(jnp.asarray(do))
    rout, rvjp = jax.vjp(lambda a, b, c: JB.block_sparse_attention_reference(
        a, b, c, lay, block, causal=causal), *jin)
    rgrads = rvjp(jnp.asarray(do))

    before = dict(BS.launches)
    tin = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = BS.block_sparse_attention(*tin, lay, block, causal=causal)
    out.backward(torch.from_numpy(do))
    assert BS.launches == before             # CPU: plain versions only
    ref = BS.block_sparse_attention_reference(*tin, lay, block, causal)
    for want in (jout, rout):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   **FWD_TOL)
    np.testing.assert_allclose(ref.detach().numpy(), np.asarray(rout),
                               **FWD_TOL)
    for grads in (jgrads, rgrads):
        for t, want, name in zip(tin, grads, "qkv"):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                       err_msg=name, **GRAD_TOL)


def test_bf16_forward_and_gradients():
    B, H, S, D, block = 1, 2, 256, 32, 64
    lay = JB.causal_layout(JB.bslongformer_layout(S // block))
    q, k, v, do = _bhsd(B, H, S, D, seed=3)
    jin = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    jout, vjp = jax.vjp(lambda a, b, c: JB.block_sparse_attention(
        a, b, c, lay, block), *jin)
    jgrads = vjp(jnp.asarray(do, jnp.bfloat16))
    tin = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
    out = BS.block_sparse_attention(*tin, lay, block)
    out.backward(torch.from_numpy(do).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout, np.float32), **BF16_TOL)
    for t, want in zip(tin, jgrads):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(want, np.float32), **BF16_TOL)


def test_inactive_row_is_zero_and_grads_vanish_outside_the_layout():
    """A q square with no active block: o = 0, lse = -1e30 (NEG_INF, not
    -inf), dq = 0; kv squares no row attends: dk = dv = 0 exactly."""
    B, S, N, D, block = 2, 256, 2, 32, 64
    lay = np.zeros((4, 4), np.int32)
    lay[:, 0] = 1
    lay[2, 2] = 1
    lay[1] = 0
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, S, N, D))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = BS.block_sparse_fwd(q, k, v, lay, block, causal=False)
    rows = slice(block, 2 * block)
    assert (o[:, rows] == 0).all() and (o[:, :block] != 0).any()
    lse = lse.reshape(B, N, S)
    assert (lse[:, :, rows] == BS.NEG_INF).all()
    assert torch.isfinite(lse).all()
    dq, dk, dv = BS.block_sparse_bwd(q, k, v, o, lse.reshape(B * N, S), do,
                                     lay, block, causal=False)
    assert (dq[:, rows] == 0).all() and (dq[:, :block] != 0).any()
    for g in (dk, dv):
        assert (g[:, block:2 * block] == 0).all()
        assert (g[:, 3 * block:] == 0).all()
        assert (g[:, :block] != 0).any() and (g[:, 2 * block:3 * block]
                                              != 0).any()


@pytest.mark.parametrize("kind", ["bslongformer", "bigbird"])
def test_gqa_model_attention_matches_jax_repeat(kind):
    """The model path's closure, [B, S, N, D] with K kv heads: the port
    reads kv head n // (N/K) in place, JAX repeats kv heads in memory."""
    B, S, N, K, D = 2, 256, 4, 2, 16
    rng = np.random.default_rng(11)
    q, do = (rng.normal(size=(B, S, N, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, S, K, D)).astype(np.float32)
            for _ in range(2))
    jfn = JAPI.resolve_attention(f"sparse:{kind}")
    jout, vjp = jax.vjp(lambda a, b, c: jfn(a, b, c, causal=True),
                        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    pfn = PAPI.resolve_attention(f"sparse:{kind}")
    tin = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = pfn(*tin, causal=True)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for t, want, name in zip(tin, jgrads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("S,lay_n", [(200, 3), (256, 3)])
def test_value_errors_match_jax(S, lay_n):
    q = np.zeros((1, 1, S, 32), np.float32)
    lay = np.ones((lay_n, lay_n), np.int32)
    with pytest.raises(ValueError) as jerr:
        JB.block_sparse_attention(jnp.asarray(q), jnp.asarray(q),
                                  jnp.asarray(q), lay, 64)
    t = torch.from_numpy(q)
    with pytest.raises(ValueError) as perr:
        BS.block_sparse_attention(t, t, t, lay, 64)
    assert str(perr.value) == str(jerr.value)


def test_kernel_wrapper_checks_refuse_what_the_kernels_do_not_take():
    """The CUDA path's checks, called directly (a CPU tensor never reaches
    them): the block must be a multiple of 64, D one of 64 and 128."""
    q = torch.zeros(1, 256, 2, 64)
    with pytest.raises(ValueError, match="multiples of 64"):
        BS._check_block(q, np.ones((8, 8), np.int32), 32)
    with pytest.raises(ValueError, match="do not tile"):
        BS._check_block(q, np.ones((2, 2), np.int32), 64)
    q = torch.zeros(1, 256, 2, 32)
    with pytest.raises(ValueError, match=r"block-sparse attention: head dim "
                                         r"32; the kernels take D in \(64, "
                                         r"128\)"):
        PF._check(q, q, q, what="block-sparse attention")


def test_unknown_sparse_kind_raises_jax_value_error():
    with pytest.raises(ValueError) as jerr:
        JAPI.resolve_attention("sparse:bogus")
    with pytest.raises(ValueError) as perr:
        dtt.causal_lm_spec("tiny", attention="sparse:bogus")
    assert str(perr.value) == str(jerr.value)
    assert "unknown sparse pattern 'bogus'" in str(perr.value)


def _spec_pair(attention, **kw):
    jspec = dst.causal_lm_spec("tiny_llama", attention=attention,
                               dtype="float32", max_seq_len=256, **kw)
    pspec = dtt.causal_lm_spec("tiny_llama", attention=attention,
                               dtype="float32", max_seq_len=256, **kw)
    return jspec, pspec


def _tree(params):
    return jax.tree.map(
        lambda x: torch.from_numpy(np.array(x)).requires_grad_(), params)


def test_model_loss_and_grads_match_jax():
    """tiny_llama (GQA 4/2, D 16) at seq 256 with sparse:bslongformer:
    block 64 → a causal 4 x 4 layout with one inactive square."""
    jspec, pspec = _spec_pair("sparse:bslongformer")
    params = jspec.init_fn(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, 512, (1, 256),
                                               dtype=np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jspec.loss_fn(p, {"tokens": jnp.asarray(tokens)}))(params)
    tparams = _tree(params)
    before = dict(BS.launches)
    loss = pspec.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    assert BS.launches == before
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    flat_j = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    flat_t = jax.tree.leaves(tparams)
    assert len(flat_j) == len(flat_t)
    for (path, want), t in zip(flat_j, flat_t):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   err_msg=jax.tree_util.keystr(path),
                                   **GRAD_TOL)


@pytest.mark.parametrize("attention", ["sparse", "sparse:fixed",
                                       "sparse:bigbird"])
def test_kinds_and_plain_path_give_one_loss(attention):
    """``sparse`` is ``sparse:fixed``; ``use_kernels=False`` (the plain
    version under autograd) gives the same loss on the CPU, and the spec
    rebuilt for another remat policy keeps its attention."""
    _, spec = _spec_pair(attention)
    plain = dtt.causal_lm_spec("tiny_llama", attention=attention,
                               dtype="float32", max_seq_len=256,
                               use_kernels=False)
    fixed = dtt.causal_lm_spec("tiny_llama", attention="sparse:fixed",
                               dtype="float32", max_seq_len=256)
    params = spec.init_fn(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (1, 256), dtype=np.int32))}
    loss = float(spec.loss_fn(params, batch))
    assert float(plain.loss_fn(params, batch)) == pytest.approx(loss,
                                                                rel=1e-6)
    assert float(spec.builder(remat="full").loss_fn(params, batch)) == \
        pytest.approx(loss, rel=1e-6)
    if attention == "sparse":
        assert float(fixed.loss_fn(params, batch)) == loss
