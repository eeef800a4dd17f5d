"""The port's grouped GEMM (``deepspeed_tpu_torch/ops/grouped_gemm.py``)
against the kernels the JAX package's MoE runs on.

* The plain versions ``gmm_ref`` (with and without ``transpose_rhs``) and
  ``tgmm_ref`` against megablox's Pallas ``gmm`` / ``tgmm`` in interpret mode
  (the TPU kernels behind ``deepspeed_tpu/moe/layer.py`` ``grouped_dot``) at
  M 256, K 128, N 256, E 4, group sizes [60, 0, 130, 66] — a tile straddles
  a group boundary and one group is empty. Interpret mode needs M to be a
  multiple of the row tile and takes about a second a call, so the cases
  are few.
* ``gmm`` and the ``grouped_matmul`` Function's gradients against
  ``lax.ragged_dot`` and its VJP at an unaligned M (200), with rows past the
  groups.
* The Function's gradients against autograd of the plain version.

Tolerances: fp32 1e-5 (the same exact products summed in another order);
bf16 one rounding of the output (rtol 2^-7: both sides sum in fp32 and
round once, and may straddle a rounding boundary).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu.megablox.gmm import gmm as mb_gmm
from jax.experimental.pallas.ops.tpu.megablox.gmm import tgmm as mb_tgmm

from deepspeed_tpu_torch.ops import grouped_gemm as GG

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2.0 ** -7, atol=1e-5)}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
M, K, N, E = 256, 128, 256, 4
SIZES = np.array([60, 0, 130, 66], np.int32)
TILING = (128, 128, 128)


def _data(dtype, m=M, k=K, n=N, e=E, seed=0):
    """lhs [m, k], rhs [e, k, n], dy [m, n]: numpy fp32 values exact in
    ``dtype`` (bf16-rounded for bf16), scaled to outputs of O(1)."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((m, k)),
            rng.standard_normal((e, k, n)) / np.sqrt(k),
            rng.standard_normal((m, n)) / np.sqrt(m / e))
    t = [torch.from_numpy(a.astype(np.float32)).to(_TORCH[dtype])
         for a in arrs]
    return [x.float().numpy() for x in t], t


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy()


def _j(a, dtype):
    return jnp.asarray(a, dtype=_JNP[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["gmm", "gmm_transpose_rhs", "tgmm"])
def test_plain_matches_megablox_interpret(op, dtype):
    (x, w, dy), (tx, tw, tdy) = _data(dtype)
    gs = jnp.asarray(SIZES)
    tgs = torch.from_numpy(SIZES)
    if op == "gmm":
        want = mb_gmm(_j(x, dtype), _j(w, dtype), gs, _JNP[dtype], TILING,
                      interpret=True)
        got = GG.gmm_ref(tx, tw, tgs)
    elif op == "gmm_transpose_rhs":
        # the input gradient: dy [M, N] against rhs [E, K, N] → [M, K]
        want = mb_gmm(_j(dy, dtype), _j(w, dtype), gs, _JNP[dtype], TILING,
                      transpose_rhs=True, interpret=True)
        got = GG.gmm_ref(tdy, tw, tgs, transpose_rhs=True)
    else:
        want = mb_tgmm(_j(x, dtype).swapaxes(0, 1), _j(dy, dtype), gs,
                       _JNP[dtype], TILING, interpret=True)
        got = GG.tgmm_ref(tx, tdy, tgs)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == _TORCH[dtype]
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), want, **TOL[dtype])
    if op == "tgmm":
        assert not _np(got)[1].any()           # the empty group: zeros
    # the wrapper takes the plain version for CPU tensors and never counts
    before = dict(GG.launches)
    wrapped = (GG.gmm(tx, tw, tgs) if op == "gmm"
               else GG.gmm(tdy, tw, tgs, transpose_rhs=True)
               if op == "gmm_transpose_rhs" else GG.tgmm(tx, tdy, tgs))
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
    assert GG.launches == before


RAGGED = np.array([50, 0, 90, 52], np.int32)        # 192 of 200 rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_ragged_dot_and_its_vjp(dtype):
    m, k, n = 200, 24, 40
    (x, w, dy), (tx, tw, tdy) = _data(dtype, m, k, n, seed=1)
    gs = jnp.asarray(RAGGED)
    tgs = torch.from_numpy(RAGGED)

    def f(a, b):
        return jax.lax.ragged_dot(a, b, gs)

    want, vjp = jax.vjp(f, _j(x, dtype), _j(w, dtype))
    wdx, wdw = vjp(_j(dy, dtype))
    lhs = tx.clone().requires_grad_()
    rhs = tw.clone().requires_grad_()
    out = GG.grouped_matmul(lhs, rhs, tgs)
    out.backward(tdy)
    for got, ref in ((out, want), (lhs.grad, wdx), (rhs.grad, wdw)):
        assert got.dtype == _TORCH[dtype]
        np.testing.assert_allclose(_np(got.detach()),
                                   np.asarray(ref.astype(jnp.float32)),
                                   **TOL[dtype])
    assert not _np(out.detach())[192:].any()         # rows past the groups
    assert not _np(rhs.grad)[1].any()                # the empty group


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_grads_match_autograd_of_plain(dtype):
    _, (tx, tw, tdy) = _data(dtype, 200, 24, 40, seed=2)
    tgs = torch.from_numpy(RAGGED)
    grads = []
    for fn in (GG.grouped_matmul, GG.gmm_ref):
        lhs = tx.clone().requires_grad_()
        rhs = tw.clone().requires_grad_()
        out = fn(lhs, rhs, tgs)
        out.backward(tdy)
        grads.append((out.detach(), lhs.grad, rhs.grad))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype == _TORCH[dtype]
        torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.parametrize("trained", ["lhs", "rhs", "both"])
def test_only_the_needed_gradients_are_computed(trained, monkeypatch):
    """A frozen weight gets no tgmm; an input that needs no gradient gets
    no dgrad (the Function's ``needs_input_grad``). Spies on the module's
    ``gmm`` / ``tgmm`` record which products the backward runs."""
    _, (tx, tw, tdy) = _data("float32", 200, 24, 40, seed=3)
    tgs = torch.from_numpy(RAGGED)
    calls = []
    gmm, tgmm = GG.gmm, GG.tgmm

    def spy_gmm(*a, transpose_rhs=False):
        calls.append("dgrad" if transpose_rhs else "fwd")
        return gmm(*a, transpose_rhs=transpose_rhs)

    def spy_tgmm(*a):
        calls.append("tgmm")
        return tgmm(*a)

    monkeypatch.setattr(GG, "gmm", spy_gmm)
    monkeypatch.setattr(GG, "tgmm", spy_tgmm)
    lhs = tx.clone().requires_grad_(trained in ("lhs", "both"))
    rhs = tw.clone().requires_grad_(trained in ("rhs", "both"))
    GG.grouped_matmul(lhs, rhs, tgs).backward(tdy)
    want = {"lhs": ["fwd", "dgrad"], "rhs": ["fwd", "tgmm"],
            "both": ["fwd", "dgrad", "tgmm"]}[trained]
    assert calls == want
    assert (lhs.grad is not None) == lhs.requires_grad
    assert (rhs.grad is not None) == rhs.requires_grad


def test_wrappers_refuse_what_the_kernels_do_not_take():
    _, (tx, tw, tdy) = _data("float32", 200, 24, 40, seed=4)
    tgs = torch.from_numpy(RAGGED)
    with pytest.raises(ValueError, match="unsupported device"):
        GG.gmm(tx.to("meta"), tw.to("meta"), tgs.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        GG.tgmm(tx.to("meta"), tdy.to("meta"), tgs.to("meta"))
    with pytest.raises(ValueError, match="want lhs"):
        GG.gmm(tx, tw.transpose(1, 2), tgs)
    with pytest.raises(ValueError, match="want lhs"):
        GG.tgmm(tx, tdy[:10], tgs)
    with pytest.raises(TypeError, match="cast the weights"):
        GG.grouped_matmul(tx, tw.bfloat16(), tgs)
