"""RMSNorm / LayerNorm of the PyTorch port against the JAX package.

The port's plain versions (``deepspeed_tpu_torch/ops/norms.py``) are held
against the JAX model's ``_norm`` and the Pallas ``rms_norm`` /
``layer_norm`` (interpret mode on the CPU) on the same numpy inputs. The
Triton kernels run only on a GPU; ``chip_smoke.py`` holds them against the
plain versions there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops.pallas import norms as JN
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import norms

EPS = 1e-5
# fp32: same arithmetic, other reduction order. bf16: fp32 inside, one
# rounding of the output, so at most one bf16 ulp (2^-7 relative) apart.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-3)}


def _inputs(R, H, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, H)).astype(np.float32) * 3 + 0.5
    scale = (1 + 0.1 * rng.normal(size=(H,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(H,))).astype(np.float32)
    return x, scale, bias


def _both(a, dtype):
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a, getattr(jnp, dtype)))


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("R,H", [(1, 64), (37, 96), (300, 64)])
def test_plain_matches_jax_norm(kind, dtype, R, H):
    x, scale, bias = _inputs(R, H, seed=R + H)
    tx, jx = _both(x, dtype)
    ts, js = _both(scale, dtype)
    tb, jb = _both(bias, dtype)
    jp = {"scale": js, "bias": jb}
    want = JT._norm(jx, jp, kind, EPS)
    if kind == "rmsnorm":
        got = norms.rms_norm_ref(tx, ts, EPS)
        pallas = JN.rms_norm(jx, js, EPS)
    else:
        got = norms.layer_norm_ref(tx, ts, tb, EPS)
        pallas = JN.layer_norm(jx, js, jb, EPS)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    # the model's dispatcher: plain version on the CPU either way
    ported = PT._norm(tx, {"scale": ts, "bias": tb}, kind, EPS)
    torch.testing.assert_close(ported, got, rtol=0, atol=0)


def test_cpu_wrappers_run_plain_versions_without_launching():
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(5, 64, seed=3))
    before = dict(norms.launches)
    torch.testing.assert_close(norms.rms_norm(x, scale, EPS),
                               norms.rms_norm_ref(x, scale, EPS),
                               rtol=0, atol=0)
    torch.testing.assert_close(norms.layer_norm(x, scale, bias, EPS),
                               norms.layer_norm_ref(x, scale, bias, EPS),
                               rtol=0, atol=0)
    assert norms.launches == before


@pytest.mark.parametrize("bad, match", [
    ("dtype", "float32 or bfloat16"),
    ("noncontig", "contiguous"),
    ("scale_shape", "scale/bias"),
])
def test_wrapper_checks_refuse_what_the_kernel_does_not_take(bad, match):
    x, scale, _ = (torch.from_numpy(a) for a in _inputs(4, 64, seed=4))
    if bad == "dtype":
        x = x.half()
    elif bad == "noncontig":
        x = x.t()
    else:
        scale = scale[:32]
    with pytest.raises((ValueError, TypeError), match=match):
        norms._check("rms_norm", x, scale)



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("R,H", [(1, 64), (37, 96)])
def test_gradients_match_jax_vjp_of_pallas_norms(kind, dtype, R, H):
    """The norm autograd Functions' dx, dscale and dbias against ``jax.vjp``
    of the Pallas ``rms_norm`` / ``layer_norm`` (whose VJPs are the
    analytic ``_rms_bwd`` / ``_ln_bwd``), x of shape [2, R, H]."""
    import jax

    x, scale, bias = _inputs(2 * R, H, seed=R * H)
    x = x.reshape(2, R, H)
    g = np.random.default_rng(R).normal(size=x.shape).astype(np.float32)
    tx, jx = _both(x, dtype)
    ts, js = _both(scale, dtype)
    tb, jb = _both(bias, dtype)
    tg, jg = _both(g, dtype)
    for t in (tx, ts, tb):
        t.requires_grad_(True)
    if kind == "rmsnorm":
        jout, vjp = jax.vjp(lambda a, s: JN.rms_norm(a, s, EPS), jx, js)
        want = vjp(jg)
        out = norms.rms_norm(tx, ts, EPS)
        got_in = (tx, ts)
    else:
        jout, vjp = jax.vjp(lambda a, s, b: JN.layer_norm(a, s, b, EPS),
                            jx, js, jb)
        want = vjp(jg)
        out = norms.layer_norm(tx, ts, tb, EPS)
        got_in = (tx, ts, tb)
    out.backward(tg)
    np.testing.assert_allclose(_np(out.detach()), _np(jout), **TOL[dtype])
    # dscale/dbias sum 2R rows: fp32 sums in another order; in bf16 one
    # rounding of an O(R) sum
    tol = TOL[dtype] if dtype == "float32" else dict(rtol=2 ** -7, atol=2e-2)
    for t, w, name in zip(got_in, want, ("dx", "dscale", "dbias")):
        assert t.grad.dtype == t.dtype, name
        np.testing.assert_allclose(_np(t.grad), _np(w), err_msg=name, **tol)


def test_no_grad_and_inference_take_the_forward_only():
    x, scale, bias = (torch.from_numpy(a).requires_grad_()
                      for a in _inputs(5, 64, seed=6))
    with torch.no_grad():
        y = norms.rms_norm(x, scale, EPS)
    assert y.grad_fn is None
    y = norms.layer_norm(x, scale, bias, EPS)
    assert type(y.grad_fn).__name__ == "_LayerNormBackward"
