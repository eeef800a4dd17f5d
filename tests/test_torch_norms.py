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

