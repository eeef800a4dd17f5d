"""Fused Adam of the PyTorch port against the JAX package.

``fused_adam_ref`` (the CUDA kernel's plain version) against the Pallas
``fused_adam_flat`` (interpret mode on the CPU), and the port's
``FusedAdam.update`` against the JAX engine's ``FusedAdam.update`` over 5
steps: Adam and AdamW, with and without weight decay and bias correction.
fp32 within 1e-6: the same operations; the one known difference is the
Pallas kernel's (1 - b1) computed in fp32 where the JAX engine's (and the
port's) is a Python double rounded once (2.4e-8 relative at b1 = 0.9). The
CUDA kernel runs only on a GPU; ``chip_smoke.py`` holds it against
``fused_adam_ref`` there.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import optimizer as JO
from deepspeed_tpu_torch.ops import fused_adam as PA
from deepspeed_tpu_torch.ops import optimizer as PO

JA = importlib.import_module("deepspeed_tpu.ops.pallas.fused_adam")
TOL = dict(rtol=1e-6, atol=1e-6)
BETAS = (0.9, 0.999)


def _state(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=n).astype(np.float32)
    g = (rng.normal(size=n) * 0.1).astype(np.float32)
    m = (rng.normal(size=n) * 0.01).astype(np.float32)
    v = np.abs(rng.normal(size=n) * 1e-3).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("adam_w", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.05])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_ref_matches_pallas_fused_adam_flat(adam_w, wd, bias_correction):
    n, step, lr = 5000, 3, 1e-3          # n not a multiple of the block
    p, g, m, v = _state(n, seed=int(adam_w) + 2 * int(wd > 0))
    jp, jm, jv = JA.fused_adam_flat(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v), lr,
        step, BETAS, 1e-8, wd, adam_w, bias_correction)
    tp, tm, tv = (torch.from_numpy(x.copy()) for x in (p, m, v))
    bc1, bc2 = PA.bias_corrections(step, BETAS, bias_correction)
    out = torch.empty(n, dtype=torch.bfloat16)
    before = dict(PA.launches)
    PA.fused_adam(tp, torch.from_numpy(g), tm, tv, lr, BETAS, 1e-8, wd, bc1,
                  bc2, adam_w=adam_w, out=out)
    assert PA.launches == before           # CPU: the plain version
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    torch.testing.assert_close(out, tp.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_update_matches_jax_fused_adam_over_five_steps(
        adam_w_mode, weight_decay, bias_correction):
    kw = dict(lr=1e-2, weight_decay=weight_decay, betas=BETAS, eps=1e-8,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    jopt, popt = JO.FusedAdam(**kw), PO.FusedAdam(**kw)
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (33,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    flat = torch.from_numpy(np.concatenate([params[k].ravel()
                                            for k in sorted(params)]))
    pstate = popt.init(flat)
    for step in range(5):
        grads = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
                 for k, s in shapes.items()}
        lr = 1e-2 * (step + 1) / 5               # a schedule's lr
        jparams, jstate = jopt.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams,
            lr=jnp.float32(lr))
        g = torch.from_numpy(np.concatenate([grads[k].ravel()
                                             for k in sorted(grads)]))
        popt.update(g, pstate, flat, lr=lr)
    assert pstate["step"] == int(jstate["step"]) == 5
    want = np.concatenate([np.asarray(jparams[k]).ravel()
                           for k in sorted(jparams)])
    np.testing.assert_allclose(flat.numpy(), want, **TOL)
    want_m = np.concatenate([np.asarray(jstate["exp_avg"][k]).ravel()
                             for k in sorted(jparams)])
    np.testing.assert_allclose(pstate["exp_avg"].numpy(), want_m, **TOL)


def test_bias_corrections_are_fp32_like_jax():
    for step in (1, 2, 10, 1000):
        sf = jnp.float32(step)
        want = (float(1.0 - 0.9 ** sf), float(1.0 - 0.999 ** sf))
        np.testing.assert_allclose(PA.bias_corrections(step, BETAS), want,
                                   rtol=2e-6)
    assert PA.bias_corrections(5, BETAS, False) == (1.0, 1.0)


def test_get_optimizer_names_and_refusals():
    opt = PO.get_optimizer("AdamW", {"lr": 3e-4, "betas": [0.8, 0.9],
                                     "torch_adam": True, "amsgrad": False})
    assert isinstance(opt, PO.FusedAdam) and opt.betas == (0.8, 0.9)
    assert opt.adam_w_mode is True
    j = JO.get_optimizer("adam", {"lr": 1e-3, "adam_w_mode": False})
    p = PO.get_optimizer("adam", {"lr": 1e-3, "adam_w_mode": False})
    assert (p.adam_w_mode, p.lr, p.eps) == (j.adam_w_mode, j.lr, j.eps)
    with pytest.raises(NotImplementedError, match="later slice"):
        PO.get_optimizer("lamb", {})
    with pytest.raises(ValueError, match="unknown optimizer"):
        PO.get_optimizer("nope", {})


@pytest.mark.parametrize("bad", ["dtype", "size", "noncontig", "out"])
def test_wrapper_checks_refuse_what_the_kernel_does_not_take(bad):
    p, g, m, v = (torch.from_numpy(x) for x in _state(64, seed=1))
    out = None
    if bad == "dtype":
        g = g.bfloat16()
    elif bad == "size":
        m = m[:32]
    elif bad == "noncontig":
        v = torch.stack([v, v], 1)[:, 0]
    else:
        out = torch.empty(64, dtype=torch.float16)
    with pytest.raises(ValueError):
        PA._check(p, g, m, v, out)


def _expression_adam(p, g, m, v, lr, betas, eps, wd, bc1, bc2, adam_w,
                     out):
    """The update as whole-tensor expressions, each operation rounded
    once: the oracle of the in-place plain version's bits."""
    b1, b2 = betas
    if not adam_w and wd:
        g = g + wd * p
    m.copy_(b1 * m + (1.0 - b1) * g)
    v.copy_(b2 * v + (1.0 - b2) * (g * g))
    upd = (m / torch.tensor(bc1)) / (torch.sqrt(v / torch.tensor(bc2)) + eps)
    if adam_w and wd:
        upd = upd + wd * p
    p.copy_(p - lr * upd)
    if out is not None:
        out.copy_(p)


@pytest.mark.parametrize("adam_w,wd", [(True, 0.0), (True, 0.01),
                                       (False, 0.01)])
@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16, torch.float32])
def test_cpu_chunks_are_the_plain_version_bit_for_bit(adam_w, wd, out_dtype):
    """Over a flat CPU buffer of several chunks (the host step's update)
    the wrapper's chunk-by-chunk calls give one whole-tensor
    ``fused_adam_ref``'s bits, and both the bits of the update written as
    whole-tensor expressions: p, m, v and the compute-dtype copy."""
    n = 2 * PA.CHUNK + 12345
    gen = torch.Generator().manual_seed(3)
    p, g = torch.randn(n, generator=gen), torch.randn(n, generator=gen)
    m = 0.1 * torch.randn(n, generator=gen)
    v = 0.01 * torch.rand(n, generator=gen)
    runs = [[t.clone() for t in (p, g, m, v)] for _ in range(3)]
    outs = [None if out_dtype is None else torch.empty(n, dtype=out_dtype)
            for _ in range(3)]
    args = (1e-3, (0.9, 0.999), 1e-8, wd, 0.1, 0.001, adam_w)
    for fn, run, out in zip((_expression_adam, PA.fused_adam_ref,
                             PA.fused_adam), runs, outs):
        fn(*run, *args, out)
    for run, out in zip(runs[1:], outs[1:]):
        for x, y in zip(runs[0], run):
            assert torch.equal(x, y)
        if out is not None:
            assert torch.equal(outs[0], out)
