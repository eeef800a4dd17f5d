"""The port's compiled host Adam (``ops/cpu_adam.py`` over
``csrc/cpu_adam.cpp``) against its plain version and the JAX package.

The host-executed step's update: ``grad_prep`` (g / gas in place and the
global norm's sum of squares from fixed-block partials) and ``adam`` (the
clip factor, then Adam / AdamW, p, m, v in place and the bf16 copy).

* Against ``fused_adam_ref`` (the plain version): m, v and the bf16 copy
  bit-equal; p bit-equal on at least 0.999 of the elements, and different
  only where PyTorch's CPU ``sqrt`` is not correctly rounded (one ulp of
  the denominator moves u, and p's rounding with it).
  Against numpy's fp32 operations with a correctly rounded ``sqrt``, the
  library is bit-equal everywhere.
* Against JAX's ``FusedAdam.update`` jitted on the CPU over five steps,
  within ``tests/test_torch_fused_adam.py``'s 1e-6.
* The norm from the partials against JAX's ``global_grad_norm`` within
  1e-6 relative, and the same bits at 1, 3 and all threads.
* Adam with L2 and AdamW, with and without weight decay and bias
  correction, sizes off the vector width and the norm block.
* The refusals: misaligned, strided and non-fp32 inputs raise
  ``ValueError``; a source that does not compile and a missing compiler
  raise ``KernelBuildError``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import optimizer as JO
from deepspeed_tpu.runtime.loss_scaler import global_grad_norm as j_norm
from deepspeed_tpu_torch.ops import build, cpu_adam
from deepspeed_tpu_torch.ops import fused_adam as FA
from deepspeed_tpu_torch.ops import optimizer as PO

TOL = dict(rtol=1e-6, atol=1e-6)
BETAS = (0.9, 0.999)
EPS = 1e-8
# 1,048,576 + 37: one whole norm block and a tail off the vector width
SIZES = (1, 15, 4099, (1 << 20) + 37)


def _state(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=n).astype(np.float32)
    g = (rng.normal(size=n) * 0.1).astype(np.float32)
    m = (rng.normal(size=n) * 0.01).astype(np.float32)
    v = np.abs(rng.normal(size=n) * 1e-3).astype(np.float32)
    return p, g, m, v


def _numpy_adam(p, g, m, v, lr, wd, bc1, bc2, adam_w, clip):
    """The update in numpy fp32, one rounded operation at a time, with a
    correctly rounded sqrt."""
    f = np.float32
    g = g * f(clip) if clip is not None else g.copy()
    if not adam_w and wd:
        g = g + f(wd) * p
    m = f(BETAS[0]) * m + g * f(1.0 - BETAS[0])
    v = f(BETAS[1]) * v + (g * g) * f(1.0 - BETAS[1])
    u = (m / f(bc1)) / (np.sqrt(v / f(bc2)) + f(EPS))
    if adam_w and wd:
        u = u + p * f(wd)
    return p - u * f(lr), m, v, u


def _run(n, seed, wd, adam_w, bias_correction, clip, threads, step=3):
    p, g, m, v = (torch.from_numpy(x) for x in _state(n, seed))
    bc1, bc2 = FA.bias_corrections(step, BETAS, bias_correction)
    out = torch.empty(n, dtype=torch.bfloat16)
    cpu_adam.adam(p, g, m, v, 1e-3, BETAS, EPS, wd, bc1, bc2, adam_w,
                  out=out, clip=clip, threads=threads)
    return p, m, v, out, (bc1, bc2)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("adam_w, wd", [(True, 0.0), (True, 0.05),
                                        (False, 0.05)])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_adam_matches_the_plain_version(n, adam_w, wd, bias_correction):
    clip = 0.75
    p, m, v, out, (bc1, bc2) = _run(n, n, wd, adam_w, bias_correction, clip,
                                    None)
    rp, rg, rm, rv = (torch.from_numpy(x) for x in _state(n, n))
    rout = torch.empty(n, dtype=torch.bfloat16)
    rg = rg * torch.tensor(clip, dtype=torch.float32)
    FA.fused_adam_ref(rp, rg, rm, rv, 1e-3, BETAS, EPS, wd, bc1, bc2,
                      adam_w, rout)
    assert torch.equal(m, rm) and torch.equal(v, rv)
    differ = p != rp
    assert differ.float().mean() <= 1e-3
    # p differs only where PyTorch's sqrt of v / bc2 is off the correctly
    # rounded one
    q = rv / torch.tensor(bc2, dtype=torch.float32)
    off = torch.sqrt(q) != torch.sqrt(q.double()).float()
    assert not (differ & ~off).any()
    assert torch.equal(out, p.bfloat16())
    assert (out != rout).float().mean() <= 1e-3
    want = _numpy_adam(*_state(n, n), 1e-3, wd, bc1, bc2, adam_w, clip)
    for got, w in zip((p, m, v), want):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("n", SIZES[2:])
def test_thread_counts_give_the_same_bits(n):
    import os

    results = []
    for threads in (1, 3, os.cpu_count() or 1):
        g = torch.from_numpy(_state(n, 7)[1] * 8)
        total, partials = cpu_adam.grad_prep(g, 4.0, threads=threads)
        results.append((total, partials, g,
                        *_run(n, 7, 0.05, True, True, 0.5, threads)[:4]))
    first = results[0]
    for r in results[1:]:
        assert r[0] == first[0]
        np.testing.assert_array_equal(r[1], first[1])
        for a, b in zip(r[2:], first[2:]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", SIZES)
def test_grad_prep_divides_and_matches_jax_norm(n):
    raw = _state(n, 11)[1] * 8
    g = torch.from_numpy(raw.copy())
    total, partials = cpu_adam.grad_prep(g, 4.0)
    np.testing.assert_array_equal(g.numpy(), raw / np.float32(4.0))
    assert partials.shape == (-(-n // cpu_adam.norm_block()),)
    norm = cpu_adam.global_norm(total)
    want = float(j_norm({"g": jnp.asarray(raw) / jnp.float32(4.0)}))
    np.testing.assert_allclose(float(norm), want, rtol=1e-6)


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_host_update_matches_jax_fused_adam_over_five_steps(
        adam_w_mode, weight_decay, bias_correction):
    kw = dict(lr=1e-2, weight_decay=weight_decay, betas=BETAS, eps=EPS,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    jopt, popt = JO.FusedAdam(**kw), PO.FusedAdam(**kw)
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (33,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    update = jax.jit(lambda g, s, p, lr: jopt.update(g, s, p, lr=lr),
                     backend="cpu")
    flat = torch.from_numpy(np.concatenate([params[k].ravel()
                                            for k in sorted(params)]))
    pstate = popt.init(flat)
    out = torch.empty(flat.numel(), dtype=torch.bfloat16)
    for step in range(5):
        grads = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
                 for k, s in shapes.items()}
        lr = 1e-2 * (step + 1) / 5
        jparams, jstate = update({k: jnp.asarray(v)
                                  for k, v in grads.items()}, jstate,
                                 jparams, jnp.float32(lr))
        g = torch.from_numpy(np.concatenate([grads[k].ravel()
                                             for k in sorted(grads)]))
        popt.host_update(g, pstate, flat, lr=lr, out=out, threads=2)
    assert pstate["step"] == int(jstate["step"]) == 5
    for got, tree in ((flat, jparams), (pstate["exp_avg"], jstate["exp_avg"]),
                      (pstate["exp_avg_sq"], jstate["exp_avg_sq"])):
        want = np.concatenate([np.asarray(tree[k]).ravel()
                               for k in sorted(tree)])
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(out, flat.bfloat16())


@pytest.mark.parametrize("bad", ["dtype", "size", "strided", "misaligned",
                                 "out", "device"])
def test_refusals(bad):
    p, g, m, v = (torch.from_numpy(x) for x in _state(64, 1))
    out = None
    if bad == "dtype":
        g = g.double()
    elif bad == "size":
        m = m[:32]
    elif bad == "strided":
        v = torch.stack([v, v], 1)[:, 0]
    elif bad == "misaligned":
        p = torch.zeros(65)[1:]
    elif bad == "out":
        out = torch.empty(64, dtype=torch.float16)
    else:
        g = g.to("meta")
    with pytest.raises(ValueError, match="cpu_adam"):
        cpu_adam.adam(p, g, m, v, 1e-3, BETAS, EPS, 0.0, 1.0, 1.0, out=out)
    if bad in ("dtype", "strided", "misaligned"):
        with pytest.raises(ValueError, match="cpu_adam"):
            cpu_adam.grad_prep({"dtype": g, "strided": v,
                                "misaligned": p}[bad], 2.0)


def test_failed_build_and_missing_compiler_raise(tmp_path, monkeypatch):
    """A source that does not compile, and ``CXX`` naming a compiler that
    is not there, raise ``KernelBuildError``; nothing falls back."""
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(cpu_adam, "_lib", None)
    monkeypatch.setenv("DSTPU_TORCH_BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(build.KernelBuildError, match="not found"):
        cpu_adam.norm_block()
    monkeypatch.delenv("CXX")
    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "cpu_adam.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", broken)
    with pytest.raises(build.KernelBuildError, match="g\\+\\+ failed"):
        cpu_adam.norm_block()
