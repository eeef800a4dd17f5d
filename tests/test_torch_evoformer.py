"""Evoformer attention of the PyTorch port against the JAX package.

The plain forward (``evoformer_flash_ref``, which ``evoformer_flash`` runs
for CPU tensors) against the Pallas ``evoformer_flash`` (interpret mode on
the CPU) and against ``evoformer_attention(use_flash=False)``, fp32 at
2e-5; gradients (the backward differentiates ``_reference``, as JAX's
``jax.vjp``) including the bias gradient for a row-shared (Gb = 1) and a
per-row (Gb = G) bias, at 2e-4; the mask + pair bias combination and the
gate; the dispatch (rectangular shapes and head dims outside the kernel's
set take the plain path, ``use_flash=True`` raises JAX's ``ValueError``
there); a row-shared bias reaches the kernel path unexpanded; and
``msa_row_attention_with_pair_bias`` output and gradients. The CUDA kernel
runs only on a GPU; ``chip_smoke.py`` holds it against the plain version
there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import evoformer_attn as JEA
from deepspeed_tpu.ops.pallas import evoformer as JEV
from deepspeed_tpu_torch.ops import evoformer as EV
from deepspeed_tpu_torch.ops import evoformer_attn as EA

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _inputs(G=3, S=48, N=4, D=16, Gb=1, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(G, S, N, D)).astype(np.float32)
               for _ in range(3))
    bias = (0.5 * rng.normal(size=(Gb, N, S, S))).astype(np.float32)
    return q, k, v, bias


def _t(*xs, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad) for x in xs]


@pytest.mark.parametrize("Gb", [1, 3])
@pytest.mark.parametrize("D", [8, 16, 32])
def test_plain_forward_matches_pallas_kernel_and_xla_path(Gb, D):
    q, k, v, bias = _inputs(D=D, Gb=Gb, seed=D + Gb)
    jin = [jnp.asarray(x) for x in (q, k, v, bias)]
    want_kernel = np.asarray(JEV.evoformer_flash(*jin))
    want_xla = np.asarray(JEA.evoformer_attention(
        *jin[:3], biases=(jin[3],), use_flash=False))
    before = dict(EV.launches)
    got = EV.evoformer_flash(*_t(q, k, v, bias))
    assert EV.launches == before             # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want_kernel, **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), want_xla, **FWD_TOL)
    xla = EA.evoformer_attention(*_t(q, k, v), biases=(_t(bias)[0],),
                                 use_flash=False)
    np.testing.assert_allclose(xla.numpy(), want_xla, **FWD_TOL)


@pytest.mark.parametrize("Gb", [1, 3])
def test_gradients_match_jax_vjp(Gb):
    q, k, v, bias = _inputs(Gb=Gb, seed=5)
    do = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(JEV.evoformer_flash,
                     *(jnp.asarray(x) for x in (q, k, v, bias)))
    jgrads = vjp(jnp.asarray(do))
    tin = _t(q, k, v, bias, grad=True)
    EV.evoformer_flash(*tin).backward(torch.from_numpy(do))
    for t, want, name in zip(tin, jgrads, ("q", "k", "v", "bias")):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD_TOL)


def test_backward_skips_inputs_without_grad():
    q, k, v, bias = _inputs(seed=8)
    tq, tk, tv = _t(q, k, v, grad=True)
    tb = torch.from_numpy(bias)
    EV.evoformer_flash(tq, tk, tv, tb).sum().backward()
    assert tb.grad is None and tq.grad is not None


def test_bf16_forward_and_gradients():
    q, k, v, bias = _inputs(Gb=1, seed=9)
    do = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)
    jin = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    jout, vjp = jax.vjp(lambda a, b, c: JEV.evoformer_flash(
        a, b, c, jnp.asarray(bias)), *jin)
    jgrads = vjp(jnp.asarray(do, jnp.bfloat16))
    tin = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
    out = EV.evoformer_flash(*tin, torch.from_numpy(bias))
    out.backward(torch.from_numpy(do).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout, np.float32), **BF16_TOL)
    for t, want in zip(tin, jgrads):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(want, np.float32), **BF16_TOL)


def test_a_row_masked_everywhere_gives_zero():
    """bias -inf on every key of a row: o = acc / max(l, 1e-30) = 0, as the
    Pallas kernel gives (the softmax reference would give NaN)."""
    q, k, v, bias = _inputs(Gb=1, seed=12)
    bias[0, 1, 5, :] = -np.inf
    want = np.asarray(JEV.evoformer_flash(
        *(jnp.asarray(x) for x in (q, k, v, bias))))
    got = EV.evoformer_flash(*_t(q, k, v, bias)).numpy()
    assert (got[:, 5, 1] == 0).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("use_flash", [True, False, None])
def test_mask_plus_pair_bias_and_gate(use_flash):
    """[mask_bias, pair_bias] combine into one bias; the gate multiplies
    sigmoid(gate) after the attention."""
    G, S, N, D = 2, 32, 2, 8
    rng = np.random.default_rng(1)
    q, k, v, gate = (rng.normal(size=(G, S, N, D)).astype(np.float32)
                     for _ in range(4))
    mask_bias = np.where(rng.random((G, 1, 1, S)) < 0.9, 0.0,
                         -1e9).astype(np.float32)
    pair_bias = (0.3 * rng.normal(size=(1, N, S, S))).astype(np.float32)
    want = np.asarray(JEA.evoformer_attention(
        *(jnp.asarray(x) for x in (q, k, v)),
        biases=(jnp.asarray(mask_bias), jnp.asarray(pair_bias)),
        gate=jnp.asarray(gate), use_flash=use_flash))
    got = EA.evoformer_attention(*_t(q, k, v),
                                 biases=tuple(_t(mask_bias, pair_bias)),
                                 gate=_t(gate)[0], use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def _spy(monkeypatch):
    seen = []
    real = EA.evoformer_flash

    def spy(q, k, v, bias):
        seen.append(tuple(bias.shape))
        return real(q, k, v, bias)

    monkeypatch.setattr(EA, "evoformer_flash", spy)
    return seen


def test_shared_bias_not_expanded(monkeypatch):
    """A [1, N, S, S] row-shared bias reaches the kernel path at Gb = 1;
    a per-row mask bias makes it [G, N, S, S], as JAX broadcasts it."""
    seen = _spy(monkeypatch)
    q, k, v, bias = _inputs(Gb=1)
    EA.evoformer_attention(*_t(q, k, v), biases=(_t(bias)[0],),
                           use_flash=True)
    mask = torch.zeros(3, 1, 1, 48)
    EA.evoformer_attention(*_t(q, k, v), biases=(mask, _t(bias)[0]),
                           use_flash=True)
    assert seen == [(1, 4, 48, 48), (3, 4, 48, 48)]


@pytest.mark.parametrize("case", ["rectangular", "head_dim_12"])
def test_dispatch_outside_the_kernel_contract(monkeypatch, case):
    """Rectangular attention and a head dim outside the kernel's set take
    the plain path under use_flash=None, and raise JAX's ValueError under
    use_flash=True (JAX raises it for the rectangular case)."""
    rng = np.random.default_rng(2)
    if case == "rectangular":
        q = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
        k = v = rng.normal(size=(2, 24, 2, 8)).astype(np.float32)
    else:
        q = k = v = rng.normal(size=(2, 16, 2, 12)).astype(np.float32)
    seen = _spy(monkeypatch)
    want = np.asarray(JEA.evoformer_attention(
        *(jnp.asarray(x) for x in (q, k, v)), use_flash=False))
    for use_flash in (None, False):
        got = EA.evoformer_attention(*_t(q, k, v), use_flash=use_flash)
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    assert seen == []
    with pytest.raises(ValueError) as perr:
        EA.evoformer_attention(*_t(q, k, v), use_flash=True)
    assert "shapes do not fit the flash evoformer kernel" in str(perr.value)
    if case == "rectangular":
        with pytest.raises(ValueError) as jerr:
            JEA.evoformer_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                    use_flash=True)
        assert str(perr.value) == str(jerr.value)


def test_cpu_auto_takes_the_plain_path(monkeypatch):
    seen = _spy(monkeypatch)
    q, k, v, bias = _inputs()
    EA.evoformer_attention(*_t(q, k, v), biases=(_t(bias)[0],))
    assert seen == []


def test_kernel_wrapper_checks_refuse_what_the_kernel_does_not_take():
    """The CUDA path's checks, called directly (a CPU tensor never reaches
    them)."""
    q = torch.zeros(2, 16, 2, 8)
    with pytest.raises(ValueError, match=r"head dim 12; the kernel takes D "
                                         r"in \(8, 16, 32, 64, 128\)"):
        z = torch.zeros(2, 16, 2, 12)
        EV._check(z, z, z, torch.zeros(1, 2, 16, 16))
    with pytest.raises(ValueError, match="want bias"):
        EV._check(q, q, q, torch.zeros(3, 2, 16, 16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        EV._check(q.half(), q.half(), q.half(), torch.zeros(1, 2, 16, 16))
    with pytest.raises(ValueError, match="contiguous head dim"):
        t = q.transpose(-1, -2).contiguous().transpose(-1, -2)
        EV._check(t, q, q, torch.zeros(1, 2, 16, 16))


@pytest.mark.parametrize("use_flash", [True, None])
def test_msa_row_attention_with_pair_bias_matches_jax(use_flash):
    R, S, C, N = 4, 24, 32, 4
    rng = np.random.default_rng(3)
    msa = rng.normal(size=(R, S, C)).astype(np.float32)
    pair = rng.normal(size=(N, S, S)).astype(np.float32)
    ws = [(0.1 * rng.normal(size=(C, C))).astype(np.float32)
          for _ in range(5)]

    def jfn(m, p, *w):
        return jnp.sum(JEA.msa_row_attention_with_pair_bias(
            m, p, *w[:4], w_gate=w[4], num_heads=N) ** 2)

    jval, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(7)))(
        jnp.asarray(msa), jnp.asarray(pair), *(jnp.asarray(w) for w in ws))
    tin = _t(msa, pair, *ws, grad=True)
    out = EA.msa_row_attention_with_pair_bias(
        tin[0], tin[1], *tin[2:6], w_gate=tin[6], num_heads=N,
        use_flash=use_flash)
    val = (out ** 2).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=2e-5)
    names = ("msa", "pair_bias", "wq", "wk", "wv", "wo", "w_gate")
    for t, want, name in zip(tin, jgrads, names):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", ["extra_msa_d8", "unaligned_s40_d16",
                                  "unaligned_s40_d32_per_row"])
def test_plain_matches_pallas_kernel_at_small_contract_shapes(case):
    """chip_smoke's Evoformer edge cases cut small: the extra-MSA stack's
    D 8 under a shared pair bias plus a key mask of -1e9 (and one row of
    the batch -inf everywhere: its output is 0), and a sequence (40) that
    is no multiple of the kernels' 64-key tile, with shared and per-row
    biases. The plain version against the Pallas kernel (interpret) and,
    where no row is masked everywhere, the XLA path."""
    D, Gb, S = {"extra_msa_d8": (8, 1, 48), "unaligned_s40_d16": (16, 1, 40),
                "unaligned_s40_d32_per_row": (32, 3, 40)}[case]
    q, k, v, bias = _inputs(S=S, D=D, Gb=Gb, seed=D + S)
    if case == "extra_msa_d8":
        rng = np.random.default_rng(3)
        mask = np.where(rng.random((3, 1, 1, S)) < 0.9, 0.0,
                        -1e9).astype(np.float32)
        mask[0] = -np.inf
        bias = (mask + bias).astype(np.float32)
    jin = [jnp.asarray(x) for x in (q, k, v, bias)]
    got = EV.evoformer_flash(*_t(q, k, v, bias)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(JEV.evoformer_flash(*jin)), **FWD_TOL)
    if case == "extra_msa_d8":
        assert (got[0] == 0).all() and np.isfinite(got).all()
    else:
        want_xla = np.asarray(JEA.evoformer_attention(
            *jin[:3], biases=(jin[3],), use_flash=False))
        np.testing.assert_allclose(got, want_xla, **FWD_TOL)


@pytest.mark.parametrize("dtype, bias_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("Gb", ["1", "G"])
@pytest.mark.parametrize("D", [8, 16, 32, 64, 128])
def test_kernel_wrapper_checks_accept_the_kernel_contract(D, Gb, dtype,
                                                          bias_dtype):
    """D in {8, 16, 32, 64, 128}, a bias shared by the G rows (Gb 1) or one
    a row (Gb G), either bias dtype, and q/k/v read in place from a fused
    [G, S, 3, N, D] projection (strided, 16-byte aligned rows): the launch
    checks pass."""
    G, S, N = 3, 40, 2
    qkv = torch.zeros(G, S, 3, N, D, dtype=dtype)
    q, k, v = qkv.unbind(2)
    bias = torch.zeros(1 if Gb == "1" else G, N, S, S, dtype=bias_dtype)
    EV._check(q, k, v, bias)
    EV._check(q.contiguous(), k.contiguous(), v.contiguous(), bias)


@pytest.mark.parametrize("case, err, match", [
    ("head_dim_4", ValueError, "head dim 4"),
    ("head_dim_256", ValueError, "head dim 256"),
    ("bias_rows_2_of_3", ValueError, "want bias"),
    ("bias_not_square", ValueError, "want bias"),
    ("rectangular_k", ValueError, "of one shape"),
    ("mixed_qkv_dtypes", TypeError, "v is torch.bfloat16"),
    ("bias_float16", TypeError, "float32 or bfloat16"),
    ("row_stride_misaligned", ValueError, "16-byte aligned rows"),
])
def test_kernel_wrapper_checks_refuse_outside_the_contract(case, err, match):
    G, S, N, D = 3, 16, 2, 8
    q = torch.zeros(G, S, N, D)
    bias = torch.zeros(1, N, S, S)
    args = {
        "head_dim_4": lambda: [torch.zeros(G, S, N, 4)] * 3 + [bias],
        "head_dim_256": lambda: [torch.zeros(G, S, N, 256)] * 3 + [bias],
        "bias_rows_2_of_3": lambda: [q, q, q, torch.zeros(2, N, S, S)],
        "bias_not_square": lambda: [q, q, q, torch.zeros(1, N, S, S + 1)],
        "rectangular_k": lambda: [q, torch.zeros(G, S + 8, N, D), q, bias],
        "mixed_qkv_dtypes": lambda: [q, q, q.bfloat16(), bias],
        "bias_float16": lambda: [q, q, q, bias.half()],
        # q/k/v rows 9 floats apart (36 bytes)
        "row_stride_misaligned": lambda: [
            torch.zeros(G, S, N, 9)[..., :D]] * 3 + [bias],
    }[case]()
    with pytest.raises(err, match=match):
        EV._check(*args)
