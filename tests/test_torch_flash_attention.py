"""Flash attention of the PyTorch port against the JAX package.

The plain versions (``flash_fwd_ref`` / ``flash_bwd_ref``) against the
Pallas ``_fwd`` / ``_bwd`` (interpret mode on the CPU, on the padded
[B*heads, S_pad, D] layout the Pallas wrapper builds), and the public
``flash_attention``'s forward and ``torch.autograd`` gradients against
``jax.vjp`` of the JAX ``flash_attention``; causal and full, aligned and
unaligned S, GQA rep 2. Tolerances are the JAX package's own tests': fp32
forward 2e-5, gradients 5e-4, bf16 3e-2. The CUDA kernels run only on a GPU;
``chip_smoke.py`` holds them against the plain versions there.
"""
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu_torch.ops import flash_attention as PF

# the module (the package re-exports its function under the same name)
JF = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _qkv(B, S, N, K, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, n, D)).astype(dtype) for n in (N, K, K)]


def _to_bn(x, block):
    """[B, S, H, D] → the Pallas wrapper's padded [B*H, S_pad, D]."""
    b, s, h, d = x.shape
    x = jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, d)
    return JF._pad_seq(x, block)


def _from_bn(x, B, S, H):
    x = np.asarray(x)[:, :S]
    return x.reshape(B, H, S, -1).transpose(0, 2, 1, 3)


CASES = [  # (S, N, K, causal)
    (64, 4, 4, True), (64, 4, 4, False), (96, 4, 2, True),
    (96, 4, 2, False), (128, 4, 2, True)]


@pytest.mark.parametrize("S,N,K,causal", CASES)
def test_refs_match_pallas_fwd_and_bwd(S, N, K, causal):
    B, D = 2, 64
    q, k, v = _qkv(B, S, N, K, D, seed=S + N + K + causal)
    block = JF._round_pow2(S)
    scale = 1.0 / math.sqrt(D)
    jq, jk, jv = (_to_bn(x, block) for x in (q, k, v))
    jo, jlse = JF._fwd(jq, jk, jv, scale=scale, causal=causal, kv_len=S,
                       rep=N // K, block_q=block, block_kv=block,
                       interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = PF.flash_fwd_ref(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), _from_bn(jo, B, S, N), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :S, 0],
                               **FWD_TOL)

    do = np.random.default_rng(7).normal(size=(B, S, N, D)).astype(np.float32)
    jdq, jdk, jdv = JF._bwd(scale, causal, S, S, N // K, block, block,
                            (jq, jk, jv, jo, jlse), _to_bn(do, block))
    dq, dk, dv = PF.flash_bwd_ref(tq, tk, tv, o, lse, torch.from_numpy(do),
                                  causal)
    np.testing.assert_allclose(dq.numpy(), _from_bn(jdq, B, S, N), **GRAD_TOL)
    np.testing.assert_allclose(dk.numpy(), _from_bn(jdk, B, S, K), **GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), _from_bn(jdv, B, S, K), **GRAD_TOL)


@pytest.mark.parametrize("S,N,K,causal", CASES)
def test_flash_attention_and_autograd_match_jax_vjp(S, N, K, causal):
    B, D = 2, 64
    q, k, v = _qkv(B, S, N, K, D, seed=11 + S)
    do = np.random.default_rng(5).normal(size=(B, S, N, D)).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, b, c: JF.flash_attention(a, b, c, causal),
                        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = dict(PF.launches)
    out = PF.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(do))
    assert PF.launches == before             # CPU: plain versions only
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD_TOL)


def test_bf16_forward_and_gradients():
    B, S, N, K, D = 1, 96, 4, 2, 64
    q, k, v = _qkv(B, S, N, K, D, seed=3)
    do = np.random.default_rng(4).normal(size=(B, S, N, D)).astype(np.float32)
    jin = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    jout, vjp = jax.vjp(lambda a, b, c: JF.flash_attention(a, b, c, True),
                        *jin)
    jgrads = vjp(jnp.asarray(do, jnp.bfloat16))
    tin = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
    out = PF.flash_attention(*tin, causal=True)
    out.backward(torch.from_numpy(do).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout, np.float32), **BF16_TOL)
    for t, want in zip(tin, jgrads):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(want, np.float32), **BF16_TOL)


def test_segment_mask_goes_to_the_plain_attention():
    from deepspeed_tpu.models.transformer import dot_product_attention as jdpa

    B, S, N, D = 2, 16, 2, 64
    q, k, v = _qkv(B, S, N, N, D, seed=9)
    seg = np.random.default_rng(1).random((B, S, S)) > 0.3
    seg[:, np.arange(S), np.arange(S)] = True
    want = jdpa(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                segment_mask=jnp.asarray(seg))
    got = PF.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=True, segment_mask=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("bad, match", [
    ("dtype", "float32 or bfloat16"),
    ("head_dim", "head dim"),
    ("gqa", "do not match"),
    ("mixed", "is torch.bfloat16"),
    ("strides", "contiguous head dim"),
    ("rank", r"want q \[B, S, N, D\]"),
])
def test_wrapper_checks_refuse_what_the_kernels_do_not_take(bad, match):
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 4, 2, 64, seed=0))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
    elif bad == "gqa":
        q = q[:, :, :3]
    elif bad == "mixed":
        k = k.bfloat16()
    elif bad == "strides":
        q = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    else:
        q = q[0]
    with pytest.raises((ValueError, TypeError), match=match):
        PF._check(q, k, v)


def test_flash_attention_refuses_heads_that_do_not_group():
    k = v = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="not divisible"):
        PF.flash_attention(torch.zeros(1, 8, 3, 64), k, v)
