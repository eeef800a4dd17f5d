"""Paged attention of the PyTorch port against the JAX package.

The port's plain version (``deepspeed_tpu_torch/ops/paged_attention.py``)
is held against the JAX ``paged_attention_reference`` and the Pallas kernel
in interpret mode on the same numpy inputs. The CUDA kernel itself runs
only on a GPU; ``chip_smoke.py`` holds it against the plain version there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.models import paged as JPG
from deepspeed_tpu.ops.pallas.paged_attention import paged_attention as pallas_pa
from deepspeed_tpu_torch.ops import paged_attention as PA

ATOL = 1e-5       # fp32: same arithmetic, other summation order


def _inputs(rep, seed=0, N=8, D=32, bs=8, MB=4):
    """Ragged lengths (1, a block edge, a partial block, the full table),
    a zero-table pad row of length 1 and an empty row of length 0."""
    rng = np.random.default_rng(seed)
    K = N // rep
    lengths = np.array([1, bs, bs + 3, 2 * bs - 1, MB * bs, 1, 0], np.int32)
    Tn = len(lengths)
    NB = 5 * MB + 1
    q = rng.normal(size=(Tn, N, D)).astype(np.float32)
    kpool = rng.normal(size=(NB, bs, K, D)).astype(np.float32)
    vpool = rng.normal(size=(NB, bs, K, D)).astype(np.float32)
    tables = np.zeros((Tn, MB), np.int32)
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    for t in range(5):                     # rows 5, 6 keep all-zero tables
        tables[t] = perm[t * MB:(t + 1) * MB]
    return q, kpool, vpool, tables, lengths


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_plain_matches_jax_reference(rep):
    args = _inputs(rep)
    got = PA.paged_attention_reference(*_torch(*args)).numpy()
    want = np.asarray(JPG.paged_attention_reference(
        *[jnp.asarray(a) for a in args]))
    live = args[-1] > 0     # the JAX reference averages V on an empty row
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=ATOL)


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_plain_matches_pallas_kernel(rep):
    args = _inputs(rep, seed=1)
    got = PA.paged_attention_reference(*_torch(*args)).numpy()
    want = np.asarray(pallas_pa(*[jnp.asarray(a) for a in args],
                                interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.all(got[args[-1] == 0] == 0)     # empty row → 0 (l_safe)


def test_bf16_plain_matches_pallas_kernel():
    """bf16 in, bf16 out, fp32 inside: at most one bf16 ulp apart."""
    args = _inputs(2, seed=2)
    q, kp, vp = (torch.from_numpy(a).bfloat16() for a in args[:3])
    got = PA.paged_attention_reference(q, kp, vp, *_torch(*args[3:]))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in args[:3])
    want = np.asarray(pallas_pa(jq, jk, jv, jnp.asarray(args[3]),
                                jnp.asarray(args[4]), interpret=True),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-3)


def test_cpu_wrapper_runs_plain_version_without_launching():
    args = _torch(*_inputs(4, seed=3))
    before = dict(PA.launches)
    got = PA.paged_attention(*args)
    torch.testing.assert_close(got, PA.paged_attention_reference(*args),
                               rtol=0, atol=0)
    assert PA.launches == before


@pytest.mark.parametrize("bad, match", [
    ("head_dim", "head dim"),
    ("rep", "kv heads"),
    ("dtype", "float32/bfloat16"),
    ("tables_dtype", "int32"),
    ("noncontig", "contiguous"),
])
def test_wrapper_checks_refuse_what_the_kernel_does_not_take(bad, match):
    q, kp, vp, tables, lengths = _torch(*_inputs(1, D=64))
    if bad == "head_dim":
        q, kp, vp = q[..., :32].contiguous(), kp[..., :32].contiguous(), \
            vp[..., :32].contiguous()
    elif bad == "rep":
        q = torch.cat([q] * 16, dim=1)                     # N/K = 16 > 8
    elif bad == "dtype":
        q, kp, vp = q.half(), kp.half(), vp.half()
    elif bad == "tables_dtype":
        tables = tables.long()
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((ValueError, TypeError), match=match):
        PA._check(q, kp, vp, tables, lengths)
