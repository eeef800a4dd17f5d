"""Paged attention of the PyTorch port against the JAX package.

The port's plain version (``deepspeed_tpu_torch/ops/paged_attention.py``)
is held against the JAX ``paged_attention_reference`` and the Pallas kernel
in interpret mode on the same numpy inputs. The CUDA kernels run only on a
GPU; ``chip_smoke.py`` holds them against the plain version there. Here,
on ``chip_smoke.paged_tick``'s adversarial ticks: the plan that assigns
rows to the two kernels (a cover of every row, runs of equal tables only),
and a plain emulation of what the kernels compute (per plan tile, per
split, with the (m, l, acc) merge) against JAX.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.models import paged as JPG
from deepspeed_tpu.ops.pallas.paged_attention import paged_attention as pallas_pa
from deepspeed_tpu_torch.ops import paged_attention as PA

import chip_smoke as C

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


# (kind, bs, MB): chip_smoke's ticks at a small pool (block 4, 16 blocks a
# table: 64 slots), and prefill runs of 1, 16 (the least run the prefill
# kernel takes), 63, 64 and 65 rows
TICKS = [(k, 4, 16) for k in ("mixed", "gqa", "shared_prefix", "interleaved",
                              "ragged", "long", "run1", "run16", "run63",
                              "run64", "run65")]


def _tick(kind, bs, MB, rep, seed=0, N=8, D=32):
    tables, lengths, NB = C.paged_tick(kind, bs, MB, seed=seed)
    rng = np.random.default_rng(seed + 1)
    N = N if N % rep == 0 else 2 * rep
    K = N // rep
    q = rng.normal(size=(len(lengths), N, D)).astype(np.float32)
    kpool = rng.normal(size=(NB, bs, K, D)).astype(np.float32)
    vpool = rng.normal(size=(NB, bs, K, D)).astype(np.float32)
    return q, kpool, vpool, tables, lengths


@pytest.mark.parametrize("kind, bs, MB", TICKS)
def test_plan_covers_every_row_once_with_runs_of_equal_tables(kind, bs, MB):
    tables, lengths, _ = C.paged_tick(kind, bs, MB)
    T = len(lengths)
    plan = PA.build_plan(torch.from_numpy(tables))
    dec = plan.dec_rows[:int(plan.n_dec[0])].tolist()
    assert dec == sorted(dec)
    covered = list(dec)
    n_tiles = int(plan.n_tiles[0])
    assert n_tiles <= PA.tile_slots(T) == plan.tile_start.shape[0]
    for x in range(n_tiles):
        t0, n = int(plan.tile_start[x]), int(plan.tile_rows[x])
        assert 1 <= n <= PA.TILE_ROWS
        assert (tables[t0:t0 + n] == tables[t0]).all()   # one table row
        covered += range(t0, t0 + n)
    assert sorted(covered) == list(range(T))              # each row once
    pre = np.zeros(T, bool)
    pre[[r for r in covered if r not in set(dec)]] = True
    np.testing.assert_array_equal(pre, C.prefill_rows(tables, PA.MIN_RUN))


@pytest.mark.parametrize("rep", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("kind", ["mixed", "gqa", "long", "run63", "run64",
                                  "run65"])
def test_prefill_blocks_cover_each_plan_row_once(kind, rep):
    """The prefill kernel's grid over the plan's tiles (x a tile, z a block
    of ``prefill_blocks(rep)[0]`` rows) takes every prefill row once and
    nothing past its tile, at reps that do and do not divide 64."""
    tables, _, _ = C.paged_tick(kind, 4, 16)
    plan = PA.build_plan(torch.from_numpy(tables))
    per, blocks = PA.prefill_blocks(rep)
    taken = []
    for x in range(int(plan.n_tiles[0])):
        t0, n = int(plan.tile_start[x]), int(plan.tile_rows[x])
        for z in range(blocks):
            taken += range(t0 + z * per, t0 + min(n, (z + 1) * per))
    pre = np.flatnonzero(C.prefill_rows(tables, PA.MIN_RUN)).tolist()
    assert sorted(taken) == pre


def test_plan_of_a_tick_with_both_regimes():
    """mixed: 3 decode rows, chunks of 40 and 20 rows (a tile each), 6 pad
    rows (a run too short for the prefill kernel)."""
    tables, _, _ = C.paged_tick("mixed", 4, 16)
    plan = PA.build_plan(torch.from_numpy(tables))
    assert plan.dec_rows[:int(plan.n_dec[0])].tolist() == [0, 1, 2] + list(
        range(63, 69))
    assert int(plan.n_tiles[0]) == 2
    assert plan.tile_start[:2].tolist() == [3, 43]
    assert plan.tile_rows[:2].tolist() == [40, 20]


@pytest.mark.parametrize("rep", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("kind, bs, MB", TICKS)
def test_kernel_emulation_matches_jax_reference(kind, bs, MB, rep):
    """Per plan tile, per prefill block of the kernel's grid, and per split
    with the (m, l, acc) merge, in fp32: the split-and-merge algebra, the
    plan's exactness (a tile reads its first row's table) and the blocks'
    cover of every tile row (a row no block takes stays NaN) against the
    JAX reference at 1e-5. Rep 3 and 6 leave a tile's last block short."""
    args = _tick(kind, bs, MB, rep)
    targs = _torch(*args)
    got = PA.paged_attention_emulated(*targs, PA.build_plan(targs[3]))
    want = np.asarray(JPG.paged_attention_reference(
        *[jnp.asarray(a) for a in args]))
    live = args[-1] > 0     # the JAX reference averages V on an empty row
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=0,
                               atol=ATOL)
    assert np.all(got.numpy()[~live] == 0)


@pytest.mark.parametrize("kind, rep", [("mixed", 2), ("ragged", 1),
                                       ("shared_prefix", 8)])
def test_kernel_emulation_matches_pallas_kernel(kind, rep):
    args = _tick(kind, 4, 8, rep, seed=3)
    targs = _torch(*args)
    got = PA.paged_attention_emulated(*targs, PA.build_plan(targs[3]))
    want = np.asarray(pallas_pa(*[jnp.asarray(a) for a in args],
                                interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind, bs, MB", TICKS[:6])
def test_plan_on_the_cpu_leaves_the_plain_output(kind, bs, MB):
    targs = _torch(*_tick(kind, bs, MB, 2, seed=4))
    plan = PA.build_plan(targs[3])
    before = dict(PA.launches)
    got = PA.paged_attention(*targs, plan=plan)
    assert torch.equal(got, PA.paged_attention_reference(*targs))
    assert PA.launches == before


@pytest.mark.parametrize("bad", ["rows", "dtype", "size"])
def test_plan_check_refuses_a_plan_of_other_tables(bad):
    tables = torch.from_numpy(C.paged_tick("mixed", 4, 16)[0])
    plan = PA.build_plan(tables)
    T = tables.shape[0]
    PA._check_plan(plan, T, tables.device)
    if bad == "rows":
        T += 1
    elif bad == "dtype":
        plan = PA.PagedPlan(plan.buf.long(), T)
    else:
        plan = PA.PagedPlan(plan.buf[:-1], T)
    with pytest.raises(ValueError, match="plan"):
        PA._check_plan(plan, T, tables.device)


@pytest.mark.parametrize("rep", range(1, 9))
def test_prefill_blocks_cover_a_tile(rep):
    rows, blocks = PA.prefill_blocks(rep)
    assert rows * rep <= PA.TILE_ROWS               # the kernel's 64 M rows
    assert (blocks - 1) * rows < PA.TILE_ROWS <= blocks * rows


@pytest.mark.parametrize("dtype, T, want", [
    (torch.bfloat16, PA.MIN_RUN, True),
    (torch.bfloat16, PA.MIN_RUN - 1, False), (torch.float32, 256, False)])
def test_uses_plan_only_where_a_run_may_exist(dtype, T, want):
    assert PA.uses_plan(dtype, T) is want


@pytest.mark.parametrize("rep", [3, 6])
@pytest.mark.parametrize("kind", ["run64", "run65", "gqa"])
def test_kernel_emulation_matches_pallas_kernel_at_reps_not_dividing_a_tile(
        kind, rep):
    args = _tick(kind, 4, 16, rep, seed=5)
    targs = _torch(*args)
    got = PA.paged_attention_emulated(*targs, PA.build_plan(targs[3]))
    want = np.asarray(pallas_pa(*[jnp.asarray(a) for a in args],
                                interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
