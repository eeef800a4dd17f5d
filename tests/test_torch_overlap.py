"""The overlap scheduler's step phase on the exact stage 1-2 wire, the PyTorch
port against the JAX package.

Counterparts of the JAX package's ``tests/unit/test_overlap.py`` (bucketed
gradient sync equal to the unbucketed step) and ``test_step_overlap.py``
(the bucketed update and its publish bit-equal to the serial step, the
plan's flags). A file of its own, so that xdist's ``--dist loadfile`` runs
its spawned ranks beside the other data-parallel files; it reuses
``test_torch_zero``'s helpers.

* The plan: the port's reduce units (one a layer chunk, the other leaves
  in ``reduce_bucket_size`` buckets) and update buckets equal JAX's
  ``plan_buckets`` on the same leaf sizes; ``overlap_plan()`` equals JAX's
  key by key (``step_overlap``, ``param_buffer``, ``grad_sync_points``,
  ``update_bucket_elems`` included).
* Exact stages 1 and 2 at world 2 with ``overlap_comm`` and
  ``overlap_step`` (tiny, fp32: two layer chunks at
  ``allgather_bucket_size`` 20,000 against 49,984 elements a layer, small
  reduce and update buckets) against JAX's bucketed engine at
  ``data = 2``, with and without a ``loss_mask`` whose token counts differ
  by rank: losses and master within ``TOL["exact"]``.
* The same run against the port's unhooked reduce (``overlap_comm`` off:
  one unit after the backward) within the same tolerance, and against
  ``overlap_step`` off: losses and master bit-equal (the update and
  publish buckets are elementwise).
* The reduces and publishes a step equal their formula: chunks + buckets
  reduces a step whatever gas (the earlier micro-batches sum locally),
  each issued by its leaves' gradient hooks during the last
  micro-batch's backward, and one publish an update bucket.
"""
import pickle

import numpy as np
import pytest

from test_torch_zero import (
    SEQ,
    STEPS,
    TOL,
    WORLD,
    _engine_config,
    _leaves,
    _masked_batches,
    _spawn,
)

BUCKETS = {"allgather_bucket_size": 20000, "reduce_bucket_size": 30000,
           "update_bucket_size": 60000}
CASES = {"stage1": dict(BUCKETS, stage=1), "stage2": dict(BUCKETS, stage=2)}
MASKED = {f"{k}_masked": v for k, v in CASES.items()}
# the port's own variants of each case: the once-a-step reduce and the
# serial update
VARIANTS = {"once": {"overlap_comm": False}, "serial": {"overlap_step": False}}
GAS = _engine_config({})["gradient_accumulation_steps"]


def _batches(name, world):
    from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

    if name.endswith("_masked"):
        return iter(_masked_batches(world))
    return synthetic_lm_data(world, SEQ, 512, seed=3)


@pytest.fixture(scope="module")
def overlap_runs(tmp_path_factory):
    """JAX at data = 2 for every case (initial master, losses, final
    master, plan); then one spawn of the port's world-2 ranks for every
    case and variant. → (jax runs, [rank results])."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh
    from deepspeed_tpu.runtime.dataloader import synthetic_lm_data

    runs = {}
    for name, zero in {**CASES, **MASKED}.items():
        spec = dst.causal_lm_spec("tiny", dtype="float32")
        mm = initialize_mesh(MeshConfig(data=WORLD),
                             devices=jax.devices()[:WORLD])
        engine, *_ = dst.initialize(model=spec, config=_engine_config(zero),
                                    mesh_manager=mm)
        master0 = jax.tree.map(np.asarray, engine.state["master"])
        data = (iter(_masked_batches(WORLD)) if name in MASKED
                else synthetic_lm_data(WORLD, SEQ, 512, seed=3))
        losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
        runs[name] = {"master0": master0, "losses": losses,
                      "master": jax.tree.map(np.asarray,
                                             engine.state["master"]),
                      "plan": engine.overlap_plan()}
    tmp = tmp_path_factory.mktemp("overlap")
    path = tmp / "runs.pkl"
    path.write_bytes(pickle.dumps(runs))
    return runs, _spawn(_overlap_rank, WORLD, tmp, str(path))


def _overlap_rank(rank, world, runs_path):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    runs = pickle.loads(open(runs_path, "rb").read())
    out = {}
    todo = [(n, z, n) for n, z in {**CASES, **MASKED}.items()]
    todo += [(f"{n}/{v}", dict(z, **extra), n) for n, z in CASES.items()
             for v, extra in VARIANTS.items()]
    for key, zero, base in todo:
        spec = dtt.causal_lm_spec("tiny", dtype="float32")
        engine, *_ = dtt.initialize(model=spec, config=_engine_config(zero),
                                    device="cpu")
        load_master(engine, runs[base]["master0"])
        data = _batches(base, world)
        losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
        res = {"losses": losses, "master": gather_master(engine),
               "plan": engine.overlap_plan(),
               "counts": dict(engine.reduce_counts),
               "hooked": engine._grad_hooks}
        if key == base:
            res["units"] = [(u.kind, sorted(p.path for p in u.group.pieces),
                             u.group.layers) for u in engine._units]
            res["update_buckets"] = [sorted(sh.slot.path for sh in b.shards)
                                     for b in engine._update_buckets()]
            res["leaves"] = [(sh.slot.path, sh.slot.shape)
                             for sh in engine._shards]
        engine.close()
        out[key] = res
    return out


def _close(got, want, name):
    tol = TOL["exact"]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=tol["loss"], atol=0, err_msg=name)
    mine, theirs = dict(_leaves(got["master"])), dict(_leaves(want["master"]))
    assert sorted(mine) == sorted(theirs)
    diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                           for k in theirs])
    assert diff.max() <= tol["master"], (name, diff.max())
    assert diff.mean() <= tol["master_mean"], (name, diff.mean())


@pytest.mark.parametrize("name", list(CASES) + list(MASKED))
def test_bucketed_exact_wire_matches_jax(overlap_runs, name):
    runs, ranks = overlap_runs
    got = ranks[0][name]
    assert got["hooked"]
    assert ranks[1][name]["losses"] == got["losses"]
    _close(got, runs[name], name)
    assert got["plan"] == runs[name]["plan"]
    assert got["plan"]["step_overlap"] and got["plan"]["param_buffer"]


@pytest.mark.parametrize("name", list(CASES))
def test_once_a_step_reduce_gives_the_same_values(overlap_runs, name):
    """``overlap_comm`` off: one reduce of the whole gas-summed gradient
    after the backward; the same terms, cut into other units."""
    _, ranks = overlap_runs
    once = ranks[0][f"{name}/once"]
    assert not once["hooked"]
    assert once["counts"] == {"chunk": 0, "bucket": 1, "late": 1,
                              "publish": 0}
    _close(once, ranks[0][name], f"{name}/once")


@pytest.mark.parametrize("name", list(CASES))
def test_update_and_publish_buckets_are_bit_equal(overlap_runs, name):
    _, ranks = overlap_runs
    got, serial = ranks[0][name], ranks[0][f"{name}/serial"]
    assert not serial["plan"]["step_overlap"]
    assert got["losses"] == serial["losses"]
    for (k, a), (_, b) in zip(_leaves(got["master"]),
                              _leaves(serial["master"])):
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_units_and_buckets_follow_jax_plan(overlap_runs, name):
    """The reduce units: one a layer chunk of the plan, then JAX's
    ``plan_buckets`` over the other leaves' sizes; the update buckets:
    ``plan_buckets`` over every leaf; the counts a step."""
    from deepspeed_tpu.parallel.overlap import plan_buckets

    runs, ranks = overlap_runs
    got = ranks[0][name]
    bounds = [tuple(b) for b in runs[name]["plan"]["chunk_bounds"]]
    leaves = got["leaves"]
    chunks = [u for u in got["units"] if u[0] == "chunk"]
    assert [u[2] for u in chunks] == bounds
    chunked = set(chunks[0][1]) if chunks else set()
    head = [(p, s) for p, s in leaves if p not in chunked]
    want = plan_buckets([int(np.prod(s)) for _, s in head],
                        BUCKETS["reduce_bucket_size"])
    buckets = [u[1] for u in got["units"] if u[0] == "bucket"]
    assert buckets == [sorted(head[i][0] for i in b) for b in want]
    want_upd = plan_buckets([int(np.prod(s)) for _, s in leaves],
                            BUCKETS["update_bucket_size"])
    assert got["update_buckets"] == [sorted(leaves[i][0] for i in b)
                                     for b in want_upd]
    assert len(want_upd) > 1 and len(buckets) > 1
    # once a step: the earlier micro-batches sum locally
    assert GAS > 1
    assert got["counts"]["chunk"] == len(chunks)
    assert got["counts"]["bucket"] == len(buckets)
    assert got["counts"]["publish"] == len(want_upd)
    # every unit went out from its leaves' hooks, during the last backward
    assert got["counts"]["late"] == 0
