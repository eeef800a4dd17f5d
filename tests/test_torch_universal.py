"""Universal checkpoints between the PyTorch port and the JAX package.

The format string is ``deepspeed_tpu_universal/2`` in both packages: one
directory an fp32 master leaf with its moments and LoCo's per-rank rows,
a manifest, a ``COMMITTED`` marker with every atom's CRC32.

* Engine B (JAX, ``data = 2``, ZeRO-2, qgZ + LoCo, tiny, fp32) trains 2
  steps, saves (orbax, its default writer), converts the tag with JAX's
  ``convert_to_universal`` and trains step 3. The port loads that
  universal dir:

  - at world 2 (gloo CPU ranks), ZeRO-2 and ZeRO-3 on the same wire: its
    step 3 (loss, master, LoCo rows) within ``test_torch_zero.TOL["int8"]``
    of B's;
  - at world 1: bit-equal to a port engine given the same master and
    moments directly (``load_master`` and the moments' buffers), each LoCo
    leaf's rows folded sum-preservingly (``repartition_rank_rows``, the
    port's against JAX's on the same array).

* The port's world-2 run (B's initial master, 2 steps) saves natively and
  converts with the port's ``convert_to_universal``; B loads that dir with
  its ``load_universal_checkpoint`` (no new compile): master and LoCo rows
  bit-equal to the port's. A universal dir converted at world 1 loads at
  world 2 (the rows grow zero-filled, sum-preserving), and into B: a dir
  without LoCo rows loads in both packages.
* A corrupt atom raises ``CheckpointCorruptError`` naming it; ``reshard``
  converts and its ``--dry-run`` names its later slice; ``zero_to_fp32``
  reads the native layout.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_zero import TOL, _engine_config, _leaves, _spawn

SEQ, WORLD = 32, 2
ZERO = {"stage": 2, "zero_quantized_gradients": True,
        "loco_error_feedback": True}
PORT_ZERO = {"zero2": ZERO, "zero3": dict(ZERO, stage=3)}


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny models on one intra-op thread: beside the suite's other
    workers a multi-threaded pool only oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(rows, skip_steps=0):
    from deepspeed_tpu_torch.runtime.dataloader import synthetic_lm_data

    data = synthetic_lm_data(rows, SEQ, 512, seed=3)
    for _ in range(2 * skip_steps):            # gas 2
        next(data)
    return data


@pytest.fixture(scope="module")
def jax_b(tmp_path_factory):
    """Engine B: 2 steps, an orbax save, JAX's conversion, step 3."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.checkpoint.universal import convert_to_universal
    from deepspeed_tpu.comm.mesh import MeshConfig, initialize_mesh
    from deepspeed_tpu.runtime.dataloader import synthetic_lm_data

    root = tmp_path_factory.mktemp("universal_b")
    mm = initialize_mesh(MeshConfig(data=WORLD),
                         devices=jax.devices()[:WORLD])
    engine, *_ = dst.initialize(model=dst.causal_lm_spec("tiny",
                                                         dtype="float32"),
                                config=_engine_config(ZERO), mesh_manager=mm)
    assert engine._wire_format() == "qz+loco"
    master0 = jax.tree.map(np.asarray, engine.state["master"])
    data = synthetic_lm_data(WORLD, SEQ, 512, seed=3)
    losses = [float(engine.train_batch(data)) for _ in range(2)]
    engine.save_checkpoint(str(root / "native"))
    convert_to_universal(str(root / "native"), str(root / "uni"))
    losses.append(float(engine.train_batch(data)))
    out = {"engine": engine, "root": root, "master0": master0,
           "losses": losses,
           "master3": jax.tree.map(np.asarray, engine.state["master"]),
           "loco3": jax.tree.map(np.asarray, engine.state["loco_err"])}
    path = root / "b.pkl"
    path.write_bytes(pickle.dumps({k: v for k, v in out.items()
                                   if k != "engine"}))
    out["pickle"] = path
    return out


def _universal_rank(rank, world, b_path, root, uni1):
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.checkpoint.universal import convert_to_universal
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    b = pickle.loads(open(b_path, "rb").read())
    spec = dtt.causal_lm_spec("tiny", dtype="float32")
    out = {}
    for name, zero in PORT_ZERO.items():
        engine, *_ = dtt.initialize(model=spec, config=_engine_config(zero),
                                    device="cpu")
        engine.load_universal_checkpoint(str(b["root"] / "uni"))
        steps = engine.global_steps
        loss = float(engine.train_batch(_data(world, skip_steps=2)))
        out[name] = {"type": type(engine).__name__, "steps": steps,
                     "loss": loss, "master": gather_master(engine),
                     "loco": dict(_leaves(engine.full_loco_err()))}
        engine.close()
    # the port's own world-2 run from B's initial master, converted
    engine, *_ = dtt.initialize(model=spec, config=_engine_config(ZERO),
                                device="cpu")
    load_master(engine, b["master0"])
    data = _data(world)
    for _ in range(2):
        engine.train_batch(data)
    engine.save_checkpoint(os.path.join(root, "native"))
    if rank == 0:
        convert_to_universal(os.path.join(root, "native"),
                             os.path.join(root, "uni"))
    comm.barrier()
    out["own"] = {"master": gather_master(engine),
                  "loco": dict(_leaves(engine.full_loco_err()))}
    engine.close()
    # a dir converted at world 1 (no LoCo rows) loads here too
    engine, *_ = dtt.initialize(model=spec, config=_engine_config(ZERO),
                                device="cpu")
    engine.load_universal_checkpoint(uni1)
    out["from_world1"] = {"master": gather_master(engine),
                          "loco_sum": float(engine.loco_err.abs().sum()),
                          "steps": engine.global_steps}
    engine.close()
    return out


def _world1_engine(zero=None):
    import deepspeed_tpu_torch as dtt

    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec("tiny", dtype="float32"),
        config=dict(_engine_config(zero or {"stage": 1}),
                    train_micro_batch_size_per_gpu=WORLD), device="cpu")
    return engine


@pytest.fixture(scope="module")
def port_runs(jax_b, tmp_path_factory):
    """The world-1 dir for the ranks, then the world-2 spawn."""
    from deepspeed_tpu_torch.checkpoint.universal import convert_to_universal

    root = tmp_path_factory.mktemp("universal_port")
    one = _world1_engine()
    from deepspeed_tpu_torch.models.convert import load_master

    load_master(one, jax_b["master0"])
    data = _data(WORLD)
    for _ in range(2):
        one.train_batch(data)
    one.save_checkpoint(str(root / "native1"))
    convert_to_universal(str(root / "native1"), str(root / "uni1"))
    want1 = {k: v for k, v in _leaves(one.get_fp32_params())}
    ranks = _spawn(_universal_rank, WORLD, root, jax_b["pickle"],
                   str(root / "ranks"), str(root / "uni1"))
    return {"root": root, "ranks": ranks, "want1": want1}


def test_world2_loads_jax_universal_within_int8_tol(jax_b, port_runs):
    tol = TOL["int8"]
    want = dict(_leaves(jax_b["master3"]))
    werr = dict(_leaves(jax_b["loco3"]))
    for name in PORT_ZERO:
        got = port_runs["ranks"][0][name]
        assert got["type"] == ("Zero3Engine" if name == "zero3"
                               else "DataParallelEngine")
        assert got["steps"] == 2
        assert port_runs["ranks"][1][name]["loss"] == got["loss"]
        np.testing.assert_allclose(got["loss"], jax_b["losses"][2],
                                   rtol=tol["loss"], atol=0, err_msg=name)
        mine = dict(_leaves(got["master"]))
        assert sorted(mine) == sorted(want)
        diff = np.concatenate([np.abs(mine[k] - want[k]).ravel()
                               for k in want])
        assert diff.max() <= tol["master"], (name, diff.max())
        assert diff.mean() <= tol["master_mean"], (name, diff.mean())
        ediff = np.concatenate([np.abs(got["loco"][k] - werr[k]).ravel()
                                for k in werr])
        assert ediff.max() <= tol["err"], (name, ediff.max())
        assert ediff.mean() <= tol["err_mean"], (name, ediff.mean())


def test_jax_loads_the_port_universal_dir(jax_b, port_runs):
    import jax

    engine = jax_b["engine"]
    engine.load_universal_checkpoint(str(port_runs["root"] / "ranks" /
                                         "uni"))
    assert engine.global_steps == 2
    own = port_runs["ranks"][0]["own"]
    got = dict(_leaves(jax.tree.map(np.asarray, engine.state["master"])))
    for key, v in _leaves(own["master"]):
        assert np.array_equal(got[key], v), key
    err = dict(_leaves(jax.tree.map(np.asarray, engine.state["loco_err"])))
    assert sorted(err) == sorted(own["loco"])
    for key, v in own["loco"].items():
        assert np.array_equal(err[key], v), key


def test_world1_universal_dir_loads_at_world2(port_runs):
    for r in port_runs["ranks"]:
        got = r["from_world1"]
        assert got["steps"] == 2 and got["loco_sum"] == 0.0
        mine = dict(_leaves(got["master"]))
        for key, v in port_runs["want1"].items():
            assert np.array_equal(mine[key], v), key


def test_jax_loads_a_universal_dir_without_loco_rows(jax_b, port_runs):
    """The dir converted at world 1 holds no LoCo rows: JAX's LoCo engine B
    loads it all the same (its ``load_universal_into_engine`` keeps the
    live rows), with the dir's master, as the port's world-2 LoCo engines
    do (``test_world1_universal_dir_loads_at_world2``)."""
    import jax

    engine = jax_b["engine"]
    engine.load_universal_checkpoint(str(port_runs["root"] / "uni1"))
    assert engine.global_steps == 2
    got = dict(_leaves(jax.tree.map(np.asarray, engine.state["master"])))
    for key, v in port_runs["want1"].items():
        assert np.array_equal(got[key], v), key


def test_world1_load_is_bit_equal_to_direct_state(jax_b):
    """B's universal dir at world 1: the same step as an engine given the
    same master and moments directly; LoCo's rows fold sum-preservingly,
    the port's fold equal to JAX's."""
    from deepspeed_tpu.checkpoint import universal as JU

    from deepspeed_tpu_torch.checkpoint import universal as PU
    from deepspeed_tpu_torch.models.convert import load_master

    uni = str(jax_b["root"] / "uni")
    manifest = PU.read_manifest(uni)
    assert manifest["format"] == "deepspeed_tpu_universal/2"
    assert manifest["rank_state"]["loco_err"]["world"] == WORLD
    loaded = _world1_engine()
    loaded.load_universal_checkpoint(uni)
    direct = _world1_engine()
    tree = {}
    for p in manifest["params"]:
        node = tree
        keys = p.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = PU.load_atom(uni, p)
    load_master(direct, tree)
    for slot in direct._slots:
        p = "/".join(slot.path)
        for m in manifest["optimizer_moments"]:
            direct._view(direct.state["opt"][m], slot).copy_(
                torch.from_numpy(PU.load_atom(uni, p, m)))
        rows = PU.load_atom(uni, p, "loco_err")
        folded = PU.repartition_rank_rows(rows, 1)
        assert np.array_equal(folded, JU.repartition_rank_rows(rows, 1))
        np.testing.assert_allclose(folded[0], rows.sum(0), rtol=0, atol=0)
        for w in (3, 4):
            grown = PU.repartition_rank_rows(rows, w)
            assert np.array_equal(grown, JU.repartition_rank_rows(rows, w))
            np.testing.assert_allclose(grown.sum(0), rows.sum(0),
                                       rtol=1e-6, atol=1e-7)
    direct.state["opt"]["step"] = manifest["optimizer_scalars"]["step"]
    direct.state["step"] = manifest["step"]
    direct.global_steps, direct.micro_steps = 2, 4
    assert loaded.global_steps == 2 and loaded.micro_steps == 4
    assert torch.equal(loaded.flat_master, direct.flat_master)
    losses = []
    for engine in (loaded, direct):
        data = _data(WORLD, skip_steps=2)
        losses.append([float(engine.train_batch(data)) for _ in range(2)])
    assert losses[0] == losses[1]
    assert torch.equal(loaded.flat_master, direct.flat_master)


def test_corrupt_atom_reshard_and_zero_to_fp32(port_runs, tmp_path):
    from deepspeed_tpu_torch.checkpoint import CheckpointCorruptError
    from deepspeed_tpu_torch.checkpoint import reshard_cli, zero_to_fp32

    root = port_runs["root"]
    out = tmp_path / "resharded"
    assert reshard_cli.main([str(root / "native1"), str(out)]) == 0
    assert (out / "COMMITTED").is_file()
    with pytest.raises(NotImplementedError, match="later slice"):
        reshard_cli.main([str(root / "native1"), "--dry-run"])
    assert reshard_cli.main([str(tmp_path / "missing"), str(out)]) == 2
    flat = zero_to_fp32.get_fp32_state_dict_from_checkpoint(
        str(root / "native1"))
    for key, v in port_runs["want1"].items():
        assert np.array_equal(flat[key[1:]], v), key
    atom = out / "zero" / "tok_emb" / "fp32.npy"
    data = bytearray(atom.read_bytes())
    data[-1] ^= 0xFF
    atom.write_bytes(bytes(data))
    engine = _world1_engine()
    with pytest.raises(CheckpointCorruptError, match="zero/tok_emb/fp32.npy"):
        engine.load_universal_checkpoint(str(out))
    assert reshard_cli.main([str(root / "native1"), str(out)]) == 0
