"""How far bf16 training lands from fp32, in JAX and in the port, over
several batch seeds: the witness behind the bf16 parity rule of the MoE
and ``seq`` / ``tensor`` cases (``LOW_VS_JAX`` times JAX's own distance).

Run from the repo root on the CPU (8 virtual JAX devices, gloo ranks)::

    python tests/torch_bf16_witness.py [--seeds 0,1,2,3] [--only NAME,...]
    python tests/torch_bf16_witness.py --flips [--seeds 0,1,2,3]

The first form prints, per configuration and seed, each run's distance
from JAX's fp32 run at the same mesh (the relative loss over 3 masked
steps, the master's largest and mean distance): JAX's bf16 run at the
mesh (``J16m``, absent where JAX's engine aborts there) and on one device
(``J16o``), the port's at the mesh (``P16m``) and in one process
(``P16o``), all from JAX's initial master. ``--flips`` prints, for the
port's dense ``tiny_moe`` in one process, how many kept (token, expert)
pairs of the gate differ between bf16 and fp32 in each step, and the
leaves with the largest master distance.

Not collected by pytest (no ``test_`` prefix); it imports both packages,
as the tests do.
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
import conftest  # noqa: E402,F401  (the 8 virtual JAX devices)
import numpy as np  # noqa: E402

from test_torch_expert_parallel import _jax_mesh, _spawn_start  # noqa: E402
from test_torch_pipeline import STEPS  # noqa: E402
from test_torch_seq_compose import _mask  # noqa: E402
from test_torch_zero import _engine_config, _leaves  # noqa: E402
from test_torch_zero3 import _precision  # noqa: E402

SEQ = 32
DENSE = {"moe_dispatch": "dense"}
# name → model, mesh, world, ZeRO stage, spec keywords, attention at the
# mesh, global rows, whether JAX's engine runs at the mesh
CONFIGS = {
    "e2s2_moe_dense": dict(model="tiny_moe", mesh={"expert": 2, "seq": 2},
                           world=4, stage=2, spec=DENSE,
                           attention="ulysses", rows=4, jax_mesh=True),
    "e2t2_dense": dict(model="tiny_moe", mesh={"expert": 2, "tensor": 2},
                       world=4, stage=2, spec=DENSE, attention=None, rows=4,
                       jax_mesh=True),
    "s2_llama": dict(model="tiny_llama", mesh={"seq": 2}, world=2, stage=1,
                     spec={"num_layers": 2}, attention="ulysses", rows=2,
                     jax_mesh=True),
    # JAX's ragged MoE engine aborts under tensor (ROADMAP queue C)
    "t2_ragged": dict(model="tiny_moe", mesh={"tensor": 2}, world=2,
                      stage=1, spec={}, attention=None, rows=2,
                      jax_mesh=False),
}


def batches(rows, seed):
    """Seed s's 2 × STEPS micro-batches (seed 0: the tests' batches)."""
    return [{"tokens": np.random.default_rng(1000 * seed + 100 + i).integers(
        0, 512, (rows, SEQ)).astype(np.int32),
        "loss_mask": _mask(rows, SEQ)} for i in range(2 * STEPS)]


def _layout(c, one):
    """(mesh, world, micro, attention) at the mesh or on one device."""
    if one:
        return {}, 1, c["rows"], None
    mesh = c["mesh"]
    batch = c["world"] // mesh.get("seq", 1) // mesh.get("tensor", 1)
    return mesh, c["world"], c["rows"] // batch, c["attention"]


def _spec_kw(c, dtype, attention):
    kw = dict(dtype=dtype, **c["spec"])
    if attention:
        kw["attention"] = attention
    return kw


def _config(c, mesh, micro, dtype):
    return _precision(dict(_engine_config({"stage": c["stage"]}),
                           mesh=dict(mesh),
                           train_micro_batch_size_per_gpu=micro), dtype)


def jax_run(c, seed, dtype, one):
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm import mesh as JM

    mesh, world, micro, attention = _layout(c, one)
    mm = _jax_mesh(mesh, world)
    engine, *_ = dst.initialize(
        model=dst.causal_lm_spec(c["model"], **_spec_kw(c, dtype,
                                                        attention)),
        config=_config(c, mesh, micro, dtype), mesh_manager=mm)
    master0 = jax.tree.map(np.asarray, engine.state["master"])
    data = iter(batches(c["rows"], seed))
    losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
    out = {"losses": losses, "master0": master0,
           "master": jax.tree.map(np.asarray, engine.state["master"])}
    del engine, mm
    JM.reset_mesh()
    return out


def port_run(c, seed, master0, one, dtype="bfloat16", remat="full"):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as PM
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    if one:
        PM.reset_mesh()
    mesh, _, micro, attention = _layout(c, one)
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(c["model"], remat=remat,
                                 **_spec_kw(c, dtype, attention)),
        config=_config(c, mesh, micro, dtype), device="cpu")
    load_master(engine, master0)
    data = iter(batches(c["rows"], seed))
    losses = [float(engine.train_batch(data)) for _ in range(STEPS)]
    out = {"losses": losses, "master": _copy(gather_master(engine))}
    engine.close()
    return out


def _copy(tree):
    """A tree of numpy copies (``gather_master`` may return views)."""
    return {k: _copy(v) if isinstance(v, dict) else np.array(v)
            for k, v in tree.items()}


def _world_rank(rank, world, jobs):
    import torch

    torch.set_num_threads(1)
    return {key: port_run(CONFIGS[key[0]], key[1], master0, False)
            for key, master0 in jobs.items()
            if CONFIGS[key[0]]["world"] == world}


def distance(ref, run):
    """(relative loss, master max, master mean) of ``run`` from ``ref``."""
    fp32 = dict(_leaves(ref["master"]))
    loss = np.max(np.abs(np.asarray(run["losses"]) - ref["losses"])
                  / np.abs(ref["losses"]))
    diff = np.concatenate([np.abs(v - fp32[k]).ravel()
                           for k, v in _leaves(run["master"])])
    return np.array([loss, diff.max(), diff.mean()])


def distances(names, seeds):
    """{(name, seed): {run: distance}} and the per-step losses."""
    from deepspeed_tpu.comm import comm as JC

    if not JC.is_initialized():
        JC.init_distributed(verbose=False)
    jax_runs = {}
    for name in names:
        c = CONFIGS[name]
        for s in seeds:
            r = {"32o": jax_run(c, s, "float32", True),
                 "16o": jax_run(c, s, "bfloat16", True)}
            if c["jax_mesh"]:
                r["32m"] = jax_run(c, s, "float32", False)
                r["16m"] = jax_run(c, s, "bfloat16", False)
            jax_runs[(name, s)] = r
    jobs = {k: r["32o"]["master0"] for k, r in jax_runs.items()}
    with tempfile.TemporaryDirectory() as tmp:
        collect = {}
        for w in sorted({CONFIGS[n]["world"] for n in names}):
            (Path(tmp) / f"w{w}").mkdir()
            collect[w] = _spawn_start(_world_rank, w, Path(tmp) / f"w{w}",
                                      jobs)
        one = {k: port_run(CONFIGS[k[0]], k[1], jobs[k], True)
               for k in jobs}
        mesh = {}
        for c in collect.values():
            mesh.update(c()[0])                  # rank 0's whole master
    out = {}
    for k, r in jax_runs.items():
        ref = r.get("32m", r["32o"])
        d = {"J16o": distance(r["32o"], r["16o"]),
             "P16o": distance(r["32o"], one[k]),
             "P16m": distance(ref, mesh[k])}
        if "16m" in r:
            d["J16m"] = distance(ref, r["16m"])
        losses = {run: v["losses"] for run, v in r.items()}
        losses.update(P16o=one[k]["losses"], P16m=mesh[k]["losses"])
        out[k] = (d, losses)
    return out


def flips(seeds):
    """The port's dense tiny_moe in one process, bf16 against fp32 from
    JAX's initial master (no remat, so each gate call is a forward's):
    per step, the kept (token, expert) pairs that differ in the gate's
    forwards; the three leaves furthest apart."""
    import torch

    from deepspeed_tpu_torch.moe import layer as L

    c = CONFIGS["e2s2_moe_dense"]
    master0 = jax_run(c, 0, "float32", True)["master0"]
    orig = L.topk_gating
    for s in seeds:
        kept = {}
        runs = {}
        for dtype in ("float32", "bfloat16"):
            seen = kept[dtype] = []

            def spy(*a, _seen=seen, **kw):
                g = orig(*a, **kw)
                if torch.is_grad_enabled():
                    _seen.append((g.combine.detach() > 0).any(-1).numpy())
                return g

            L.topk_gating = spy
            try:
                runs[dtype] = port_run(c, s, master0, True, dtype,
                                       remat="none")
            finally:
                L.topk_gating = orig
        f, b = kept["float32"], kept["bfloat16"]
        per = len(f) // STEPS
        differ = [int(sum((f[i] != b[i]).sum()
                          for i in range(k * per, (k + 1) * per)))
                  for k in range(STEPS)]
        fm, bm = runs["float32"]["master"], runs["bfloat16"]["master"]
        top = sorted(((float(np.abs(bm[k] - fm[k]).max()), k) for k in fm),
                     reverse=True)[:3]
        print(f"seed {s}: kept pairs differing a step {differ} of "
              f"{f[0].size * per}; furthest leaves "
              f"{[(k, float(f'{v:.3g}')) for v, k in top]}", flush=True)


def main():
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="0,1,2,3")
    p.add_argument("--only", default=",".join(CONFIGS))
    p.add_argument("--flips", action="store_true")
    args = p.parse_args()
    torch.set_num_threads(2)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.flips:
        return flips(seeds)
    for (name, s), (d, losses) in distances(args.only.split(","),
                                            seeds).items():
        print(name, s, {k: [float(f"{x:.3g}") for x in v]
                        for k, v in sorted(d.items())}, flush=True)
        print("   losses", {k: [round(x, 7) for x in v]
                            for k, v in sorted(losses.items())}, flush=True)


if __name__ == "__main__":
    main()
