"""Pipeline parallelism of the PyTorch port (the ``pipe`` mesh axis)
against the JAX package.

Ranks run as spawned gloo processes on one intra-op thread
(``test_torch_expert_parallel._spawn_start``), one spawn a world: 2, 4
and 8 ranks. JAX runs the same meshes on the conftest's 8 CPU devices: its
engines in the test process, its function-level references, its resume of
the port's ``{pipe: 2}`` tag and its rebuilt spec in a process of its own
(the ranks never wait on JAX's engines but for their initial master).

* ``microbatch`` and ``stage_perm`` as JAX's; JAX's ``ValueError``.
* ``pipelined_apply`` (loss and gradients), ``pipelined_infer`` and
  ``pipelined_train_1f1b`` on JAX's toy stage functions
  (``tests/unit/test_pipeline.py:21-93``) at P = 2 and 4, M = P and 2P,
  against JAX's at ``{pipe: P}`` within ``ATOL``; each stage sends M
  activations and M cotangents (P − 1 hops, not JAX's cyclic P).
* ``pipelined_lm_loss`` and its gradients (GPipe), ``pipelined_lm_loss_and_
  grads`` (1F1B) and ``pipelined_lm_logits`` of ``tiny`` (tied
  embeddings) and ``tiny_llama`` (masked, M = 4) at ``{pipe: 2}`` against
  JAX's, and 1F1B's gradients against GPipe's (JAX's
  ``test_grads_match_gpipe_autodiff``).
* The engines: 3 masked steps from JAX's initial master against JAX's
  engine at the same mesh by ``test_torch_zero.TOL["exact"]`` (losses
  equal on every rank, grad norms, the whole master): ``{pipe: 2}`` at
  ZeRO 0, 1 and 2 with both schedules, ``{pipe: 2, data: 2}`` with a loss
  mask whose counts differ across pipeline micro-batches (JAX's mean of
  micro-batch means, not the global token mean), ``{pipe: 2, tensor: 2}``,
  ``{pipe: 2, data: 2, tensor: 2}`` ZeRO-2, JAX's ``{pipe: 4, data: 2}``
  and ``{pipe: 2, data: 4}`` (``tests/unit/test_pipeline.py:144-169,
  247-275``), a ``tiny_moe`` at ``{pipe: 2}``; one bf16 case within
  ``LOW_VS_JAX`` of JAX's own bf16 run.
* Refusals: a spec other than ``causal_lm_spec``'s (what
  ``_check_pipe_axis`` names), and what the seq and tensor checks refuse
  beside ``pipe``, raise naming A.4 (the compositions JAX runs are
  ``test_torch_pipe_compose.py``'s); the int8 wire warns and runs exact;
  ``host_step`` raises JAX's error; ``num_layers % P`` raises JAX's
  ``ValueError``.
* Checkpoints across pipe sizes: a ``{pipe: 2}`` tag loads into one
  process and into ``{pipe: 2, data: 2}`` bit-equal, a one-process tag
  into ``{pipe: 2}``; JAX resumes the ``{pipe: 2}`` tag to the port's next
  loss, and its universal conversion loads into both packages.
* JAX's ``_rebuild`` drops ``pipeline_micro_batches`` (a spec rebuilt for
  ``activation_checkpointing.policy`` falls back to M = P); the port's
  keeps it (ROADMAP queue C).
* The ``pipeline`` config section parses alike in both packages.

jax is imported inside the fixtures and tests, never at the top: a
spawned rank imports this module to find its function.
"""
import os
import pickle
import time

import numpy as np
import pytest

from test_torch_expert_parallel import _jax_mesh, _spawn_start
from test_torch_tensor_parallel import _flat, _np_params
from test_torch_zero import TOL, _engine_config, _leaves
from test_torch_zero3 import LOW_VS_JAX, _precision

SEQ = 32
STEPS = 3
ATOL = 2e-5
# toy schedules: (P, M)
TOYS = ((2, 2), (2, 4), (4, 4), (4, 8))
# the transformer's functions at {pipe: 2}: (model, M, masked)
FNS = (("tiny", 2, False), ("tiny_llama", 4, True))
# name → (world, mesh, zero, model, port schedule, dtype, micro a data
# rank, M, layers)
CASES = {
    "p2_zero0_gpipe": (2, {"pipe": 2}, {"stage": 0}, "tiny", "gpipe",
                       "float32", 2, None, 2),
    "p2_zero0_1f1b": (2, {"pipe": 2}, {"stage": 0}, "tiny", "1f1b",
                      "float32", 2, None, 2),
    "p2_zero1_gpipe": (2, {"pipe": 2}, {"stage": 1}, "tiny_llama", "gpipe",
                       "float32", 2, None, 2),
    "p2_zero1_1f1b": (2, {"pipe": 2}, {"stage": 1}, "tiny_llama", "1f1b",
                      "float32", 2, None, 2),
    "p2_zero2_gpipe": (2, {"pipe": 2}, {"stage": 2}, "tiny_llama", "gpipe",
                       "float32", 4, 4, 2),
    "p2_zero2_1f1b": (2, {"pipe": 2}, {"stage": 2}, "tiny_llama", "1f1b",
                      "float32", 4, 4, 2),
    "p2_zero1_1f1b_bf16": (2, {"pipe": 2}, {"stage": 1}, "tiny_llama",
                           "1f1b", "bfloat16", 2, None, 2),
    "p2_moe": (2, {"pipe": 2}, {"stage": 1}, "tiny_moe", "1f1b", "float32",
               2, None, 2),
    "p2d2_zero1_uneven": (4, {"pipe": 2, "data": 2}, {"stage": 1},
                          "tiny_llama", "1f1b", "float32", 2, None, 2),
    "p2t2_zero1": (4, {"pipe": 2, "tensor": 2}, {"stage": 1}, "tiny_llama",
                   "1f1b", "float32", 2, None, 2),
    "p2d2t2_zero2": (8, {"pipe": 2, "data": 2, "tensor": 2}, {"stage": 2},
                     "tiny_llama", "1f1b", "float32", 2, None, 2),
    "p4d2_zero1": (8, {"pipe": 4, "data": 2}, {"stage": 1}, "tiny", "gpipe",
                   "float32", 4, None, 4),
    "p2d4_zero1": (8, {"pipe": 2, "data": 4}, {"stage": 1}, "tiny", "1f1b",
                   "float32", 4, None, 2),
}
BF16 = {"p2_zero1_1f1b_bf16": "p2_zero1_1f1b"}
# the port cases each JAX engine (its default schedule, 1F1B) stands for
JAX_OF = {"p2_zero0_gpipe": "p2_zero0_1f1b",
          "p2_zero1_gpipe": "p2_zero1_1f1b",
          "p2_zero2_gpipe": "p2_zero2_1f1b"}
# the {pipe: 2} tag: saved by CKPT's ranks, loaded into ONE process and
# into {pipe: 2, data: 2}
CKPT = "p2_zero1_1f1b"
# what a pipe axis does not compose with yet (queue A.4): name → (world,
# mesh, extra config, model, spec keywords, what the error names). The
# compositions JAX runs under pipe are tests/test_torch_pipe_compose.py's
# parity cases; what stays refused is another spec, and what the seq and
# tensor axes refuse beside pipe
REFUSED = {
    "tensor_zenflow": (4, {"pipe": 2, "tensor": 2}, {"zero_optimization": {
        "stage": 1, "zenflow": {"enabled": True}}}, "tiny_llama", {},
        "mesh tensor=2 with ZenFlow"),
    "other_spec": (2, {"pipe": 2}, {}, None, {},
                   "a model spec other than causal_lm_spec's"),
}
WORLDS = (2, 4, 8)
# a process's wait for a file another process writes (a JAX master, a
# tag): the writer shares the machine with every rank of the three worlds
# and, under xdist, with the other workers
WAIT_S = 600


def _wait(path, what):
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"no {what} in {WAIT_S} s"
        time.sleep(0.05)


def _jax_order():
    """The JAX engines in the order the ranks need their initial masters:
    each world's next case in turn, so that no world's ranks wait for
    every other world's engines."""
    need = {w: [] for w in WORLDS}
    for name, case in CASES.items():
        src = JAX_OF.get(name, name)
        if src not in need[case[0]]:
            need[case[0]].append(src)
    return [need[w][k] for k in range(max(map(len, need.values())))
            for w in WORLDS if k < len(need[w])]


def _tokens(rows, seed):
    return np.random.default_rng(seed).integers(
        0, 512, (rows, SEQ)).astype(np.int32)


def _uneven_mask(rows):
    """A loss mask whose valid-token counts differ row by row: row r keeps
    every (r % 4 + 1)-th position, and the last row of four none past the
    first quarter; so every pipeline micro-batch (and every data rank's
    part of it) holds a count of its own."""
    mask = np.zeros((rows, SEQ), np.float32)
    for r in range(rows):
        mask[r, ::r % 4 + 1] = 1.0
        if r % 4 == 3:
            mask[r, SEQ // 4:] = 0.0
    return mask


def _batches(rows, n):
    return [{"tokens": _tokens(rows, 100 + i), "loss_mask": _uneven_mask(
        rows)} for i in range(n)]


def _spec_kw(name):
    *_, model, sched, dtype, _, M, layers = CASES[name]
    return dict(dtype=dtype, num_layers=layers, pipeline_schedule=sched,
                pipeline_micro_batches=M)


def _case_config(name):
    _, mesh, zero, *_, dtype, micro, _, _ = CASES[name]
    cfg = dict(_engine_config(zero), mesh=mesh,
               train_micro_batch_size_per_gpu=micro)
    return _precision(cfg, dtype)


def _rows(name):
    _, mesh, *_, micro, _, _ = CASES[name]
    return micro * mesh.get("data", 1)


# --------------------------------------------------------------------------- #
# the toy stage functions (JAX's TestPipelinedApply._toy, numpy inputs)
# --------------------------------------------------------------------------- #

def _toy_inputs(M, L=4, H=8, b=2):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, H, H)) * 0.3).astype(np.float32)
    out_w = rng.standard_normal(H).astype(np.float32)
    xm = rng.standard_normal((M, b, H)).astype(np.float32)
    return w, out_w, xm


def _jax_toy(P, M):
    """JAX's three schedules on the toy at ``{pipe: P}``: GPipe's loss and
    gradients, the forward-only outputs, 1F1B's loss and gradients (the
    toy's input_grad_fn sums the stage-0 input's cotangents)."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.parallel import pipeline as JP

    w, out_w, xm = _toy_inputs(M)
    blocks, extra = {"w": jnp.asarray(w)}, {"out_w": jnp.asarray(out_w)}

    def stage_fn(x, bl, ex):
        def body(c, lp):
            return jnp.tanh(c @ lp["w"]), jnp.float32(0.0)

        y, aux = jax.lax.scan(body, x, bl)
        return y, jnp.sum(aux)

    def finalize_fn(y, micro, ex):
        return jnp.mean((y @ ex["out_w"]) ** 2)

    def input_grad_fn(dx, micro, acc):
        if dx is None:
            return {"x": jnp.zeros(xm.shape[1:], jnp.float32)}
        return {"x": acc["x"] + dx}

    mesh = _jax_mesh({"pipe": P}, P).mesh
    try:
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(
                lambda b, e: JP.pipelined_apply({"x": xm}, b, e, stage_fn,
                                                finalize_fn, mesh)[0],
                argnums=(0, 1)))(blocks, extra)
            infer = jax.jit(lambda b, e: JP.pipelined_infer(
                {"x": xm}, b, e, stage_fn, lambda y, ex: y @ ex["out_w"],
                mesh))(blocks, extra)
            l1, _, gb, ge, gemb = jax.jit(lambda b, e: JP.pipelined_train_1f1b(
                {"x": xm}, b, e, stage_fn, finalize_fn, input_grad_fn,
                mesh))(blocks, extra)
        return {"loss": float(loss), "gw": np.asarray(grads[0]["w"]),
                "gout": np.asarray(grads[1]["out_w"]),
                "infer": np.asarray(infer), "loss_1f1b": float(l1),
                "gw_1f1b": np.asarray(gb["w"]),
                "gout_1f1b": np.asarray(ge["out_w"]),
                "gx_1f1b": np.asarray(gemb["x"])}
    finally:
        JM.reset_mesh()


def _toy_rank(P, M):
    """The port's three schedules on the toy at this stage."""
    import torch

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as PM
    from deepspeed_tpu_torch.parallel import pipeline as PL
    from deepspeed_tpu_torch.parallel.partitioning import pp_slice

    pp = PM.initialize_mesh(PM.MeshConfig(pipe=P)).pipe()
    w, out_w, xm = _toy_inputs(M)
    wl = torch.from_numpy(np.ascontiguousarray(pp_slice(w, P, pp.stage)))
    ow = torch.from_numpy(out_w)
    x = torch.from_numpy(xm)

    def stage_fn(h, bl, ex):
        for i in range(bl["w"].shape[0]):
            h = torch.tanh(h @ bl["w"][i])
        return h, torch.zeros(())

    def finalize_fn(y, micro, ex):
        return ((y @ ex["out_w"]) ** 2).mean()

    def input_grad_fn(dx, micro, acc):
        if dx is None:
            return {"x": torch.zeros(xm.shape[1:])}
        return {"x": acc["x"] + dx}

    out = {"stage": pp.stage}
    dtt.comm.reset_traffic()
    b, e = wl.clone().requires_grad_(True), ow.clone().requires_grad_(True)
    loss, _ = PL.pipelined_apply({"x": x}, {"w": b}, {"out_w": e}, stage_fn,
                                 finalize_fn, pp)
    loss.backward()
    out.update(loss=float(loss.detach()), gw=b.grad.numpy(),
               gout=e.grad.numpy())
    out["traffic_gpipe"] = {k: v[:2] for k, v in dtt.comm.traffic.items()}
    out["infer"] = PL.pipelined_infer(
        {"x": x}, {"w": wl}, {"out_w": ow}, stage_fn,
        lambda y, ex: y @ ex["out_w"], ((xm.shape[1],), torch.float32),
        pp).numpy()
    dtt.comm.reset_traffic()
    b, e = wl.clone().requires_grad_(True), ow.clone().requires_grad_(True)
    l1, _, gb, ge, gemb = PL.pipelined_train_1f1b(
        {"x": x}, {"w": b}, {"out_w": e}, stage_fn, finalize_fn,
        input_grad_fn, pp)
    out.update(loss_1f1b=float(l1), gw_1f1b=gb["w"].numpy(),
               gout_1f1b=ge["out_w"].numpy(), gx_1f1b=gemb["x"].numpy())
    out["traffic_1f1b"] = {k: v[:2] for k, v in dtt.comm.traffic.items()}
    PM.reset_mesh()
    return out


# --------------------------------------------------------------------------- #
# the transformer's pipelined functions at {pipe: 2}
# --------------------------------------------------------------------------- #

def _fn_inputs(model, masked):
    rows = 4
    tok = _tokens(rows, 7)
    return tok, (_uneven_mask(rows) if masked else None)


def _jax_fns(model, M, masked):
    """JAX's GPipe loss and gradients, 1F1B loss and gradients and logits
    at ``{pipe: 2}``."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.models import transformer as JT

    cfg = JT.get_model_config(model, dtype="float32")
    params = jax.tree.map(jnp.asarray, _np_params(model))
    tok, mask = _fn_inputs(model, masked)
    tok = jnp.asarray(tok)
    mask = None if mask is None else jnp.asarray(mask)
    mesh = _jax_mesh({"pipe": 2}, 2).mesh
    try:
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: JT.pipelined_lm_loss(p, tok, cfg, mesh=mesh,
                                               n_micro=M,
                                               loss_mask=mask)[0]))(params)
            l1, g1 = jax.jit(lambda p: JT.pipelined_lm_loss_and_grads(
                p, tok, cfg, mesh=mesh, n_micro=M, loss_mask=mask))(params)
            logits = jax.jit(lambda p: JT.pipelined_lm_logits(
                p, tok, cfg, mesh=mesh, n_micro=M))(params)
        return {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
                "loss_1f1b": float(l1),
                "grads_1f1b": jax.tree.map(np.asarray, g1),
                "logits": np.asarray(logits)}
    finally:
        JM.reset_mesh()


def _fns_rank(model, M, masked):
    """The port's GPipe loss and gradients (the whole tree's, this stage's
    layers nonzero), 1F1B's loss and gradients (this stage's layers) and
    the logits at ``{pipe: 2}``."""
    import torch

    from deepspeed_tpu_torch.comm import mesh as PM
    from deepspeed_tpu_torch.models import transformer as PT

    pp = PM.initialize_mesh(PM.MeshConfig(pipe=2)).pipe()
    cfg = PT.get_model_config(model, dtype="float32")
    tok, mask = _fn_inputs(model, masked)
    tok = torch.from_numpy(tok)
    mask = None if mask is None else torch.from_numpy(mask)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)

    params = leaf(_np_params(model))
    loss, _ = PT.pipelined_lm_loss(params, tok, cfg, pp, n_micro=M,
                                   loss_mask=mask)
    loss.backward()
    out = {"stage": pp.stage, "loss": float(loss.detach()),
           "grads": {k: v.grad.numpy() for k, v in _flat(params)}}
    l1, g1 = PT.pipelined_lm_loss_and_grads(leaf(_np_params(model)), tok,
                                            cfg, pp, n_micro=M,
                                            loss_mask=mask)
    out.update(loss_1f1b=float(l1),
               grads_1f1b={k: v.numpy() for k, v in _flat(g1)})
    out["logits"] = PT.pipelined_lm_logits(leaf(_np_params(model)), tok,
                                           cfg, pp, n_micro=M).numpy()
    PM.reset_mesh()
    return out


# --------------------------------------------------------------------------- #
# JAX's rebuilt spec (the reference fault the port does not copy)
# --------------------------------------------------------------------------- #

def _jax_rebuilt():
    """JAX's ``tiny_llama`` loss at ``{pipe: 2}`` on the uneven mask: the
    spec with ``pipeline_micro_batches=4``, that spec rebuilt for a remat
    policy, and the spec with M = 2."""
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm import mesh as JM

    params = jax.tree.map(jnp.asarray, _np_params("tiny_llama"))
    batch = {"tokens": jnp.asarray(_tokens(4, 7)),
             "loss_mask": jnp.asarray(_uneven_mask(4))}
    mesh = _jax_mesh({"pipe": 2}, 2).mesh
    try:
        spec4 = dst.causal_lm_spec("tiny_llama", dtype="float32",
                                   pipeline_micro_batches=4)
        specs = {"m4": spec4, "rebuilt": spec4.builder(remat="full"),
                 "m2": dst.causal_lm_spec("tiny_llama", dtype="float32",
                                          pipeline_micro_batches=2)}
        with mesh:
            return {k: float(jax.jit(s.loss_fn)(params, batch))
                    for k, s in specs.items()}
    finally:
        JM.reset_mesh()


def _rebuilt_rank():
    """The port's loss of the same spec rebuilt for a remat policy, and
    the pipeline micro-batches an engine with
    ``activation_checkpointing.policy`` runs."""
    import torch

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as PM
    from deepspeed_tpu_torch.models.convert import tree_from_numpy

    PM.initialize_mesh(PM.MeshConfig(pipe=2))
    spec = dtt.causal_lm_spec("tiny_llama", dtype="float32",
                              pipeline_micro_batches=4)
    rebuilt = spec.builder(remat="full")
    params = tree_from_numpy(_np_params("tiny_llama"), torch.float32,
                             torch.device("cpu"))
    batch = {"tokens": torch.from_numpy(_tokens(4, 7)),
             "loss_mask": torch.from_numpy(_uneven_mask(4))}
    with torch.no_grad():
        out = {"rebuilt": float(rebuilt.loss_fn(params, batch))}
    engine, *_ = dtt.initialize(model=spec, config=dict(
        _engine_config({"stage": 1}), mesh={"pipe": 2},
        train_micro_batch_size_per_gpu=4,
        activation_checkpointing={"policy": "full"}), device="cpu")
    out["engine"] = (engine.model_spec.config.remat,
                     engine.model_spec.pipeline_micro_batches)
    engine.close()
    PM.reset_mesh()
    return out


# --------------------------------------------------------------------------- #
# JAX's engines, its side process and the one-process tag
# --------------------------------------------------------------------------- #

def _jax_engine(name):
    import deepspeed_tpu as dst

    world, mesh, _, model, *_ = CASES[name]
    mm = _jax_mesh(mesh, world)
    kw = _spec_kw(name)
    kw["pipeline_schedule"] = "1f1b"
    engine, *_ = dst.initialize(model=dst.causal_lm_spec(model, **kw),
                                config=_case_config(name), mesh_manager=mm)
    return engine, mm


def _jax_resume(tmp):
    """JAX at ``{pipe: 2}`` loads the port's ``{pipe: 2}`` tag (native,
    writer fast) and takes the next step; then the tag's universal
    conversion (the port's converter) loaded into the same JAX engine."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm import comm as JC
    from deepspeed_tpu.comm import mesh as JM

    from deepspeed_tpu_torch.checkpoint.universal import convert_to_universal

    world, mesh, _, model, *_ = CASES[CKPT]
    ckpt = os.path.join(tmp, "ckpt2")
    uni = convert_to_universal(ckpt, os.path.join(tmp, "universal2"),
                               tag="pp")
    if not JC.is_initialized():
        JC.init_distributed(verbose=False)
    mm = _jax_mesh(mesh, world)
    try:
        kw = _spec_kw(CKPT)
        engine, *_ = dst.initialize(
            model=dst.causal_lm_spec(model, **kw),
            config=dict(_case_config(CKPT), checkpoint={"writer": "fast"}),
            mesh_manager=mm)
        engine.load_checkpoint(ckpt, tag="pp")
        steps = engine.global_steps
        data = iter(_batches(_rows(CKPT), 2 * STEPS + 2)[2 * STEPS:])
        loss = float(engine.train_batch(data))
        engine.load_universal_checkpoint(uni)
        master = jax.tree.map(np.asarray, engine.state["master"])
        return {"steps": steps, "loss": loss, "uni_master": master,
                "uni": uni}
    finally:
        JM.reset_mesh()


def _jax_side(out, tmp):
    """JAX's function-level references, its rebuilt spec, then its resume
    of the port's ``{pipe: 2}`` tag (once world 2 has written it), in a
    process of its own, beside the JAX engines."""
    try:
        res = {"toy": {case: _jax_toy(*case) for case in TOYS},
               "fns": {case: _jax_fns(*case) for case in FNS},
               "rebuilt": _jax_rebuilt()}
        _wait(os.path.join(tmp, "ckpt2_ready"), "{pipe: 2} tag")
        res["resumed"] = _jax_resume(tmp)
        out.put(("ok", res))
    except Exception:                                   # noqa: BLE001
        import traceback

        out.put(("error", traceback.format_exc()))


def _one_process_tag(tmp, master0):
    """A one-process tag of CKPT's model after one step (for the ranks at
    ``{pipe: 2}`` to load), its master and moments."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as PM
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    PM.reset_mesh()
    model = CASES[CKPT][3]
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(model, dtype="float32", remat="full"),
        config=dict(_engine_config({"stage": 1}),
                    train_micro_batch_size_per_gpu=2), device="cpu")
    load_master(engine, master0)
    engine.train_batch(iter(_batches(2, 2)))
    engine.save_checkpoint(str(tmp / "one"), tag="one")
    out = {"master": gather_master(engine), "moments": {
        f"{m}{k}": v for m in engine._opt_names()
        for k, v in _leaves(engine._views(engine.state["opt"][m]))}}
    (tmp / "one_ready").write_text("1")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks started first (their toy, function, refusal
    cases need nothing of JAX's), and JAX's function-level cases in a
    process of their own; JAX's initial master of each case pickled for
    the ranks' engines (in ``_jax_order``) and a one-process tag for world
    2 to load, then JAX's engines → (JAX runs, {world: rank results}, tmp
    dir, the one-process tag's state)."""
    import jax
    import torch.multiprocessing as mp

    from deepspeed_tpu.comm import comm as JC
    from deepspeed_tpu.comm import mesh as JM

    from test_torch_zero import RANK_TIMEOUT

    if not JC.is_initialized():     # else the engine builds a mesh of all 8
        JC.init_distributed(verbose=False)
    tmp = tmp_path_factory.mktemp("pp")
    collect = {world: _spawn_start(_world_rank, world,
                                   tmp_path_factory.mktemp(f"pp{world}"),
                                   str(tmp))
               for world in WORLDS}
    side_out = mp.get_context("spawn").Queue()
    side = mp.get_context("spawn").Process(target=_jax_side,
                                           args=(side_out, str(tmp)))
    side.start()
    out = {"engine": {}}
    one = None
    for name in _jax_order():
        engine, mm = _jax_engine(name)
        m0 = jax.tree.map(np.asarray, engine.state["master"])
        path = tmp / f"master0_{name}.pkl"
        part = path.with_suffix(".part")
        part.write_bytes(pickle.dumps(m0))
        part.rename(path)
        if name == CKPT:
            one = _one_process_tag(tmp, m0)
        data = iter(_batches(_rows(name), 2 * STEPS))
        losses, norms = [], []
        for _ in range(STEPS):
            losses.append(float(engine.train_batch(data)))
            norms.append(engine.get_global_grad_norm())
        out["engine"][name] = {
            "losses": losses, "norms": norms, "wire": engine._wire_format(),
            "train_batch_size": engine.train_batch_size(),
            "master": jax.tree.map(np.asarray, engine.state["master"])}
        del engine, mm
        JM.reset_mesh()
    try:
        status, value = side_out.get(timeout=RANK_TIMEOUT)
    finally:
        side.join(timeout=RANK_TIMEOUT)
        if side.is_alive():
            side.kill()
            side.join()
    assert status == "ok", value
    out.update(value)
    return out, {world: c() for world, c in collect.items()}, tmp, one


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #

def _engine_rank(rank, master0, name, ckpt_dir):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    model = CASES[name][3]
    spec = dtt.causal_lm_spec(model, remat="full", **_spec_kw(name))
    engine, *_ = dtt.initialize(model=spec, config=_case_config(name),
                                device="cpu")
    load_master(engine, master0)
    data = iter(_batches(_rows(name), 2 * STEPS + 2))
    dtt.comm.reset_traffic()
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(float(engine.train_batch(data)))
        norms.append(engine.get_global_grad_norm())
    traffic = {k: list(v) for k, v in dtt.comm.traffic.items()}
    out = {"type": type(engine).__name__, "losses": losses, "norms": norms,
           "master": gather_master(engine), "wire": engine._wire_format(),
           "train_batch_size": engine.train_batch_size(),
           "stage": engine.mesh_manager.stage,
           "local_layers": engine._slots[0].shape[0], "traffic": traffic}
    if ckpt_dir is not None:
        engine.save_checkpoint(ckpt_dir, tag="pp")
        if rank == 0:
            with open(ckpt_dir + "_ready", "w") as f:
                f.write("1")
        out["ckpt_moments"] = {
            f"{m}{k}": v for m in engine._opt_names()
            for k, v in _leaves(engine.full_tree(engine.state["opt"][m]))}
        out["next_loss"] = float(engine.train_batch(data))
    engine.close()
    return out


def _load_rank(tmp, tag_dir, tag, mesh, micro):
    """A tag loaded at ``mesh`` (CKPT's model, ZeRO-1): the gathered
    master and moments."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master

    _wait(os.path.join(tmp, f"{tag_dir}_ready"), f"tag {tag_dir}")
    model = CASES[CKPT][3]
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(model, dtype="float32", remat="full"),
        config=dict(_engine_config({"stage": 1}), mesh=mesh,
                    train_micro_batch_size_per_gpu=micro), device="cpu")
    engine.load_checkpoint(os.path.join(tmp, tag_dir), tag=tag)
    out = {"master": gather_master(engine), "moments": {
        f"{m}{k}": v for m in engine._opt_names()
        for k, v in _leaves(engine.full_tree(engine.state["opt"][m]))},
        "global_steps": engine.global_steps}
    engine.close()
    return out


def _other_spec():
    """A spec other than causal_lm_spec's: a linear regression."""
    import torch

    from deepspeed_tpu_torch.models.api import ModelSpec

    def init_fn(generator=None, device=None):
        return {"w": torch.zeros(8, 8, device=device)}

    return ModelSpec(init_fn=init_fn,
                     loss_fn=lambda p, b: (b["tokens"].float() @ p["w"])
                     .square().mean())


def _refused_rank(name):
    """The error a composition left out raises (at ``initialize``, or at
    the first step for a spec option the loss meets)."""
    import deepspeed_tpu_torch as dtt

    _, mesh, extra, model, spec_kw, _ = REFUSED[name]
    cfg = dict(_engine_config({"stage": 1}), mesh=mesh,
               train_micro_batch_size_per_gpu=2)
    cfg.update(extra)
    try:
        spec = (_other_spec() if model is None else
                dtt.causal_lm_spec(model, dtype="float32", **spec_kw))
        engine, *_ = dtt.initialize(model=spec, config=cfg, device="cpu")
        engine.train_batch(iter(_batches(2 * mesh.get("data", 1), 2)))
    except NotImplementedError as e:
        return str(e)
    return None


def _jax_like_errors_rank():
    """The int8 wire's exact fallback (its warning), the host step's and
    ``num_layers % P``'s errors at ``{pipe: 2}``."""
    import logging

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

    out = {}
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("deepspeed_tpu_torch")
    logger.addHandler(handler)
    try:
        engine, *_ = dtt.initialize(
            model=dtt.causal_lm_spec("tiny", dtype="float32"),
            config=dict(_engine_config({
                "stage": 2, "zero_quantized_gradients": True,
                "zero_quantized_weights": True}), mesh={"pipe": 2},
                train_micro_batch_size_per_gpu=2), device="cpu")
        engine.train_batch(iter(_batches(2, 2)))
        out["int8"] = (engine._wire_format(),
                       [r.getMessage() for r in records
                        if "exact collectives used" in r.getMessage()])
        engine.close()
    finally:
        logger.removeHandler(handler)
    for key, spec_kw, zero in (
            ("host_step", {}, {"stage": 1, "offload_optimizer": {
                "device": "cpu", "host_step": True}}),
            ("layers", {"num_layers": 3}, {"stage": 1})):
        try:
            dtt.initialize(model=dtt.causal_lm_spec("tiny", dtype="float32",
                                                    **spec_kw),
                           config=dict(_engine_config(zero),
                                       mesh={"pipe": 2},
                                       train_micro_batch_size_per_gpu=2),
                           device="cpu")
            out[key] = None
        except (DeepSpeedConfigError, ValueError) as e:
            out[key] = (type(e).__name__, str(e))
    return out


def _world_rank(rank, world, tmp):
    """Every case of one world, in one spawn: the toy, function, refusal
    cases first (no JAX input), then the engines from JAX's initial
    masters and the tag loads."""
    import torch

    torch.set_num_threads(1)
    out = {"toy": {case: _toy_rank(*case) for case in TOYS
                   if case[0] == world},
           "fns": ({case: _fns_rank(*case) for case in FNS}
                   if world == 2 else {}),
           "refused": {name: _refused_rank(name)
                       for name, case in REFUSED.items()
                       if case[0] == world}}
    if world == 2:
        out["errors"] = _jax_like_errors_rank()
        out["rebuilt"] = _rebuilt_rank()
    out["engine"] = {}
    masters = {}
    for name, case in CASES.items():
        if case[0] != world:
            continue
        src = JAX_OF.get(name, name)
        path = os.path.join(tmp, f"master0_{src}.pkl")
        _wait(path, "JAX master")
        if path not in masters:
            masters[path] = pickle.loads(open(path, "rb").read())
        ckpt = os.path.join(tmp, "ckpt2") if name == CKPT else None
        out["engine"][name] = _engine_rank(rank, masters[path], name, ckpt)
    if world == 2:
        out["one_into_p2"] = _load_rank(tmp, "one", "one", {"pipe": 2}, 2)
    if world == 4:
        out["p2_into_p2d2"] = _load_rank(tmp, "ckpt2", "pp",
                                         {"pipe": 2, "data": 2}, 2)
    return out


# --------------------------------------------------------------------------- #
# the checks
# --------------------------------------------------------------------------- #

def test_microbatch_and_stage_perm_match_jax():
    import jax.numpy as jnp
    import torch

    from deepspeed_tpu.parallel import pipeline as JP

    from deepspeed_tpu_torch.parallel import pipeline as PL

    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    for M in (1, 2, 3, 6):
        np.testing.assert_array_equal(
            PL.microbatch(torch.from_numpy(x), M).numpy(),
            np.asarray(JP.microbatch(jnp.asarray(x), M)))
    for n in (1, 2, 4):
        assert PL.stage_perm(n) == JP.stage_perm(n)
    for fn, arr in ((PL.microbatch, torch.from_numpy(x)),
                    (JP.microbatch, jnp.asarray(x))):
        with pytest.raises(ValueError, match="not divisible by pipeline "
                                             "microbatches 4"):
            fn(arr, 4)


@pytest.mark.parametrize("P,M", TOYS)
def test_toy_schedules_match_jax(P, M, runs):
    """GPipe's loss and gradients (the stage's layers, the replicated
    head summed over ``pipe``), the forward-only outputs on every stage,
    and 1F1B's loss and gradients against JAX's at ``{pipe: P}``; M
    activations sent by every stage but the last, M cotangents by every
    stage but the first, in each schedule."""
    from deepspeed_tpu_torch.parallel.partitioning import pp_slice

    jruns, port, _, _ = runs
    want = jruns["toy"][(P, M)]
    for got in (r["toy"][(P, M)] for r in port[P]):
        s = got["stage"]
        assert abs(got["loss"] - want["loss"]) <= ATOL
        assert abs(got["loss_1f1b"] - want["loss_1f1b"]) <= ATOL
        for k, stage_sliced in (("gw", True), ("gout", False),
                                ("gw_1f1b", True), ("gout_1f1b", False),
                                ("gx_1f1b", False), ("infer", False)):
            ref = pp_slice(want[k], P, s) if stage_sliced else want[k]
            np.testing.assert_allclose(got[k], ref, atol=ATOL, rtol=0,
                                       err_msg=f"{k} P={P} M={M} stage {s}")
        for key in ("traffic_gpipe", "traffic_1f1b"):
            tr = got[key]
            assert tr.get("pipe/activation", [0])[0] == (
                M if s < P - 1 else 0), (key, s, tr)
            assert tr.get("pipe/cotangent", [0])[0] == (
                M if s > 0 else 0), (key, s, tr)


@pytest.mark.parametrize("model,M,masked", FNS)
def test_transformer_pipelined_functions_match_jax(model, M, masked, runs):
    """``pipelined_lm_loss`` (GPipe) and its gradients, ``pipelined_lm_
    loss_and_grads`` (1F1B) and ``pipelined_lm_logits`` against JAX's at
    ``{pipe: 2}``; 1F1B's gradients against GPipe's (JAX's
    ``test_grads_match_gpipe_autodiff``)."""
    from deepspeed_tpu_torch.models import transformer as PT
    from deepspeed_tpu_torch.parallel.partitioning import pp_slice

    jruns, port, _, _ = runs
    want = jruns["fns"][(model, M, masked)]
    cfg = PT.get_model_config(model)
    wg, wg1 = dict(_flat(want["grads"])), dict(_flat(want["grads_1f1b"]))
    for got in (r["fns"][(model, M, masked)] for r in port[2]):
        s = got["stage"]
        assert abs(got["loss"] - want["loss"]) <= ATOL
        assert abs(got["loss_1f1b"] - want["loss_1f1b"]) <= ATOL
        np.testing.assert_allclose(got["logits"], want["logits"], atol=ATOL,
                                   rtol=0)
        assert sorted(got["grads"]) == sorted(wg) == sorted(got["grads_1f1b"])
        for k in wg:
            mine, mine1 = got["grads"][k], got["grads_1f1b"][k]
            ref, ref1 = wg[k], wg1[k]
            if k.startswith("/blocks"):
                assert mine.shape[0] == cfg.num_layers
                mine = pp_slice(mine, 2, s)
                ref, ref1 = pp_slice(ref, 2, s), pp_slice(ref1, 2, s)
            for a, b in ((mine, ref), (mine1, ref1), (mine1, mine)):
                np.testing.assert_allclose(a, b, atol=ATOL, rtol=0,
                                           err_msg=f"{model} {k} stage {s}")


def _check_engine(name, got, want, world, rank):
    tol = TOL["exact"]
    _, mesh, zero, *_ = CASES[name]
    assert got["type"] == "DataParallelEngine"
    assert got["wire"] == want["wire"] == "exact"
    assert got["train_batch_size"] == want["train_batch_size"]
    P = mesh["pipe"]
    assert got["stage"] == rank // (world // P)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=tol["loss"], atol=0, err_msg=name)
    np.testing.assert_allclose(got["norms"], want["norms"], atol=0,
                               rtol=tol["loss"], err_msg=name)
    mine, theirs = dict(_leaves(got["master"])), dict(
        _leaves(want["master"]))
    assert sorted(mine) == sorted(theirs)
    diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                           for k in theirs])
    assert diff.max() <= tol["master"], (name, rank, diff.max())
    assert diff.mean() <= tol["master_mean"], (name, rank, diff.mean())


@pytest.mark.parametrize("name", [n for n in CASES if n not in BF16])
def test_engine_pipe_axis_matches_jax_engine(name, runs):
    """Every rank's losses (equal on every rank), grad norms and whole
    master against JAX's engine at the same mesh; each rank holds its
    stage's L/P layers; the stage hops carry M·gas activations and
    cotangents a step, no gradient is reduced over ``pipe``."""
    jruns, port, _, _ = runs
    world, mesh, _, model, _, _, _, M, layers = CASES[name]
    P = mesh["pipe"]
    M = M or P
    want = jruns["engine"][JAX_OF.get(name, name)]
    ranks = [r["engine"][name] for r in port[world]]
    for r, got in enumerate(ranks):
        assert got["losses"] == ranks[0]["losses"], (name, r)
        _check_engine(name, got, want, world, r)
        assert got["local_layers"] == layers // P
        tr, s = got["traffic"], got["stage"]
        n = STEPS * 2 * M
        assert tr.get("pipe/activation", [0])[0] == (n if s < P - 1 else 0)
        assert tr.get("pipe/cotangent", [0])[0] == (n if s > 0 else 0)
        assert not [k for k in tr if k.startswith("pipe/") and k not in (
            "pipe/activation", "pipe/cotangent", "pipe/exchange",
            "pipe/all_reduce")], tr


def test_uneven_mask_follows_jax_pipelined_mean(runs):
    """At ``{pipe: 2, data: 2}`` with a mask whose counts differ across
    pipeline micro-batches, the loss is JAX's mean of micro-batch means
    (the engine check above), which is not the global masked token mean
    of the step without ``pipe``: one process's first loss differs."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as PM
    from deepspeed_tpu_torch.models.convert import load_master

    jruns, port, tmp, _ = runs
    name = "p2d2_zero1_uneven"
    PM.reset_mesh()
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec("tiny_llama", dtype="float32"),
        config=dict(_engine_config({"stage": 1}),
                    train_micro_batch_size_per_gpu=_rows(name)),
        device="cpu")
    load_master(engine, pickle.loads((tmp / f"master0_{name}.pkl")
                                     .read_bytes()))
    global_mean = float(engine.train_batch(iter(_batches(_rows(name), 2))))
    pipelined = port[4][0]["engine"][name]["losses"][0]
    assert abs(global_mean - pipelined) > 100 * TOL["exact"]["loss"] \
        * abs(pipelined), (global_mean, pipelined)


@pytest.mark.parametrize("name", list(BF16))
def test_bf16_engine_pipe_axis_matches_jax(name, runs):
    """bf16 at ``{pipe: 2}``: each rank's losses and master no further
    from JAX's fp32 run of the same case than ``LOW_VS_JAX`` times JAX's
    own bf16 run, metric by metric (a distance below ``TOL["exact"]``'s
    limit counting as that limit)."""
    jruns, port, _, _ = runs
    world = CASES[name][0]
    ref = jruns["engine"][BF16[name]]
    fp32 = dict(_leaves(ref["master"]))
    floor = np.array([TOL["exact"]["loss"], TOL["exact"]["master"],
                      TOL["exact"]["master_mean"]])

    def dist(losses, master):
        loss = np.max(np.abs(np.asarray(losses) - ref["losses"])
                      / np.abs(ref["losses"]))
        diff = np.concatenate([np.abs(v - fp32[k]).ravel()
                               for k, v in _leaves(master)])
        return np.array([loss, diff.max(), diff.mean()])

    want = jruns["engine"][name]
    theirs = np.maximum(floor, dist(want["losses"], want["master"]))
    for r, got in enumerate(p["engine"][name] for p in port[world]):
        mine = dist(got["losses"], got["master"])
        assert np.all(mine <= LOW_VS_JAX * theirs), (name, r, mine, theirs)


@pytest.mark.parametrize("name", list(REFUSED))
def test_pipe_combinations_left_out_raise(name, runs):
    _, port, _, _ = runs
    world, *_, what = REFUSED[name]
    for r in port[world]:
        msg = r["refused"][name]
        assert msg is not None, name
        assert "later slice" in msg and "queue A.4" in msg, msg
        assert what in msg, msg


def test_pipe_errors_as_jax(runs):
    """The ZeRO++ int8 wire falls back to the exact wire with JAX's
    warning; ``host_step`` raises JAX's ``DeepSpeedConfigError``;
    ``num_layers`` not divisible by ``pipe`` raises JAX's
    ``ValueError``."""
    _, port, _, _ = runs
    for got in (r["errors"] for r in port[2]):
        wire, warned = got["int8"]
        assert wire == "exact" and warned, got["int8"]
        assert "seq=pipe=1" in warned[0]
        assert got["host_step"] == (
            "DeepSpeedConfigError",
            "host_step is not supported with pipeline parallelism")
        assert got["layers"] == ("ValueError",
                                 "num_layers 3 not divisible by pipe=2")


def test_rebuilt_spec_keeps_pipeline_micro_batches(runs):
    """JAX's ``_rebuild`` drops ``pipeline_micro_batches``: its spec
    rebuilt for a remat policy gives M = P's loss (the reference's fault);
    the port's rebuilt spec keeps M = 4 and gives JAX's unrebuilt loss,
    and an engine rebuilding for ``activation_checkpointing.policy`` keeps
    it too."""
    jruns, port, _, _ = runs
    jax_losses = jruns["rebuilt"]
    assert abs(jax_losses["rebuilt"] - jax_losses["m2"]) <= ATOL
    assert abs(jax_losses["m4"] - jax_losses["m2"]) > 100 * ATOL
    for got in (r["rebuilt"] for r in port[2]):
        assert abs(got["rebuilt"] - jax_losses["m4"]) <= ATOL
        assert got["engine"] == ("full", 4)


def test_pipe_checkpoint_loads_into_one_process(runs):
    """The ``{pipe: 2}`` tag holds every layer-stacked leaf whole: one
    process loads its master and both moments bit-equal."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as PM
    from deepspeed_tpu_torch.models.convert import gather_master

    _, port, tmp, _ = runs
    got = port[2][0]["engine"][CKPT]
    PM.reset_mesh()
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(CASES[CKPT][3], dtype="float32",
                                 remat="full"),
        config=dict(_engine_config({"stage": 1}),
                    train_micro_batch_size_per_gpu=2), device="cpu")
    engine.load_checkpoint(str(tmp / "ckpt2"), tag="pp")
    mine = dict(_leaves(gather_master(engine)))
    theirs = dict(_leaves(got["master"]))
    assert sorted(mine) == sorted(theirs)
    assert all(np.array_equal(mine[k], theirs[k]) for k in theirs)
    moments = {f"{m}{k}": v for m in engine._opt_names()
               for k, v in _leaves(engine._views(engine.state["opt"][m]))}
    assert sorted(moments) == sorted(got["ckpt_moments"])
    assert all(np.array_equal(np.asarray(moments[k]),
                              np.asarray(got["ckpt_moments"][k]))
               for k in moments)
    assert engine.global_steps == STEPS


@pytest.mark.parametrize("key,world", [("p2_into_p2d2", 4),
                                       ("one_into_p2", 2)])
def test_tags_cross_pipe_sizes(key, world, runs):
    """The ``{pipe: 2}`` tag loaded at ``{pipe: 2, data: 2}``, and a
    one-process tag at ``{pipe: 2}``: every rank's gathered master and
    moments bit-equal to the saver's."""
    _, port, _, one = runs
    src = (one if key == "one_into_p2" else
           dict(master=port[2][0]["engine"][CKPT]["master"],
                moments=port[2][0]["engine"][CKPT]["ckpt_moments"]))
    steps = 1 if key == "one_into_p2" else STEPS
    for got in (r[key] for r in port[world]):
        assert got["global_steps"] == steps
        mine, theirs = dict(_leaves(got["master"])), dict(
            _leaves(src["master"]))
        assert sorted(mine) == sorted(theirs)
        assert all(np.array_equal(mine[k], theirs[k]) for k in theirs)
        assert sorted(got["moments"]) == sorted(src["moments"])
        assert all(np.array_equal(np.asarray(got["moments"][k]),
                                  np.asarray(src["moments"][k]))
                   for k in src["moments"])


def test_jax_resumes_a_port_pipe2_checkpoint(runs):
    jruns, port, _, _ = runs
    got = port[2][0]["engine"][CKPT]
    assert jruns["resumed"]["steps"] == STEPS
    np.testing.assert_allclose(jruns["resumed"]["loss"], got["next_loss"],
                               rtol=TOL["exact"]["loss"], atol=0)


def test_universal_from_pipe2_loads_in_both_packages(runs):
    """The universal conversion of the ``{pipe: 2}`` tag: JAX's engine and
    a one-process port engine each load the ranks' master bit for bit."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as PM
    from deepspeed_tpu_torch.models.convert import gather_master

    jruns, port, _, _ = runs
    theirs = dict(_leaves(port[2][0]["engine"][CKPT]["master"]))
    jax_master = dict(_leaves(jruns["resumed"]["uni_master"]))
    assert all(np.array_equal(jax_master[k], theirs[k]) for k in theirs)
    PM.reset_mesh()
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(CASES[CKPT][3], dtype="float32",
                                 remat="full"),
        config=dict(_engine_config({"stage": 1}),
                    train_micro_batch_size_per_gpu=2), device="cpu")
    engine.load_universal_checkpoint(jruns["resumed"]["uni"])
    mine = dict(_leaves(gather_master(engine)))
    assert sorted(mine) == sorted(theirs)
    assert all(np.array_equal(mine[k], theirs[k]) for k in theirs)
    assert engine.global_steps == STEPS


def test_pipeline_section_parses_as_jax():
    """The ``pipeline`` section: the same values in both packages, read by
    nothing (the mesh's ``pipe`` axis sets the stages)."""
    import dataclasses

    from deepspeed_tpu.runtime.config import load_config as jload

    from deepspeed_tpu_torch.runtime.config import load_config as pload

    base = {"train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "adam", "params": {"lr": 1e-3}}}
    for section in ({}, {"stages": 2, "micro_batches": 4,
                         "activation_checkpoint_interval": 1}):
        cfg = dict(base, pipeline=section)
        assert dataclasses.asdict(pload(cfg).pipeline) == \
            dataclasses.asdict(jload(cfg).pipeline)


@pytest.mark.parametrize("model", ["tiny_llama", "tiny"])
def test_local_trees_cut_once(model):
    """``pp_local_tree`` gives each layer-stacked leaf the stage's layers
    and keeps the rest whole; composed with ``tp_local_tree`` in either
    order a leaf is cut once at each axis, and a cut tree goes through
    both unchanged."""
    import torch

    from deepspeed_tpu_torch.models import transformer as PT
    from deepspeed_tpu_torch.models.convert import (
        pp_local_tree,
        tp_local_tree,
    )
    from deepspeed_tpu_torch.parallel.partitioning import pp_slice, tp_slice

    cfg = PT.get_model_config(model, dtype="float32", num_layers=4)
    tree = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    whole = dict(_flat(tree))
    axes = dict(_flat(PT.param_logical_axes(cfg)))
    for stage in range(2):
        a = tp_local_tree(pp_local_tree(tree, cfg, 2, stage), cfg, 2, 1)
        b = dict(_flat(pp_local_tree(tp_local_tree(tree, cfg, 2, 1), cfg, 2,
                                     stage)))
        again = dict(_flat(pp_local_tree(tp_local_tree(a, cfg, 2, 1), cfg,
                                         2, stage)))
        for k, v in _flat(a):
            want = whole[k]
            if k.startswith("/blocks"):
                want = pp_slice(want, 2, stage)
            want = tp_slice(axes[k], want, 2, 1)
            assert torch.equal(v, want), (k, stage)
            assert torch.equal(b[k], want) and torch.equal(again[k], want)
