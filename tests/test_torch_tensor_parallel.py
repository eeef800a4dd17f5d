"""Tensor parallelism of the PyTorch port (the ``tensor`` mesh axis)
against the JAX package.

Ranks run as spawned gloo processes on one intra-op thread
(``test_torch_expert_parallel._spawn_start``), one spawn a world: 2, 4
and 8 ranks. JAX runs the same meshes on the conftest's 8 CPU devices
meanwhile, its parameters sharded by ``DEFAULT_TP_RULES`` under GSPMD.

* Megatron's conjugate ops (``comm.copy_to_tensor``,
  ``reduce_from_tensor``, ``gather_from_tensor``) at T = 2 and 4: values
  and gradients against numpy, each counted on the ``tensor`` group.
* ``transformer.forward`` and ``fused_lm_loss`` on each rank's slices at
  ``{tensor: 2}`` (``tiny_llama``, ``tiny``) and ``{tensor: 4}``
  (``tiny``) against JAX at the same mesh: the whole logits on every
  rank, the loss and each rank's gradient of its slices within ``ATOL``.
* The engines: ``tiny_llama`` and ``tiny`` fp32, remat full, 3 masked
  steps from JAX's initial master, against the JAX engine at the same
  mesh by ``test_torch_zero.TOL["exact"]`` (losses equal on every rank,
  the grad norm, the whole master): ``{tensor: 2}`` at ZeRO 0, 1 and 2,
  ``{data: 2, tensor: 2}`` at ZeRO-2 with ``overlap_comm`` (the flash
  wrapper's plain version on each rank's heads) and ZeRO-3, ``{data: 4,
  tensor: 2}`` at ZeRO-3 (JAX's ``test_multiprocess.py:169`` mesh); one
  bf16 case no further from JAX's fp32 run than ``LOW_VS_JAX`` times JAX's
  own bf16 run.
* Every composition the axis does not run yet raises, naming queue A.4.
* FastGen at ``{tensor: 2}``: ``tiny_llama`` fp32 token for token with
  JAX's FastGen on the same parameters at the same mesh
  (``test_tp2_greedy_parity``), ``decode_stream`` too
  (``test_tp2_decode_stream``), every rank emitting the same tokens;
  JAX's refusals (``test_tp_refusals``): ``kv_heads`` not divisible raises
  under ``tp=True`` and serves replicated, with a warning, under
  ``tp=None``; where JAX refuses its Pallas kernel the port serves with
  its paged-attention kernel wrappers (queue C), here their plain
  versions; ``tp=False`` never engages, and ``tp=True`` in one process
  serves the whole model, as in JAX.
* Checkpoints across tensor sizes: a ``{tensor: 2}`` tag and a ``{data:
  2, tensor: 2}`` ZeRO-3 tag load into one process bit-equal to the
  ranks' gathered master and moments; a one-process tag loads into
  ``{tensor: 2}`` bit-equal; JAX resumes the port's ``{tensor: 2}`` tag to
  the port's next loss; its universal conversion loads into both packages
  bit-equal.

jax is imported inside the fixtures and tests, never at the top: a
spawned rank imports this module to find its function.
"""
import os
import pickle
import time
import warnings

import numpy as np
import pytest

from test_torch_expert_parallel import _jax_mesh, _spawn_start
from test_torch_zero import TOL, _engine_config, _leaves
from test_torch_zero3 import LOW_VS_JAX, _precision

SEQ = 32
STEPS = 3
ATOL = 2e-5
OPS_WORLDS = (2, 4)
# the forward cases: (T, model)
FWD_CASES = ((2, "tiny_llama"), (2, "tiny"), (4, "tiny"))
# name → (world, mesh, zero, model, port attention, dtype)
CASES = {
    "t2_zero0_tiny": (2, {"tensor": 2}, {"stage": 0}, "tiny", None,
                      "float32"),
    "t2_zero1_tiny_llama": (2, {"tensor": 2}, {"stage": 1}, "tiny_llama",
                            None, "float32"),
    "t2_zero2_tiny": (2, {"tensor": 2}, {"stage": 2}, "tiny", None,
                      "float32"),
    "t2_zero1_tiny_llama_bf16": (2, {"tensor": 2}, {"stage": 1},
                                 "tiny_llama", None, "bfloat16"),
    "d2t2_zero2_overlap_flash": (4, {"data": 2, "tensor": 2},
                                 {"stage": 2, "overlap_comm": True},
                                 "tiny_llama", "flash", "float32"),
    "d2t2_zero3_tiny": (4, {"data": 2, "tensor": 2}, {"stage": 3}, "tiny",
                        None, "float32"),
    "d4t2_zero3_tiny_llama": (8, {"data": 4, "tensor": 2}, {"stage": 3},
                              "tiny_llama", None, "float32"),
}
BF16 = {"t2_zero1_tiny_llama_bf16": "t2_zero1_tiny_llama"}
# the tags each world's case saves, and the one-process tag world 2 loads
CKPT = {2: "t2_zero1_tiny_llama", 4: "d2t2_zero3_tiny"}
ONE = "t2_zero1_tiny_llama"
# what a tensor axis does not compose with yet (queue A.4): name →
# (world, mesh, extra config, model, spec keywords, what the error names)
REFUSED = {
    "seq": (4, {"tensor": 2, "seq": 2}, {}, "tiny_llama", {}, "seq > 1"),
    "hpz": (4, {"tensor": 2}, {"zero_optimization": {
        "stage": 2, "zero_hpz_partition_size": 2}}, "tiny_llama", {},
        "hpZ / MiCS"),
    "int8_wire": (4, {"data": 2, "tensor": 2}, {"zero_optimization": {
        "stage": 2, "zero_quantized_gradients": True,
        "zero_quantized_weights": True}}, "tiny_llama", {},
        "the ZeRO++ int8 wire"),
    "not_divisible": (4, {"tensor": 4}, {}, "tiny_llama", {},
                      "kv_heads 2 not divisible by 4"),
    "offload_optimizer": (2, {"tensor": 2}, {"zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu"}}}, "tiny_llama",
        {}, "the offload tiers"),
    "offload_param": (2, {"tensor": 2}, {"zero_optimization": {
        "stage": 3, "offload_param": {"device": "cpu"}}}, "tiny_llama", {},
        "the offload tiers"),
    "host_step": (2, {"tensor": 2}, {"zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu",
                                          "host_step": True}}},
        "tiny_llama", {}, "the host step"),
    "zenflow": (2, {"tensor": 2}, {"zero_optimization": {
        "stage": 1, "zenflow": {"enabled": True}}}, "tiny_llama", {},
        "ZenFlow"),
    "sparse_attention": (2, {"tensor": 2}, {}, "tiny_llama",
                         {"attention": "sparse:fixed"},
                         "attention='sparse:fixed'"),
    "loss_tiles": (2, {"tensor": 2}, {}, "tiny_llama", {"loss_tiles": 4},
                   "loss_tiles=4"),
}
WORLDS = (2, 4, 8)
# FastGen at {tensor: 2}: JAX's TestFastGenTP settings and prompts
FG_KW = dict(n_blocks=64, block_size=16, max_blocks_per_seq=8,
             token_budget=128, temperature=0.0, seed=0)
FG_MODEL = "tiny_llama"


def _np_params(model, seed=0):
    """A parameter tree of ``model`` (fp32, the JAX keys and shapes) from a
    numpy seed: weights N(0, 0.05²), norm scales near 1."""
    import torch

    from deepspeed_tpu_torch.models import transformer as PT

    cfg = PT.get_model_config(model, dtype="float32")
    shapes = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(seed)

    def draw(tree, path=()):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = draw(v, path + (k,))
                continue
            x = rng.standard_normal(tuple(v.shape)).astype(np.float32)
            out[k] = (1.0 + 0.1 * x) if k == "scale" else 0.05 * x
        return out

    return draw(shapes)


def _fwd_tokens(seed=1):
    return np.random.default_rng(seed).integers(0, 512, (2, 16)).astype(
        np.int32)


def _fg_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 500, n).tolist() for n in (12, 20, 7)]


def _stream_prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 500, 10).tolist() for _ in range(2)]


def _masked_batches(rows, steps):
    """A loss mask keeping every token of the first half of the positions
    and every third of the second, and none of the second half in
    micro-batch 3 (gas 2)."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(steps * 2):
        mask = np.ones((rows, SEQ), np.float32)
        mask[:, SEQ // 2:] = np.arange(SEQ // 2, SEQ) % 3 == 0
        if i == 3:
            mask[:, SEQ // 2:] = 0.0
        out.append({"tokens": rng.integers(0, 512, (rows, SEQ),
                                           dtype=np.int32),
                    "loss_mask": mask})
    return out


def _rows(mesh):
    return mesh.get("data", 1)


def _case_config(name):
    _, mesh, zero, *_, dtype = CASES[name]
    return _precision(dict(_engine_config(zero), mesh=mesh), dtype)


def _wait(path, what):
    deadline = time.monotonic() + 120
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"no {what} in 120 s"
        time.sleep(0.05)


# --------------------------------------------------------------------------- #
# JAX
# --------------------------------------------------------------------------- #

def _jax_forward(T, model):
    """JAX's logits, fused loss and its gradients at ``{tensor: T}``, the
    parameters sharded by the TP rules."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.models import transformer as JT
    from deepspeed_tpu.parallel.partitioning import ShardingPolicy

    cfg = JT.get_model_config(model, dtype="float32")
    mm = _jax_mesh({"tensor": T}, T)
    try:
        policy = ShardingPolicy(mm.mesh, 0)
        sh = policy.to_shardings(policy.tp_spec(JT.param_logical_axes(cfg)))
        params = jax.tree.map(jax.device_put, _np_params(model), sh)
        tok = jnp.asarray(_fwd_tokens())

        def loss(p):
            h, head, _ = JT.forward_hidden(p, tok, cfg)
            return JT.fused_lm_loss(h, head, tok)

        with mm.mesh:
            logits = jax.jit(lambda p: JT.forward(p, tok, cfg))(params)
            value, grads = jax.jit(jax.value_and_grad(loss))(params)
        return {"logits": np.asarray(logits), "loss": float(value),
                "grads": jax.tree.map(np.asarray, grads)}
    finally:
        JM.reset_mesh()


def _jax_engine(name):
    import deepspeed_tpu as dst

    world, mesh, _, model, _, dtype = CASES[name]
    mm = _jax_mesh(mesh, world)
    engine, *_ = dst.initialize(
        model=dst.causal_lm_spec(model, dtype=dtype),
        config=_case_config(name), mesh_manager=mm)
    return engine, mm


def _jax_fastgen():
    """JAX's FastGen at ``{tensor: 2}`` on the numpy parameters: greedy
    ``generate_all`` and a ``decode_stream`` of at least 16 tokens."""
    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.inference.fastgen import FastGenEngine as JaxFastGen
    from deepspeed_tpu.models import transformer as JT

    cfg = JT.get_model_config(FG_MODEL, dtype="float32")
    _jax_mesh({"tensor": 2}, 2)
    try:
        eng = JaxFastGen(cfg, params=_np_params(FG_MODEL),
                         use_pallas_kernel=False, **FG_KW)
        assert eng.mesh is not None
        out = {"greedy": eng.generate_all([1, 2, 3], _fg_prompts(),
                                          max_new_tokens=12)}
        eng = JaxFastGen(cfg, params=_np_params(FG_MODEL),
                         use_pallas_kernel=False, **FG_KW)
        out["stream"] = _drive_stream(eng)
        return out
    finally:
        JM.reset_mesh()


def _drive_stream(eng):
    """Two prompts prefilled by ``step()``, then ``decode_stream(8)``
    until 16 tokens came: {uid: tokens}."""
    eng.put([1, 2], _stream_prompts())
    while any(s.prefill_remaining > 0 for s in eng.seqs.values()):
        eng.step()
    got, n = {}, 0
    for emitted in eng.decode_stream(window=8):
        for uid, toks in emitted.items():
            got.setdefault(uid, []).extend(toks)
            n += len(toks)
        if n >= 16:
            break
    return got


def _jax_side(out, tmp):
    """JAX's forward cases and FastGen, then its resume of the port's
    ``{tensor: 2}`` tag (once world 2 has written it), in a process of its
    own (the conftest's 8 CPU devices come with its environment), so that
    they run beside the JAX engines."""
    try:
        res = {"fwd": {case: _jax_forward(*case) for case in FWD_CASES},
               "fastgen": _jax_fastgen()}
        _wait(os.path.join(tmp, "ckpt2_ready"), "{tensor: 2} tag")
        res["resumed"] = _jax_resume(tmp)
        out.put(("ok", res))
    except Exception:                                   # noqa: BLE001
        import traceback

        out.put(("error", traceback.format_exc()))


def _one_process_tag(tmp, master0):
    """A one-process port tag of ``ONE``'s model after one step (for the
    ranks at ``{tensor: 2}`` to load), its master and moments."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    *_, model, _, _ = CASES[ONE]
    M.reset_mesh()
    cfg = dict(_engine_config({"stage": 1}))
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(model, dtype="float32", remat="full"),
        config=cfg, device="cpu")
    load_master(engine, master0)
    engine.train_batch(iter(_masked_batches(1, 1)))
    engine.save_checkpoint(str(tmp / "one"), tag="one")
    out = {"master": gather_master(engine), "moments": {
        f"{m}{k}": v for m in engine._opt_names()
        for k, v in _leaves(engine._views(engine.state["opt"][m]))}}
    (tmp / "one_ready").write_text("1")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks started first (their op, forward, refusal and
    FastGen cases need nothing of JAX's), and JAX's forward and FastGen
    cases in a process of their own; JAX's initial master of each model
    pickled for the ranks' engines (the seed's, the same in every case of
    a model) and a one-process tag for world 2 to load, then JAX's
    engines → (JAX runs, {world: rank results}, tmp dir, the one-process
    tag's state)."""
    import jax
    import torch.multiprocessing as mp

    from deepspeed_tpu.comm import comm as JC
    from deepspeed_tpu.comm import mesh as JM

    from test_torch_zero import RANK_TIMEOUT

    if not JC.is_initialized():     # else the engine builds a mesh of all 8
        JC.init_distributed(verbose=False)
    tmp = tmp_path_factory.mktemp("tp")
    collect = {world: _spawn_start(_world_rank, world,
                                   tmp_path_factory.mktemp(f"tp{world}"),
                                   str(tmp))
               for world in WORLDS}
    side_out = mp.get_context("spawn").Queue()
    side = mp.get_context("spawn").Process(target=_jax_side,
                                           args=(side_out, str(tmp)))
    side.start()
    out = {"engine": {}}
    masters, one = {}, None
    for name, (world, mesh, _, model, *_) in CASES.items():
        engine, mm = _jax_engine(name)
        m0 = jax.tree.map(np.asarray, engine.state["master"])
        if model not in masters:
            masters[model] = m0
            path = tmp / f"master0_{model}.pkl"
            part = path.with_suffix(".part")
            part.write_bytes(pickle.dumps(m0))
            part.rename(path)
            if model == CASES[ONE][3]:
                one = _one_process_tag(tmp, m0)
        data = iter(_masked_batches(_rows(mesh), STEPS))
        losses, norms = [], []
        for _ in range(STEPS):
            losses.append(float(engine.train_batch(data)))
            norms.append(engine.get_global_grad_norm())
        out["engine"][name] = {
            "master0_same": all(np.array_equal(a, b) for (_, a), (_, b) in
                                zip(_leaves(masters[model]), _leaves(m0))),
            "losses": losses, "norms": norms, "wire": engine._wire_format(),
            "train_batch_size": engine.train_batch_size(),
            "dp_world_size": engine.dp_world_size,
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

def _ops_rank(rank, T):
    """The conjugate ops at ``{tensor: T}``: each op's output and input
    gradient, and the ``tensor`` group's traffic of each."""
    import torch

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm import mesh as M

    tp = M.initialize_mesh(M.MeshConfig(tensor=T)).tensor()
    assert (tp.size, tp.rank) == (T, rank)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((T, 3, 8)).astype(np.float32)
    w = rng.standard_normal((T, 3, 8 * T)).astype(np.float32)
    out = {}
    for op in ("copy", "reduce", "gather"):
        dtt.comm.reset_traffic()
        if op == "copy":     # a replicated x, each rank's own weights
            xi = torch.from_numpy(x[0].copy()).requires_grad_(True)
            y = comm.copy_to_tensor(xi, tp.group)
            (y * torch.from_numpy(w[rank][:, :8])).sum().backward()
        elif op == "reduce":   # each rank's own x, one weight
            xi = torch.from_numpy(x[rank].copy()).requires_grad_(True)
            y = comm.reduce_from_tensor(xi, tp.group)
            (y * torch.from_numpy(w[0][:, :8])).sum().backward()
        else:
            xi = torch.from_numpy(x[rank].copy()).requires_grad_(True)
            y = comm.gather_from_tensor(xi, tp.group)
            (y * torch.from_numpy(w[0])).sum().backward()
        out[op] = {"y": y.detach().numpy(), "dx": xi.grad.numpy(),
                   "traffic": {k: v[:2] for k, v in
                               dtt.comm.traffic.items()}}
    M.reset_mesh()
    return out


def _forward_rank(rank, T, model):
    """``forward`` and ``fused_lm_loss`` on this rank's slices at
    ``{tensor: T}``: the logits, the loss, the gradient of every slice."""
    import torch

    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.models import transformer as PT
    from deepspeed_tpu_torch.models.convert import tp_local_tree

    tp = M.initialize_mesh(M.MeshConfig(tensor=T)).tensor()
    cfg = PT.get_model_config(model, dtype="float32")
    mine = tp_local_tree(_np_params(model), cfg, T, rank)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)

    params = leaf(mine)
    tok = torch.from_numpy(_fwd_tokens())
    with torch.no_grad():
        logits = PT.forward(params, tok, cfg, tp=tp)
    h, head, _ = PT.forward_hidden(params, tok, cfg, tp=tp)
    loss = PT.fused_lm_loss(h, head, tok, tp=tp)
    loss.backward()
    M.reset_mesh()
    return {"logits": logits.numpy(), "loss": float(loss.detach()),
            "grads": {k: v.grad.numpy() for k, v in _flat(params)}}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", tree[k]


def _engine_rank(rank, world, master0, name, ckpt_dir):
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master, load_master

    _, mesh, zero, model, attention, dtype = CASES[name]
    spec = dtt.causal_lm_spec(model, dtype=dtype, remat="full",
                              attention=attention)
    engine, *_ = dtt.initialize(model=spec, config=_case_config(name),
                                device="cpu")
    load_master(engine, master0)
    data = iter(_masked_batches(_rows(mesh), STEPS + 1))
    dtt.comm.reset_traffic()
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(float(engine.train_batch(data)))
        norms.append(engine.get_global_grad_norm())
    traffic = {k: list(v) for k, v in dtt.comm.traffic.items()}
    out = {"type": type(engine).__name__, "losses": losses, "norms": norms,
           "master": gather_master(engine), "wire": engine._wire_format(),
           "train_batch_size": engine.train_batch_size(),
           "dp_world_size": engine.dp_world_size,
           "tp": (engine.tp, engine.mesh_manager.tp_rank),
           "traffic": traffic}
    if ckpt_dir is not None:
        engine.save_checkpoint(ckpt_dir, tag="tp")
        if rank == 0:
            with open(ckpt_dir + "_ready", "w") as f:
                f.write("1")
        out["ckpt_moments"] = {
            f"{m}{k}": v for m in engine._opt_names()
            for k, v in _leaves(engine.full_tree(engine.state["opt"][m]))}
        out["next_loss"] = float(engine.train_batch(data))
    engine.close()
    return out


def _one_into_tensor2_rank(tmp):
    """The one-process tag loaded at ``{tensor: 2}``: the gathered master
    and moments."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.convert import gather_master

    _wait(os.path.join(tmp, "one_ready"), "one-process tag")
    *_, model, _, _ = CASES[ONE]
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(model, dtype="float32", remat="full"),
        config=dict(_engine_config({"stage": 1}), mesh={"tensor": 2}),
        device="cpu")
    engine.load_checkpoint(os.path.join(tmp, "one"), tag="one")
    out = {"master": gather_master(engine), "moments": {
        f"{m}{k}": v for m in engine._opt_names()
        for k, v in _leaves(engine.full_tree(engine.state["opt"][m]))},
        "global_steps": engine.global_steps}
    engine.close()
    return out


def _refused_rank(name):
    """The error a composition left out raises (at ``initialize``, or at
    the first step for a spec option the loss meets)."""
    import deepspeed_tpu_torch as dtt

    _, mesh, extra, model, spec_kw, _ = REFUSED[name]
    cfg = dict(_engine_config({"stage": 1}), mesh=mesh)
    cfg.update(extra)
    try:
        engine, *_ = dtt.initialize(
            model=dtt.causal_lm_spec(model, dtype="float32", **spec_kw),
            config=cfg, device="cpu")
        engine.train_batch(iter(_masked_batches(_rows(mesh), 1)))
    except NotImplementedError as e:
        return str(e)
    return None


def _fastgen_rank(rank):
    """FastGen at ``{tensor: 2}`` on the numpy parameters: greedy
    ``generate_all``, a ``decode_stream``, the ``tensor`` group's traffic a
    tick, the kernel wrappers' run, and JAX's three meanings of ``tp``."""
    import torch

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.inference.fastgen import FastGenEngine
    from deepspeed_tpu_torch.models import transformer as PT

    M.initialize_mesh(M.MeshConfig(tensor=2))
    kw = dict(FG_KW, device="cpu", dtype="float32")
    params = _np_params(FG_MODEL)
    out = {}
    eng = FastGenEngine(FG_MODEL, params=params, **kw)
    dtt.comm.reset_traffic()
    out["greedy"] = eng.generate_all([1, 2, 3], _fg_prompts(),
                                     max_new_tokens=12)
    out["ticks"] = sum(eng.device_ticks.values())
    out["traffic"] = {k: v[:2] for k, v in dtt.comm.traffic.items()}
    out["tp"] = (eng.tp.size, eng.tp.rank)
    out["pool_heads"] = eng.pool["k"].shape[3]
    out["graphs"] = eng._graphs
    out["stream"] = _drive_stream(FastGenEngine(FG_MODEL, params=params,
                                                **kw))
    # the kernels' wrappers (their plain versions for CPU tensors) where
    # JAX refuses its Pallas kernel under TP
    eng = FastGenEngine(FG_MODEL, params=params, use_kernels=True, tp=True,
                        **kw)
    out["kernels"] = (eng._use_kernels, eng.tp is not None,
                      eng.generate_all([1, 2, 3], _fg_prompts(),
                                       max_new_tokens=12))
    cfg = PT.get_model_config("tiny", dtype="float32", num_kv_heads=1)
    small = dict(kw, n_blocks=16, max_blocks_per_seq=4, token_budget=64)
    small.pop("dtype")
    try:
        FastGenEngine(cfg, tp=True, **small)
        out["tp_true_kv1"] = None
    except NotImplementedError as e:
        out["tp_true_kv1"] = str(e)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = FastGenEngine(cfg, **small)
    out["tp_none_kv1"] = (eng.tp is None,
                          [str(w.message) for w in caught])
    out["tp_false"] = FastGenEngine(FG_MODEL, params=params, tp=False,
                                    **kw).tp is None
    try:        # each rank's clock would expire a request on its own
        FastGenEngine(FG_MODEL, params=params, request_deadline_s=5.0, **kw)
        out["deadline"] = None
    except NotImplementedError as e:
        out["deadline"] = str(e)
    M.reset_mesh()
    del torch
    return out


def _world_rank(rank, world, tmp):
    """Every case of one world, in one spawn: the op, forward, refusal and
    FastGen cases first (no JAX input), then the engines from JAX's
    initial masters, the one-process tag at world 2 last."""
    import torch

    torch.set_num_threads(1)
    out = {"ops": _ops_rank(rank, world) if world in OPS_WORLDS else None,
           "fwd": {case: _forward_rank(rank, *case) for case in FWD_CASES
                   if case[0] == world},
           "refused": {name: _refused_rank(name)
                       for name, case in REFUSED.items()
                       if case[0] == world},
           "fastgen": _fastgen_rank(rank) if world == 2 else None}
    masters = {}
    out["engine"] = {}
    for name, case in CASES.items():
        if case[0] != world:
            continue
        path = os.path.join(tmp, f"master0_{case[3]}.pkl")
        _wait(path, "JAX master")
        if path not in masters:
            masters[path] = pickle.loads(open(path, "rb").read())
        ckpt = (os.path.join(tmp, f"ckpt{world}") if CKPT.get(world) == name
                else None)
        out["engine"][name] = _engine_rank(rank, world, masters[path], name,
                                           ckpt)
    if world == 2:
        out["one_into_t2"] = _one_into_tensor2_rank(tmp)
    return out


# --------------------------------------------------------------------------- #
# the checks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("T,op", [(T, op) for T in OPS_WORLDS
                                  for op in ("copy", "reduce", "gather")])
def test_conjugate_ops(T, op, runs):
    """copy: identity forward, the ranks' gradients summed backward;
    reduce: the ranks' inputs summed forward, the gradient passed back;
    gather: the ranks' slices concatenated, each rank's slice of the
    gradient back. One collective each on the ``tensor`` group."""
    _, port, _, _ = runs
    rng = np.random.default_rng(7)
    x = rng.standard_normal((T, 3, 8)).astype(np.float32)
    w = rng.standard_normal((T, 3, 8 * T)).astype(np.float32)
    for r, res in enumerate(p["ops"][op] for p in port[T]):
        if op == "copy":
            want_y, want_dx = x[0], w[:, :, :8].sum(axis=0)
            kind = "tensor/all_reduce"
        elif op == "reduce":
            want_y, want_dx = x.sum(axis=0), w[0][:, :8]
            kind = "tensor/all_reduce"
        else:
            want_y = np.concatenate(list(x), axis=1)
            want_dx = w[0][:, r * 8:(r + 1) * 8]
            kind = "tensor/all_gather"
        np.testing.assert_allclose(res["y"], want_y, atol=1e-6, rtol=0)
        np.testing.assert_allclose(res["dx"], want_dx, atol=1e-5, rtol=0)
        assert res["traffic"] == {kind: [1, 24]}, res["traffic"]


@pytest.mark.parametrize("T,model", FWD_CASES)
def test_forward_and_fused_loss_match_jax(T, model, runs):
    """Every rank's logits (gathered: the whole vocab), the fused loss and
    the gradient of its slices, against JAX at ``{tensor: T}``."""
    from deepspeed_tpu_torch.models import transformer as PT
    from deepspeed_tpu_torch.parallel.partitioning import tp_slice

    jruns, port, _, _ = runs
    want = jruns["fwd"][(T, model)]
    cfg = PT.get_model_config(model, dtype="float32")
    axes = dict(_flat(PT.param_logical_axes(cfg)))
    grads = dict(_leaves(want["grads"]))
    for r, got in enumerate(p["fwd"][(T, model)] for p in port[T]):
        np.testing.assert_allclose(got["logits"], want["logits"], atol=ATOL,
                                   rtol=0)
        assert abs(got["loss"] - want["loss"]) <= ATOL
        assert sorted(got["grads"]) == sorted(grads)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(
                g, tp_slice(axes[k], grads[k], T, r), atol=ATOL, rtol=0,
                err_msg=f"{model} T={T} rank {r} {k}")


@pytest.mark.parametrize("name", [n for n in CASES if n not in BF16])
def test_engine_tensor_axis_matches_jax_engine(name, runs):
    jruns, port, _, _ = runs
    world, mesh, zero, *_ = CASES[name]
    want = jruns["engine"][name]
    assert want["master0_same"]
    tol = TOL["exact"]
    ranks = [r["engine"][name] for r in port[world]]
    for r, got in enumerate(ranks):
        assert got["type"] == ("Zero3Engine" if zero["stage"] == 3
                               else "DataParallelEngine")
        assert got["wire"] == want["wire"] == "exact"
        assert got["tp"] == (2, r % 2)
        # the batch triad over data x zshard x expert, as JAX's
        assert (got["train_batch_size"], got["dp_world_size"]) == (
            want["train_batch_size"], want["dp_world_size"])
        assert got["losses"] == ranks[0]["losses"], (name, r)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=tol["loss"], atol=0, err_msg=name)
        np.testing.assert_allclose(got["norms"], want["norms"], atol=0,
                                   rtol=tol["loss"], err_msg=name)
        mine, theirs = dict(_leaves(got["master"])), dict(
            _leaves(want["master"]))
        assert sorted(mine) == sorted(theirs)
        diff = np.concatenate([np.abs(mine[k] - theirs[k]).ravel()
                               for k in theirs])
        assert diff.max() <= tol["master"], (name, r, diff.max())
        assert diff.mean() <= tol["master_mean"], (name, r, diff.mean())
        # the Megatron sums on the tensor group; no gradient reduced there
        assert got["traffic"]["tensor/all_reduce"][0] > 0
        assert not [k for k in got["traffic"]
                    if k.startswith("tensor/") and k != "tensor/all_reduce"]


@pytest.mark.parametrize("name", list(BF16))
def test_bf16_engine_tensor_axis_matches_jax(name, runs):
    """bf16 at ``{tensor: 2}``: each rank's losses and master no further
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
def test_tensor_combinations_left_out_raise(name, runs):
    _, port, _, _ = runs
    world, *_, what = REFUSED[name]
    for r in port[world]:
        msg = r["refused"][name]
        assert msg is not None, name
        assert "later slice" in msg and "queue A.4" in msg, msg
        assert what in msg, msg


def test_fastgen_tp2_greedy_matches_jax(runs):
    """JAX's ``test_tp2_greedy_parity`` at ``{tensor: 2}``: token for token,
    the same on both ranks; the pool holds a rank's KV heads; a tick's
    ``tensor`` traffic is 2L + 1 all-reduces and the logits' gather; the
    ticks run eagerly (no graph on the CPU either way)."""
    from deepspeed_tpu_torch.models import transformer as PT

    jruns, port, _, _ = runs
    cfg = PT.get_model_config(FG_MODEL)
    want = jruns["fastgen"]["greedy"]
    for r, got in enumerate(p["fastgen"] for p in port[2]):
        assert got["greedy"] == want, r
        assert got["tp"] == (2, r)
        assert got["pool_heads"] == cfg.kv_heads // 2
        assert not got["graphs"]
        n = got["ticks"]
        assert got["traffic"]["tensor/all_reduce"][0] == \
            (2 * cfg.num_layers + 1) * n
        assert got["traffic"]["tensor/all_gather"][0] == n


def test_fastgen_tp2_decode_stream_matches_jax(runs):
    jruns, port, _, _ = runs
    want = jruns["fastgen"]["stream"]
    assert sum(len(v) for v in want.values()) >= 16
    for got in (p["fastgen"]["stream"] for p in port[2]):
        assert got == want


def test_fastgen_tp_meanings(runs):
    """tp=True with kv_heads 1 at tensor 2 raises naming kv_heads; tp=None
    warns "serving replicated" and serves the whole model; the kernel
    wrappers serve under TP (where JAX refuses its Pallas kernel) to the
    same tokens; tp=False never engages; a request deadline under TP
    raises (a later slice)."""
    _, port, _, _ = runs
    for got in (p["fastgen"] for p in port[2]):
        assert got["tp_true_kv1"] is not None
        assert "kv_heads" in got["tp_true_kv1"]
        replicated, msgs = got["tp_none_kv1"]
        assert replicated and any("serving replicated" in m for m in msgs)
        use_kernels, engaged, tokens = got["kernels"]
        assert use_kernels and engaged and tokens == got["greedy"]
        assert got["tp_false"]
        assert got["deadline"] is not None and "later slice" in \
            got["deadline"]


def test_fastgen_tp_true_in_one_process_serves_whole():
    """As in JAX, ``tp=True`` without a live tensor axis serves the whole
    model on this process."""
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.inference.fastgen import FastGenEngine

    M.reset_mesh()
    kw = dict(FG_KW, device="cpu", dtype="float32", token_budget=32)
    params = _np_params(FG_MODEL)
    eng = FastGenEngine(FG_MODEL, params=params, tp=True, **kw)
    assert eng.tp is None
    ref = FastGenEngine(FG_MODEL, params=params, **kw)
    prompts = _fg_prompts()
    assert eng.generate_all([1, 2, 3], prompts, max_new_tokens=4) == \
        ref.generate_all([1, 2, 3], prompts, max_new_tokens=4)


@pytest.mark.parametrize("world", [2, 4])
def test_tensor_checkpoint_loads_into_one_process(world, runs):
    """The tag of a ``{tensor: 2}`` (``{data: 2, tensor: 2}`` ZeRO-3)
    engine holds every leaf at its global shape: one process loads its
    master and both moments bit-equal."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.models.convert import gather_master

    _, port, tmp, _ = runs
    name = CKPT[world]
    _, mesh, _, model, *_ = CASES[name]
    got = port[world][0]["engine"][name]
    M.reset_mesh()
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(model, dtype="float32", remat="full"),
        config=dict(_engine_config({"stage": 1}),
                    train_micro_batch_size_per_gpu=_rows(mesh)),
        device="cpu")
    engine.load_checkpoint(str(tmp / f"ckpt{world}"), tag="tp")
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


def test_one_process_checkpoint_loads_into_tensor2(runs):
    _, port, _, one = runs
    for got in (p["one_into_t2"] for p in port[2]):
        assert got["global_steps"] == 1
        mine, theirs = dict(_leaves(got["master"])), dict(
            _leaves(one["master"]))
        assert sorted(mine) == sorted(theirs)
        assert all(np.array_equal(mine[k], theirs[k]) for k in theirs)
        assert sorted(got["moments"]) == sorted(one["moments"])
        assert all(np.array_equal(np.asarray(got["moments"][k]),
                                  np.asarray(one["moments"][k]))
                   for k in one["moments"])


def _jax_resume(tmp):
    """JAX at ``{tensor: 2}`` loads the port's ``{tensor: 2}`` tag (native,
    writer fast) and takes the next step; then the tag's universal
    conversion (the port's converter) loaded into the same JAX engine."""
    import jax

    import deepspeed_tpu as dst
    from deepspeed_tpu.comm import comm as JC
    from deepspeed_tpu.comm import mesh as JM

    from deepspeed_tpu_torch.checkpoint.universal import convert_to_universal

    name = CKPT[2]
    _, mesh, _, model, *_ = CASES[name]
    ckpt = os.path.join(tmp, "ckpt2")
    uni = convert_to_universal(ckpt, os.path.join(tmp, "universal2"),
                               tag="tp")
    if not JC.is_initialized():
        JC.init_distributed(verbose=False)
    mm = _jax_mesh(mesh, 2)
    try:
        cfg = dict(_case_config(name), checkpoint={"writer": "fast"})
        engine, *_ = dst.initialize(
            model=dst.causal_lm_spec(model, dtype="float32"), config=cfg,
            mesh_manager=mm)
        engine.load_checkpoint(ckpt, tag="tp")
        steps = engine.global_steps
        data = iter(_masked_batches(_rows(mesh), STEPS + 1)[2 * STEPS:])
        loss = float(engine.train_batch(data))
        engine.load_universal_checkpoint(uni)
        master = jax.tree.map(np.asarray, engine.state["master"])
        return {"steps": steps, "loss": loss, "uni_master": master,
                "uni": uni}
    finally:
        JM.reset_mesh()


@pytest.fixture(scope="module")
def jax_resumed(runs):
    return runs[0]["resumed"]


def test_jax_resumes_a_port_tensor2_checkpoint(runs, jax_resumed):
    _, port, _, _ = runs
    got = port[2][0]["engine"][CKPT[2]]
    assert jax_resumed["steps"] == STEPS
    np.testing.assert_allclose(jax_resumed["loss"], got["next_loss"],
                               rtol=TOL["exact"]["loss"], atol=0)


def test_universal_from_tensor2_loads_in_both_packages(runs, jax_resumed):
    """The universal conversion of the ``{tensor: 2}`` tag: JAX's engine
    and a one-process port engine each load the ranks' master bit for
    bit."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.comm import mesh as M
    from deepspeed_tpu_torch.models.convert import gather_master

    _, port, _, _ = runs
    name = CKPT[2]
    model = CASES[name][3]
    theirs = dict(_leaves(port[2][0]["engine"][name]["master"]))
    jax_master = dict(_leaves(jax_resumed["uni_master"]))
    assert all(np.array_equal(jax_master[k], theirs[k]) for k in theirs)
    M.reset_mesh()
    engine, *_ = dtt.initialize(
        model=dtt.causal_lm_spec(model, dtype="float32", remat="full"),
        config=_engine_config({"stage": 1}), device="cpu")
    engine.load_universal_checkpoint(jax_resumed["uni"])
    mine = dict(_leaves(gather_master(engine)))
    assert sorted(mine) == sorted(theirs)
    assert all(np.array_equal(mine[k], theirs[k]) for k in theirs)
    assert engine.global_steps == STEPS


@pytest.mark.parametrize("mesh", [{"tensor": 2}, {"data": 2, "tensor": 2},
                                  {"data": 4, "tensor": 2}])
def test_tp_slices_and_zero_specs_match_jax(mesh):
    """Each leaf's TP spec and ZeRO-1 spec of ``tiny_llama`` as JAX's
    policy gives them at the mesh; a rank's slice is its tensor
    coordinate's piece of the leaf's tensor dim."""
    from deepspeed_tpu.comm import mesh as JM
    from deepspeed_tpu.models import transformer as JT
    from deepspeed_tpu.parallel.partitioning import ShardingPolicy as JS

    from deepspeed_tpu_torch.comm.mesh import MeshConfig, MeshManager
    from deepspeed_tpu_torch.models import transformer as PT
    from deepspeed_tpu_torch.parallel.partitioning import (
        ShardingPolicy,
        tp_dim,
    )

    world = int(np.prod(list(mesh.values())))
    cfg = JT.get_model_config("tiny_llama")
    params = _np_params("tiny_llama")
    mm = _jax_mesh(mesh, world)
    try:
        jpol = JS(mm.mesh, 1)
        axes = JT.param_logical_axes(cfg)
        jtp = dict(_flat(jpol.tp_spec(axes)))
        import jax
        shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                             a.dtype),
                              params)
        jzero = dict(_flat(jpol.zero_spec(axes, shapes)))
    finally:
        JM.reset_mesh()
    sizes = MeshConfig(**mesh).resolve(world)
    pcfg = PT.get_model_config("tiny_llama")
    paxes = PT.param_logical_axes(pcfg)
    pol = ShardingPolicy(sizes, 1)
    ptp = dict(_flat(pol.tp_spec(paxes, params)))
    pzero = dict(_flat(pol.zero_spec(paxes, params)))
    for k in jtp:
        assert ptp[k] == tuple(jtp[k]) + (None,) * (len(ptp[k])
                                                    - len(jtp[k])), k
        assert pzero[k] == tuple(jzero[k]) + (None,) * (
            len(pzero[k]) - len(jzero[k])), k
    for r in range(world):
        coord = MeshManager(sizes, r).coords["tensor"]
        assert coord == r % 2
    assert {k for k, a in _flat(paxes) if tp_dim(a) is not None} == {
        k for k, s in ptp.items() if "tensor" in s}


@pytest.mark.parametrize("model", ["tiny_llama", "tiny"])
def test_params_from_numpy_cuts_a_whole_tree_once(model):
    """``params_from_numpy(tp=)`` (FastGen's path under TP) gives each
    leaf the rank's piece of its tensor dim, and a tree already cut goes
    through it unchanged."""
    import torch

    from deepspeed_tpu_torch.comm.mesh import TensorGroup
    from deepspeed_tpu_torch.models import transformer as PT
    from deepspeed_tpu_torch.models.convert import params_from_numpy
    from deepspeed_tpu_torch.parallel.partitioning import tp_dim

    cfg = PT.get_model_config(model, dtype="float32")
    tree = _np_params(model)
    axes = dict(_flat(PT.param_logical_axes(cfg)))
    whole = dict(_flat(tree))
    for rank in range(2):
        tp = TensorGroup(None, 2, rank)
        once = params_from_numpy(tree, cfg, "cpu", tp=tp).tree()
        twice = dict(_flat(params_from_numpy(once, cfg, "cpu",
                                             tp=tp).tree()))
        for k, got in _flat(once):
            dim = tp_dim(axes[k])
            want = whole[k]
            if dim is not None:
                n = want.shape[dim] // 2
                want = np.take(want, range(rank * n, (rank + 1) * n),
                               axis=dim)
            assert np.array_equal(got.numpy(), want), (k, rank)
            assert torch.equal(twice[k], got), (k, rank)
