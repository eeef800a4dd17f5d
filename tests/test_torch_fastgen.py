"""FastGen of the PyTorch port against the JAX package (greedy token for
token), and its host scheduling: decode windows, flush, rollback on a
failed tick, deadlines, and the options that come in later slices."""
import time

import numpy as np
import pytest

import jax

from deepspeed_tpu.inference.fastgen import FastGenEngine as JaxFastGen
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.inference.fastgen import FastGenEngine
from deepspeed_tpu_torch.models import transformer as PT

# a pool of 9 usable blocks for 13 blocks of demand (backpressure), and a
# 70-token prompt over a 32-token budget (SplitFuse across ticks)
ENGINE = dict(n_blocks=10, block_size=16, max_blocks_per_seq=8,
              token_budget=32, temperature=0.0, seed=0)
LENS = [5, 19, 70, 33]


def _prompts(seed=0, lens=LENS, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _jax_params(name):
    cfg = JT.get_model_config(name, dtype="float32")
    return jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.PRNGKey(0)))


def _engine(name="tiny_llama", params=None, **kw):
    cfg = PT.get_model_config(name, dtype="float32")
    params = _jax_params(name) if params is None else params
    return FastGenEngine(cfg, params=params, device="cpu", **{**ENGINE, **kw})


@pytest.mark.parametrize("name", ["tiny_llama", "tiny"])
def test_greedy_generate_all_matches_jax(name):
    params = _jax_params(name)
    uids = [1, 2, 3, 4]
    prompts = _prompts()
    want = JaxFastGen(JT.get_model_config(name, dtype="float32"),
                      params=params, use_pallas_kernel=False,
                      **ENGINE).generate_all(uids, prompts, max_new_tokens=12,
                                             planned=False)
    preempt = telemetry.counter("fastgen_preemptions_total")
    before = preempt.total()
    eng = _engine(name, params)
    got = eng.generate_all(uids, prompts, max_new_tokens=12)
    assert got == want
    assert all(len(v) == 12 for v in got.values())
    assert preempt.total() > before          # the small pool pushed back
    assert eng.allocator.free_blocks == ENGINE["n_blocks"] - 1
    snap = telemetry.snapshot()               # the fastgen_* catalog
    assert any(k.startswith("fastgen_ticks_total{") for k in snap["counters"])
    assert snap["histograms"]['fastgen_ttft_seconds']["count"] >= 4
    assert len(eng.ttft_log) == 4


def _prefill_all(eng, uids, prompts):
    eng.put(uids, prompts)
    while not all(s.prefill_remaining == 0 and s.last_tok is not None
                  for s in eng.seqs.values()):
        eng.step()


def test_decode_steps_equals_the_same_number_of_step_ticks():
    uids, prompts = [1, 2, 3], _prompts(1, [9, 20, 12])
    a, b = _engine(n_blocks=32), _engine(n_blocks=32)
    _prefill_all(a, uids, prompts)
    _prefill_all(b, uids, prompts)
    window = a.decode_steps(8)
    assert sorted(window) == uids and all(len(v) == 8
                                          for v in window.values())
    ticks = {u: [] for u in uids}
    for _ in range(8):
        for u, tok in b.step().items():
            ticks[u].append(tok)
    assert window == ticks
    assert [s.pos for s in a.seqs.values()] == \
        [s.pos for s in b.seqs.values()]


def test_decode_window_returns_nothing_while_prefill_is_pending():
    eng = _engine()
    eng.put([1], _prompts(2, [40]))
    assert eng.decode_steps(8) == {}


def test_blocks_restored_after_flush():
    eng = _engine(n_blocks=32)
    free = eng.allocator.free_blocks
    uids, prompts = [5, 6], _prompts(3, [30, 17])
    _prefill_all(eng, uids, prompts)
    assert eng.allocator.free_blocks < free
    assert eng.kv_utilization() > 0
    eng.flush(uids)
    assert eng.allocator.free_blocks == free
    assert eng.seqs == {} and eng.kv_utilization() == 0


def test_failed_tick_rolls_back_host_state():
    uids, prompts = [1, 2], _prompts(4, [40, 7])
    eng = _engine(n_blocks=32)
    eng.put(uids, prompts)
    eng.step()

    def state():
        return ([(s.prefilled, s.pos, list(s.blocks), s.table.tolist(),
                  list(s.generated), s.last_tok, s.done)
                 for s in eng.seqs.values()],
                list(eng.allocator._free), eng._decode_rr)

    before = state()
    real_tick = eng._tick

    def boom(*a, **k):
        raise RuntimeError("injected device fault")

    eng._tick = boom
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    assert state() == before
    eng._tick = real_tick                    # the tick is retryable
    eng._generate_dynamic(uids, 6)
    ref = _engine(n_blocks=32)
    assert {u: eng.query(u)[1][:6] for u in uids} == \
        ref.generate_all(uids, prompts, max_new_tokens=6)


def test_deadline_expires_a_request():
    eng = _engine(n_blocks=32, request_deadline_s=0.0)
    expired = telemetry.counter("fastgen_deadline_expired_total")
    before = expired.total()
    eng.put([7], _prompts(5, [20]))
    time.sleep(0.01)
    assert eng.step() == {}
    assert eng.expired(7) and eng.query(7) == (True, [])
    assert eng.allocator.free_blocks == 31
    assert expired.total() == before + 1
    assert not eng.expired(12345)            # unknown uid: an answer


def test_put_is_batch_atomic():
    eng = _engine()
    eng.put([1], _prompts(6, [5]))
    with pytest.raises(ValueError, match="still active"):
        eng.put([2, 1], _prompts(6, [5, 5]))
    assert list(eng.seqs) == [1]
    with pytest.raises(ValueError, match="max_len"):
        eng.put([3], [[1] * 200])


def test_rematerialize_and_temperature_sampling():
    uids, prompts = [1, 2], _prompts(7, [6, 11])
    outs = []
    for _ in range(2):
        eng = _engine(temperature=0.8, top_k=20, top_p=0.9, seed=3)
        eng.put(uids, prompts)
        for _ in range(4):
            eng.step()
        snap = eng.rematerialize(1)
        assert snap["prompt"] == prompts[0] and snap["prefilled"] == 6
        outs.append({u: eng.query(u)[1] for u in uids})
        assert all(0 <= t < 512 for v in outs[-1].values() for t in v)
    assert outs[0] == outs[1]                # one seed, one stream
    assert eng.rematerialize(99) is None


@pytest.mark.parametrize("call", ["planned", "serve_planned", "quantized"])
def test_later_slice_options_raise(call):
    # (tp=True runs: tests/test_torch_tensor_parallel.py)
    with pytest.raises(NotImplementedError, match="later slice"):
        if call == "quantized":
            params = _jax_params("tiny_llama")
            params["lm_head"] = {"q": params["lm_head"], "scale": 1.0}
            _engine(params=params)
        else:
            eng = _engine()
            if call == "planned":
                eng.generate_all([1], _prompts(8, [4]), 2, planned=True)
            else:
                eng.serve_planned(4)


def test_engine_initialises_its_own_params_on_the_cpu():
    eng = FastGenEngine("tiny", device="cpu", dtype="float32", n_blocks=16,
                        block_size=16, max_blocks_per_seq=4, token_budget=16)
    assert eng._use_kernels is False
    assert all(p.device.type == "cpu" for p in eng.model.parameters())
    out = eng.generate_all([1, 2], _prompts(9, [3, 8]), max_new_tokens=4)
    assert all(len(v) == 4 for v in out.values())
