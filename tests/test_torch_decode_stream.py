"""decode_stream of the port's FastGen against the JAX package's (greedy,
token for token: windows, ``generated``, ``done``), its guards while a
window is in flight, and the parts of the CUDA-graph path that run on the
CPU: the warm-up tick's inputs and the replay's launch counting."""
import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.inference.fastgen import FastGenEngine as JaxFastGen
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.inference import graphs
from deepspeed_tpu_torch.inference.fastgen import FastGenEngine
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import norms
from deepspeed_tpu_torch.ops import paged_attention as PA

MODEL = "tiny_llama"
# the JAX package's decode_stream tests' settings (tests/unit/test_fastgen.py)
STREAM = dict(n_blocks=64, block_size=16, max_blocks_per_seq=8,
              token_budget=32, temperature=0.0, seed=0)
# max_len 128 and window 8: after prefill both rows sit at a position = 7
# (mod 8) (uid 1 decodes once while uid 2's prompt ends), so each reaches
# max_len - 1 after whole windows and the cutoff fires on a drained tick
TAIL = dict(STREAM, token_budget=128)
UIDS, LENS = [1, 2, 3], [7, 21, 13]
TAIL_UIDS, TAIL_LENS = [1, 2], [102, 95]


def _prompts(seed, lens, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _prefill(eng, uids, prompts):
    eng.put(uids, prompts)
    while any(eng.seqs[u].prefill_remaining > 0 for u in uids):
        eng.step()


def _state(eng, uids):
    return {u: (list(eng.seqs[u].generated), eng.seqs[u].done,
                eng.seqs[u].pos, eng.seqs[u].expired) for u in uids}


def _stream(eng, window=8, stop_after=None):
    """The windows one stream yields, closed after ``stop_after``."""
    served = []
    for emitted in eng.decode_stream(window=window):
        served.append(emitted)
        if stop_after is not None and len(served) == stop_after:
            break
    return served


def _exhaust(eng, uids, rounds=40):
    """Re-enter the stream until it yields nothing or every row is done."""
    windows = []
    for _ in range(rounds):
        served = _stream(eng)
        windows += served
        if not served or all(eng.seqs[u].done for u in uids):
            break
    return windows


def _scenarios(make):
    """Run every scenario on engines from ``make(settings)``, the same
    calls for both packages → {scenario: result}."""
    out = {}
    prompts = _prompts(5, LENS)
    eng = make(STREAM)
    # (a) three windows, closed early: the window in flight still drains;
    # then streams to the length wall
    _prefill(eng, UIDS, prompts)
    out["early"] = _stream(eng, stop_after=3), _state(eng, UIDS)
    out["wall"] = _exhaust(eng, UIDS), _state(eng, UIDS)
    # an EOS found one window late ends the chain after draining the
    # window in flight
    eos = out["early"][1][2][0][12]
    eng.flush(UIDS)
    eng.eos_token_id = eos
    _prefill(eng, UIDS, prompts)
    out["eos"] = _exhaust(eng, UIDS), _state(eng, UIDS)
    eng.flush(UIDS)
    eng.eos_token_id = None
    # (c) expired deadlines: one at the stream's entry, one mid-stream
    eng.put([7], _prompts(13, [8]), deadline_s=60.0)
    eng.step()
    eng.seqs[7].deadline = 0.0
    out["expired_at_entry"] = (_stream(eng, window=4), _state(eng, [7]),
                               list(eng.seqs[7].blocks))
    _prefill(eng, [8, 9], _prompts(14, [10, 12]))
    gen = eng.decode_stream(window=8)
    first = next(gen)
    eng.seqs[9].deadline = 0.0
    out["expired_mid_stream"] = [first] + list(gen), _state(eng, [8, 9])
    # (b) the max-len tail
    tail = make(TAIL)
    _prefill(tail, TAIL_UIDS, _prompts(6, TAIL_LENS))
    out["tail"] = _exhaust(tail, TAIL_UIDS), _state(tail, TAIL_UIDS)
    return out


@pytest.fixture(scope="module")
def params():
    cfg = JT.get_model_config(MODEL, dtype="float32")
    return jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_runs(params):
    cfg = JT.get_model_config(MODEL, dtype="float32")
    return _scenarios(lambda kw: JaxFastGen(cfg, params=params,
                                            use_pallas_kernel=False, **kw))


@pytest.fixture(scope="module")
def port_runs(params):
    cfg = PT.get_model_config(MODEL, dtype="float32")
    return _scenarios(lambda kw: FastGenEngine(cfg, params=params,
                                               device="cpu", **kw))


def _engine(params, **kw):
    cfg = PT.get_model_config(MODEL, dtype="float32")
    return FastGenEngine(cfg, params=params, device="cpu", **{**STREAM, **kw})


@pytest.mark.parametrize("scenario", ["early", "wall", "eos"])
def test_stream_matches_jax_token_for_token(jax_runs, port_runs, scenario):
    """(a) The windows yielded, and every row's generated tokens, done and
    position, equal JAX decode_stream's: after an early close (the window
    in flight drains into the engine), run on to the length wall, and with
    an EOS found a window late."""
    windows, state = port_runs[scenario]
    want_windows, want_state = jax_runs[scenario]
    assert windows == want_windows
    assert state == want_state
    if scenario == "early":
        # the closed stream's window in flight: 4 windows ran, 3 yielded
        for u in UIDS:
            yielded = sum((w.get(u, []) for w in windows), [])
            assert state[u][0][-32:][:len(yielded)] == yielded
            assert len(yielded) == 24
    if scenario == "eos":
        assert any(done for _, done, _, _ in state.values())


def test_max_len_tail_matches_jax(jax_runs, port_runs):
    """(b) Rows reaching max_len: the cutoff at each tick's own position,
    so final lengths, tokens and done equal JAX's."""
    assert port_runs["tail"] == jax_runs["tail"]
    assert all(done for _, done, _, _ in port_runs["tail"][1].values())


@pytest.mark.parametrize("when", ["expired_at_entry", "expired_mid_stream"])
def test_expired_deadlines_are_dropped_on_the_stream_path(jax_runs,
                                                          port_runs, when):
    """(c) An expired request is dropped at the stream's entry (blocks
    freed), and one expiring mid-stream ends the chain; both as JAX."""
    assert port_runs[when] == jax_runs[when]
    if when == "expired_at_entry":
        served, state, blocks = port_runs[when]
        assert served == [] and state[7][1] and state[7][3] and blocks == []
    else:
        assert port_runs[when][1][9][3] and not port_runs[when][1][8][3]


def test_guards_while_a_window_is_in_flight(params):
    """(d) step(), decode_steps() and a second stream raise while a window
    is in flight; put() does not; closing the stream lifts the guard."""
    eng = _engine(params)
    _prefill(eng, UIDS, _prompts(5, LENS))
    gen = eng.decode_stream(window=8)
    next(gen)
    for call in (eng.step, lambda: eng.decode_steps(8),
                 lambda: next(eng.decode_stream())):
        with pytest.raises(RuntimeError, match="in flight"):
            call()
    eng.put([4], _prompts(15, [9]))            # admission mid-stream
    rest = list(gen)                           # the chain ends and drains
    assert rest and not eng._stream_inflight
    assert eng.step()                          # prefills uid 4


def test_warmup_tick_writes_only_the_trash_block(params):
    """(e) A graph's warm-up inputs, run through the eager tick, leave
    every KV block but block 0 as it was."""
    eng = _engine(params)
    _prefill(eng, UIDS, _prompts(5, LENS))
    for v in eng.pool.values():
        v[:, 0] = 0                # the pad rows of prefill wrote it already
    before = {k: v.clone() for k, v in eng.pool.items()}
    for rows, mb in ((4, 2), (32, 8)):
        logits, sampled = eng._run_tick(
            *graphs.warmup_inputs(rows, mb, eng.device), None)
        assert logits.shape == (rows, 512) and sampled.shape == (rows,)
    for k, v in eng.pool.items():
        assert torch.equal(v[:, 1:], before[k][:, 1:])
        assert not torch.equal(v[:, :1], before[k][:, :1])


class _StandIn:
    """Stands in for a torch.cuda.CUDAGraph on the CPU."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_add_the_captured_launch_counts():
    """(f) A capture's launch counts are taken back, kept as the graph's
    delta, and added once per replay."""
    before = dict(PA.launches), dict(norms.launches)

    def capture():                 # what a 2-layer bf16 tick's capture counts
        for _ in range(2):
            PA.launches["paged_attention"] += 1
            PA.launches["paged_attention_decode"] += 1
        norms.launches["rms_norm"] += 5
        return "outputs"

    out, delta = graphs.counted(capture)
    assert out == "outputs"
    assert (dict(PA.launches), dict(norms.launches)) == before
    assert delta == {(0, "paged_attention"): 2,
                     (0, "paged_attention_decode"): 2, (1, "rms_norm"): 5}
    stand_in = _StandIn()
    g = graphs.TickGraph(stand_in, graphs.warmup_inputs(8, 4, "cpu"),
                         (None, None), True, delta, {"capture_s": 0.0})
    for _ in range(3):
        g.replay()
    assert stand_in.replays == g.replays == 3
    assert PA.launches["paged_attention_decode"] == \
        before[0]["paged_attention_decode"] + 6
    assert norms.launches["rms_norm"] == before[1]["rms_norm"] + 15
    assert g.stats()["launches_per_replay"] == {
        "paged_attention": 2, "paged_attention_decode": 2, "rms_norm": 5}
    graphs.add_counts(delta, -3)               # leave the counters as found
    assert (dict(PA.launches), dict(norms.launches)) == before

    def failed_capture():
        capture()
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        graphs.counted(failed_capture)             # no counts stay behind
    assert (dict(PA.launches), dict(norms.launches)) == before


def test_cpu_engine_ticks_eagerly(params):
    """On the CPU every tick is eager: no graph is captured."""
    eng = _engine(params)
    _prefill(eng, UIDS, _prompts(5, LENS))
    _stream(eng)
    assert not eng._graphs and eng.graph_stats() == {}
    assert set(how for how, _ in eng.device_ticks) == {"eager"}
