"""The in-place decode step and its CUDA-graph dispatch, on the CPU.

``StepFns.decode_steps`` runs the plain step in place
(``engine/step.py::decode_steps``) and, on the card, replays it from two
captured CUDA graphs.  Here the graph dispatch's bookkeeping (warm-up,
capture, replay, no capture while profiled, a failed capture, graphs
dropped with the device state) runs with a stand-in for a CUDA graph that
runs its step at replay, its readbacks and states held bit for bit to the
eager step's over dispatches with slot surgery between them; and where the
graphs may engage follows what the step functions observe.  The in-place
step is held to the JAX package's in ``tests/test_torch_model.py``, the
graphs themselves run in ``tests/test_torch_cuda.py``.
"""
import functools
import types

import numpy as np
import pytest
import torch

from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.engine import step as S
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import GenerationConfig, ResponseType
from lmdeploy_tpu_torch.models.llama import forward, random_packed_params
from lmdeploy_tpu_torch.ops.sampling import make_rng_keys
from lmdeploy_tpu_torch.parallel.pp import PPStepFns
from lmdeploy_tpu_torch.utils import debug

torch.set_num_threads(1)

# Qwen's rope at a tiny width: dynamic NTK and logn past 32 positions
CFG = dict(head_num=2, kv_head_num=1, size_per_head=128, inter_size=256,
           num_layer=2, vocab_size=200, rotary_embedding=128,
           max_position_embeddings=32, session_len=64, group_size=128,
           weight_type='int4', end_id=2, use_dynamic_ntk=True,
           use_logn_attn=True)
B, PAGE, MAXP, HIST = 4, 16, 4, 64
POOL = dict(num_layers=2, num_pages=24, page_size=PAGE, kv_heads=1,
            head_dim=128, dtype=torch.int8,
            kv_scales=([0.02] * 2, [1.0] * 2, [0.015] * 2, [-2.0] * 2))
SHAPE = dict(batch=B, max_pages=MAXP, hist_len=HIST, eos_id=2)
STEPS = (1, 8, 1, 8)


@pytest.fixture(scope='module')
def params():
    return random_packed_params(ModelConfig(**CFG), 7, 'cpu')


def step_fns(**kw):
    return S.StepFns(ModelConfig(**CFG), 'cpu', POOL, SHAPE, **kw)


def sampling_row(slot, mode, pen, max_new=40):
    top_k = {'greedy': 1, 'candidates': 40, 'full': 0}[mode]
    stops = np.full(32, -1, np.int32)
    stops[0] = 7
    return dict(top_k=top_k, top_p=0.9, min_p=0.0, temperature=0.8,
                repetition_penalty=1.3 if pen else 1.0,
                presence_penalty=0.2 if pen else 0.0,
                frequency_penalty=0.0, ignore_eos=True,
                min_new_tokens=0, max_new_tokens=max_new, stop_words=stops,
                rng_key=make_rng_keys([1000 + slot])[0])


def install(state, slot, mode, pen, ctx, pages, max_new=40):
    rng = np.random.default_rng(slot)
    hist = np.zeros(HIST, np.int32)
    hist[:ctx + 1] = rng.integers(3, 200, ctx + 1)
    row = np.full(MAXP, -1, np.int32)
    row[:len(pages)] = pages
    S.install_slot(state, slot, int(hist[ctx]), ctx, hist, ctx + 1, row,
                   sampling_row(slot, mode, pen, max_new))


def surgery(states, d, mode, pen):
    """Before dispatch ``d``: d = 1 admits slot 2, d = 2 grows slot 0's
    page row, d = 3 finishes slot 1 and clears slot 3."""
    for st in states:
        if d == 1:
            install(st, 2, mode, pen, 20, [9, 10])
        elif d == 2:
            S.set_page_row(st, 0, np.array([1, 2, -1, -1], np.int32))
        elif d == 3:
            S.set_finished(st, 1)
            S.clear_slot(st, 3)


def start(fns, mode, pen):
    """Two equal device states: slots 0, 1 and 3 running (slot 1 stops on
    its length inside the second dispatch), slot 2 empty."""
    pairs = [fns.alloc_device_state() for _ in range(2)]
    for _, st in pairs:
        install(st, 0, mode, pen, 5, [1])
        install(st, 1, mode, pen, 30, [3, 4], max_new=4)
        install(st, 3, mode, pen, 12, [6])
    return pairs


def states_equal(a, b):
    for x, y in zip(S._tensors(a), S._tensors(b)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def run_both(params, fns, mode, topn, pen, steps=STEPS):
    """Dispatches of ``steps`` through ``fns`` and through the eager
    decode_steps on a twin state, with the surgery between them; every
    readback and the states after each are equal bit for bit."""
    (cache_i, st_i), (cache_f, st_f) = start(fns, mode, pen)
    passes = (False, pen)
    cfg = ModelConfig(**CFG)
    for d, k in enumerate(steps):
        surgery((st_i, st_f), d, mode, pen)
        got_state, got = fns.decode_steps(params, cache_i, st_i, k,
                                          sampling_mode=mode, topn=topn,
                                          passes=passes)
        assert got_state is st_i
        st_f, want = S.decode_steps(params, cache_f, st_f, cfg,
                                    num_steps=k, sampling_mode=mode,
                                    topn=topn, passes=passes)
        assert got.shape == (5 + 2 * topn, k, B)
        np.testing.assert_array_equal(got, want.numpy())
        states_equal(st_i, st_f)
        np.testing.assert_array_equal(cache_i.k.numpy(), cache_f.k.numpy())
    return st_i


class FakeGraph:
    """A stand-in for a captured CUDA graph: its replay runs the step."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def fake_graphs(monkeypatch):
    """StepFns on the CPU dispatching through FakeGraph captures; the
    captures it made are listed."""
    made = []

    def record(self, fn):
        made.append(fn)
        return FakeGraph(fn)
    monkeypatch.setattr(S.StepFns, 'graph_ok', lambda self, cache: True)
    monkeypatch.setattr(S.StepFns, '_record', record)
    return made


@pytest.mark.parametrize('topn', [0, 2])
@pytest.mark.parametrize('mode', ['greedy', 'candidates', 'full'])
def test_graph_dispatch_replays_the_in_place_step(params, fake_graphs, mode,
                                                  topn):
    """A key's first dispatch runs eagerly, its second captures (two
    graphs) and replays, the rest replay: the readbacks and states are the
    eager steps' bit for bit, with an admission, a page-row growth, a
    finish and a clear between the dispatches; slot 1 stops on its
    length."""
    fns = step_fns()
    st = run_both(params, fns, mode, topn, pen=True)
    assert bool(st.finished[1]) and int(st.generated[1]) == 4
    assert len(fake_graphs) == 2 and fns.graph_captures == 1
    assert fns.graph_steps == sum(STEPS[1:])
    rep = fns.report()
    assert (rep['graph_steps'], rep['graph_captures']) == \
        (sum(STEPS[1:]), 1)


def test_no_capture_while_the_profiler_records(params, fake_graphs):
    """The dispatch that would capture runs eagerly while torch's profiler
    records on the thread; the next one, unprofiled, captures."""
    fns = step_fns()
    (cache, st), _ = start(fns, 'candidates', True)
    kw = dict(sampling_mode='candidates', passes=(False, True))
    fns.decode_steps(params, cache, st, 1, **kw)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        fns.decode_steps(params, cache, st, 2, **kw)
    assert fns.graph_captures == 0 and fns.graph_steps == 0
    fns.decode_steps(params, cache, st, 2, **kw)
    assert fns.graph_captures == 1 and fns.graph_steps == 2


def test_new_device_state_drops_the_graphs(params, fake_graphs):
    """alloc_device_state drops the graphs; the new state's key warms up
    and is captured again.  Another key is a capture of its own."""
    fns = step_fns()
    (cache, st), _ = start(fns, 'candidates', True)
    kw = dict(sampling_mode='candidates', passes=(False, True))
    for _ in range(3):
        fns.decode_steps(params, cache, st, 1, **kw)
    assert fns.graph_captures == 1 and fns._graphs
    cache, st = fns.alloc_device_state()
    assert not fns._graphs and fns._graphed is None
    install(st, 0, 'candidates', True, 5, [1])
    for _ in range(2):
        fns.decode_steps(params, cache, st, 1, **kw)
    assert fns.graph_captures == 2
    for _ in range(2):
        fns.decode_steps(params, cache, st, 1, sampling_mode='greedy',
                         passes=(False, False))
    assert fns.graph_captures == 3 and len(fns._graphs) == 2
    assert fns.graph_steps == 2 + 1 + 1


def test_a_failed_capture_leaves_the_key_eager(params, monkeypatch):
    """A capture that raises is logged; the key runs eagerly from then on,
    with the eager steps' readbacks."""
    calls = []

    def record(self, fn):
        calls.append(fn)
        raise RuntimeError('operation not permitted when stream is '
                           'capturing (simulated)')
    monkeypatch.setattr(S.StepFns, 'graph_ok', lambda self, cache: True)
    monkeypatch.setattr(S.StepFns, '_record', record)
    fns = step_fns()
    run_both(params, fns, 'candidates', 0, pen=True)
    assert len(calls) == 1
    assert fns.graph_captures == 0 and fns.graph_steps == 0


def test_passes_read_from_the_state_never_capture(params, fake_graphs):
    """passes None reads the pool's full-vocabulary passes on the host:
    those dispatches run eagerly."""
    fns = step_fns()
    (cache, st), _ = start(fns, 'greedy', False)
    for _ in range(3):
        fns.decode_steps(params, cache, st, 1)
    assert not fake_graphs and fns.graph_steps == 0


def _stub_ranks(tp=1):
    return types.SimpleNamespace(tp=tp, dp=1, dp_rank=0, rank=0,
                                 device_group='group' if tp > 1 else None)


@pytest.mark.parametrize('case,engages', [
    ('plain', True), ('cpu', False), ('tp group', False),
    ('pipeline', False), ('forward swapped in', False), ('debugger', False),
    ('dynamic int4 pool', False)])
def test_graphs_engage_where_the_step_fns_observe_it(monkeypatch, case,
                                                     engages):
    """graph_ok: a card, one tensor-parallel rank, the step's own forward
    (PPStepFns and a caller's forward are not), the debugger off and a
    pool without host reads.  The device is set to CUDA by hand here; no
    CUDA call is made."""
    cfg = ModelConfig(**CFG)
    if case == 'tp group':
        fns = step_fns(ranks=_stub_ranks(tp=2))
    elif case == 'pipeline':
        fns = PPStepFns(cfg, 'cpu', POOL, SHAPE, _stub_ranks())
    else:
        fns = step_fns()
    if case != 'cpu':
        fns.device = torch.device('cuda')
    if case == 'forward swapped in':
        fns.forward_fn = functools.partial(forward, group=None)
    if case == 'debugger':
        monkeypatch.setattr(debug, 'enabled', lambda: True)
    cache = types.SimpleNamespace(dynamic_scales=case == 'dynamic int4 pool')
    assert fns.graph_ok(cache) is engages


ECFG = dict(max_batch_size=4, session_len=64, page_size=16, num_pages=24,
            max_context_token_num=32, prefill_buckets=(16, 32),
            step_length=4, enable_prefix_caching=False)


@pytest.mark.parametrize('spec', [0, 2])
def test_cpu_engine_counts_no_graph_steps(params, spec):
    """On the CPU the engine's plain decode steps (and, with speculation,
    its speculative rounds) all run eagerly: graph_steps and
    graph_captures stay 0 while decode_steps counts.  The engine's
    DecodeState stays one object across speculative and plain dispatches
    (the second request after speculation is turned off)."""
    eng = TorchEngine(ModelConfig(**CFG),
                      EngineConfig(speculative_k=spec, **ECFG), params,
                      device='cpu')
    state = eng.state
    try:
        inst = eng.create_instance()
        outs = []
        for i in range(2):
            outs.append(inst.infer(i + 1, list(range(3 + i, 20 + i)),
                                   gen_config=GenerationConfig(
                                       max_new_tokens=12, top_k=1 - i,
                                       top_p=0.9, ignore_eos=True,
                                       random_seed=i),
                                   sequence_end=True))
            eng.ecfg.speculative_k = 0
        assert [o.status for o in outs] == [ResponseType.FINISH] * 2
        st = eng.stats
        assert st['decode_steps'] > 0
        if spec:
            assert st['spec_rounds'] > 0
        assert st['graph_steps'] == 0 and st['graph_captures'] == 0
        assert eng.state is state
    finally:
        eng.shutdown()


def test_spec_rounds_write_back_into_the_state(params):
    """StepFns.spec_decode_rounds hands back the state it was given, with
    the functional rounds' result in it, readback equal bit for bit."""
    fns = step_fns()
    (cache_i, st_i), (cache_f, st_f) = start(fns, 'candidates', True)
    for _ in range(2):
        got_state, got = fns.spec_decode_rounds(
            params, cache_i, st_i, num_rounds=2, k_draft=2,
            sampling='candidates', passes=(False, True))
        st_f, want = S.spec_decode_rounds(
            params, cache_f, st_f, ModelConfig(**CFG), num_rounds=2,
            k_draft=2, sampling='candidates', passes=(False, True))
        assert got_state is st_i
        np.testing.assert_array_equal(got, want.numpy())
        states_equal(st_i, st_f)
