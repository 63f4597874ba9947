"""The port's spans and counters (``utils/profiler.py::span``), on the CPU:
the span's gate on torch's profiler flag, the ranges a profiled engine
leaves in its trace, each request's wait split into queue, prefill and
first token, and the pool's shortfall and re-prefill counters."""
import json
import logging
import queue
import threading
import time

import pytest
import torch

from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import (EngineRequest, GenerationConfig,
                                         ResponseType)
from lmdeploy_tpu_torch.models.llama import (init_params, pack_params,
                                             quantize_params)
from lmdeploy_tpu_torch.utils import profiler

torch.set_num_threads(1)
CFG = ModelConfig(head_num=2, kv_head_num=1, size_per_head=128,
                  inter_size=256, num_layer=2, vocab_size=256,
                  rotary_embedding=128, max_position_embeddings=512,
                  session_len=128, group_size=128, weight_type='int4',
                  end_id=2)
ECFG = dict(max_batch_size=4, session_len=128, page_size=16, num_pages=40,
            max_context_token_num=32, prefill_buckets=(16, 32),
            step_length=4, enable_prefix_caching=False)
NEW_KEYS = ('admitted', 'queue_wait_s', 'prefilled', 'prefill_s',
            'first_tokens', 'first_token_s', 'no_free_pages',
            'redecode_tokens')


@pytest.fixture(scope='module')
def params():
    p = init_params(CFG, torch.Generator().manual_seed(0), torch.float32,
                    'cpu')
    return pack_params(quantize_params(p, CFG))


def engine(params, start=True, **kw):
    return TorchEngine(CFG, EngineConfig(**dict(ECFG, **kw)), params,
                       device='cpu', start=start)


def greedy(n, **kw):
    return GenerationConfig(max_new_tokens=n, top_k=1, ignore_eos=True,
                            **kw)


def sampled(n):
    return GenerationConfig(max_new_tokens=n, top_k=0, top_p=0.8,
                            repetition_penalty=1.1, ignore_eos=True,
                            random_seed=7)


def request(sid, prompt, gen, **kw):
    return EngineRequest(session_id=sid, input_ids=list(prompt),
                         gen_config=gen, **kw)


def drain(out_q):
    """Every frame of one request, to its last."""
    outs = []
    while not outs or not outs[-1].finished:
        outs.append(out_q.get(timeout=120))
    return outs


class RangeCounter:
    """``torch.profiler.record_function``, counting its calls."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = torch.profiler.record_function

        def counted(name, *a, **kw):
            self.calls.append(name)
            return real(name, *a, **kw)
        monkeypatch.setattr(torch.profiler, 'record_function', counted)


def test_span_adds_its_seconds_and_opens_a_range_only_when_traced(
        monkeypatch, tmp_path):
    rf = RangeCounter(monkeypatch)
    into = {'a.b': 0.0}
    assert not torch._C._autograd._profiler_enabled()
    with profiler.span('a.b', into):
        torch.ones(8).sum()
    with profiler.span('a.c'), profiler.annotate('a.d'):
        torch.ones(8).sum()
    assert into == {'a.b': into['a.b']} and into['a.b'] > 0
    assert rf.calls == []
    # the positive control: recording on this thread, both open a range
    before = into['a.b']
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.span('a.b', into):
            with profiler.span('a.c'), profiler.annotate('a.d'):
                torch.ones(8).sum()
    assert rf.calls == ['a.b', 'a.c', 'a.d'] and into['a.b'] > before
    prof.export_chrome_trace(str(tmp_path / 't.json'))
    names = {e.get('name') for e in json.loads(
        (tmp_path / 't.json').read_text())['traceEvents']}
    assert {'a.b', 'a.c', 'a.d'} <= names


def run_loop_profiled(eng, reqs, path):
    """The requests queued on a stopped engine, its loop run on this
    thread under torch.profiler (which records the thread that starts
    it), until a reader thread has seen every request end; the trace's
    event names, and every request's frames."""
    qs = []
    for r in reqs:
        qs.append(queue.Queue())
        eng._requests.put((r, qs[-1], time.monotonic()))
    outs = [None] * len(qs)

    def read():
        for i, q in enumerate(qs):
            outs[i] = drain(q)
        eng._shutdown = True
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng._loop()
    reader.join(10)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())['traceEvents']
    return [e.get('name', '') for e in events if e.get('ph') == 'X'], outs


def test_profiled_engine_leaves_the_programs_ranges(params, tmp_path):
    """Every engine.*, step.*, llama.* and sampling.* range is in the
    trace; llama.attn and llama.ffn once a layer in every forward pass
    (decode step or prefill pass), step.forward once a decode step."""
    eng = engine(params, start=False)
    try:
        names, outs = run_loop_profiled(eng, [
            request(1, range(3, 43), greedy(6)),
            request(2, range(50, 70), sampled(6))], tmp_path / 'e.json')
        assert [o[-1].status for o in outs] == [ResponseType.FINISH] * 2
        for want in ('engine.requests', 'engine.decode_dispatch',
                     'engine.emit', 'engine.grow_pages', 'step.forward',
                     'step.sampler', 'step.update', 'step.readback',
                     'step.prefill_issue', 'llama.embed', 'llama.rope',
                     'llama.attn', 'llama.ffn', 'llama.lm_head',
                     'sampling.penalties', 'sampling.filter',
                     'sampling.prng'):
            assert want in names, want
        assert sorted(n for n in names if n.startswith('engine.admit ')) \
            == ['engine.admit 1', 'engine.admit 2']
        st = eng.stats
        passes = st['decode_steps'] + st['prefill_passes']
        assert names.count('llama.attn') == names.count('llama.ffn') \
            == CFG.num_layer * passes
        assert names.count('step.forward') == st['decode_steps'] > 0
        assert names.count('step.prefill_issue') == st['prefill_passes'] > 0
        host = eng.fns.host_s
        assert host['step.forward'] > 0 and host['step.sampler'] > 0
        assert host['step.prefill_issue'] > 0
        assert host['step.forward'] + host['step.sampler'] <= host['issue']
    finally:
        eng.shutdown()


def test_second_request_waits_behind_the_first(params, monkeypatch):
    """At max_batch_size 1 the second request waits for the slot: each
    admission adds its wait, each finished prefill job and each first
    token their times; with the profiler off no range is opened."""
    rf = RangeCounter(monkeypatch)
    eng = engine(params, start=False, max_batch_size=1)
    try:
        qs = [queue.Queue(), queue.Queue()]
        eng._requests.put((request(1, range(3, 43), greedy(12)), qs[0],
                           time.monotonic()))
        eng._requests.put((request(2, range(3, 23), greedy(4)), qs[1],
                           time.monotonic()))
        eng.start()
        outs = [drain(q) for q in qs]
        st = eng.metrics()
        streamed = sum(1 for o in outs if any(x.num_generated for x in o))
        assert [o[-1].status for o in outs] == [ResponseType.FINISH] * 2
        assert st['admitted'] == st['requests'] == 2
        assert st['first_tokens'] == streamed == 2
        assert st['prefilled'] == 2
        # the second waited for the first's twelve tokens
        assert st['queue_wait_s'] > st['first_token_s'] > 0
        assert st['prefill_s'] > 0
        assert st['no_free_pages'] == st['redecode_tokens'] == 0
        assert set(NEW_KEYS) <= set(st)
        assert rf.calls == []
    finally:
        eng.shutdown()


def test_pool_shortfall_is_counted_answered_and_logged(params, caplog):
    """Eight pages for two slots: the longer prompt takes seven, the other
    finds one free; it is answered INTERNAL_ERROR, counted once and
    logged with its session and the pages."""
    eng = engine(params, start=False, max_batch_size=2, num_pages=8)
    try:
        qs = [queue.Queue(), queue.Queue()]
        eng._requests.put((request(1, range(3, 103), greedy(4)), qs[0],
                           time.monotonic()))
        eng._requests.put((request(2, range(3, 43), greedy(4)), qs[1],
                           time.monotonic()))
        with caplog.at_level(logging.WARNING, logger='lmdeploy_tpu_torch'):
            eng.start()
            outs = [drain(q) for q in qs]
        assert outs[0][-1].status == ResponseType.FINISH
        assert outs[1][-1].status == ResponseType.INTERNAL_ERROR
        assert eng.stats['no_free_pages'] == 1
        assert eng.stats['admitted'] == 1
        warn = [r.getMessage() for r in caplog.records
                if 'no free pages' in r.getMessage()]
        assert warn == ['no free pages: session 2 asks for 3 pages (40 '
                        'tokens; it holds 0), 1 free in its pool']
    finally:
        eng.shutdown()


@pytest.mark.parametrize('native', ['1', '0'])
def test_evicted_session_counts_its_prefill_again(params, monkeypatch,
                                                  native):
    """Session 1 ends its turn with its pages kept; session 2 needs the
    whole pool, so the store evicts session 1; continuing session 1
    prefills its first turn again: its tokens but the last (never in the
    pool) go to redecode_tokens.  Both session stores."""
    monkeypatch.setenv('LMDEPLOY_TPU_NATIVE', native)
    eng = engine(params, max_batch_size=2, num_pages=8)
    try:
        inst = eng.create_instance()
        out = list(inst.stream_infer(1, range(3, 40), greedy(5),
                                     sequence_end=False))[-1]
        assert out.status == ResponseType.FINISH
        assert eng.stats['redecode_tokens'] == 0
        out = list(inst.stream_infer(2, range(3, 120), greedy(4),
                                     sequence_end=True))[-1]
        assert out.status == ResponseType.FINISH
        out = list(inst.stream_infer(1, [7, 8], greedy(3),
                                     sequence_start=False,
                                     sequence_end=True))[-1]
        assert out.status == ResponseType.FINISH
        # 37 prompt tokens and 5 generated: 41 had been in the pool
        assert eng.stats['redecode_tokens'] == 37 + 5 - 1
        assert eng.stats['no_free_pages'] == 0
    finally:
        eng.shutdown()


@pytest.mark.parametrize('native', ['1', '0'])
def test_sessions_beyond_the_entry_bound_are_served(params, monkeypatch,
                                                    native):
    """cache_max_entry_count 1 beside two slots: the second session's
    creation trims no running one and not itself, so both requests finish
    and no shortfall is counted; with both running, prompt logits (a
    scratch session beside them) are served too.  Both session stores."""
    monkeypatch.setenv('LMDEPLOY_TPU_NATIVE', native)
    eng = engine(params, start=False, max_batch_size=2,
                 cache_max_entry_count=1)
    try:
        qs = [queue.Queue(), queue.Queue()]
        for i, q in enumerate(qs):
            eng._requests.put((request(i + 1, range(3 + i, 30 + i),
                                       greedy(40)), q, time.monotonic()))
        eng.start()
        firsts = [q.get(timeout=120) for q in qs]
        assert all(o.num_generated and not o.finished for o in firsts)
        logits = eng.create_instance().decode(list(range(5, 25)))
        assert logits.shape == (20, CFG.vocab_size)
        outs = [drain(q) for q in qs]
        assert [o[-1].status for o in outs] == [ResponseType.FINISH] * 2
        assert eng.stats['no_free_pages'] == 0
        assert eng.stats['admitted'] == 2
    finally:
        eng.shutdown()
