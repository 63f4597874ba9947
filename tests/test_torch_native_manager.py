"""The port's native C++ cache manager (``kvcache/native.py`` over
``lmdeploy_tpu_torch/csrc/cache_manager.cpp``) against its Python manager
and the JAX package's ``SequenceManager``.

A scripted sequence of operations (growth, publish, prefix hits, a rewind
into shared pages, eviction under pressure, erase, flush) gives the same
pages, hits, cache lengths and free counts from all three.  The engine
uses the native manager unless ``LMDEPLOY_TPU_NATIVE=0``, says which in
its metrics, and a failed build raises with the compiler's message.
"""
import threading

import pytest

from lmdeploy_tpu.kvcache.manager import PageAllocator as JPageAllocator
from lmdeploy_tpu.kvcache.manager import SequenceManager as JSequenceManager
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.kvcache import native
from lmdeploy_tpu_torch.kvcache.manager import (GroupedSequenceManager,
                                                PageAllocator,
                                                SequenceManager)
from test_torch_engine import CFG, ECFG

PS = 4          # tokens per page
PAGES = 12


def managers(max_entries=0):
    return {
        'native': native.NativeSequenceManager(PAGES, PS, max_entries),
        'python': SequenceManager(PageAllocator(PAGES), PS, max_entries),
        'jax': JSequenceManager(JPageAllocator(PAGES), PS, max_entries),
    }


def script(m):
    """Operations a serving engine makes; the log of what the store says
    after each."""
    log = []

    def note(tag, *seqs):
        log.append((tag, m.free_count, [
            (list(s.pages), s.cache_len, len(s.token_ids), s.shared_pages)
            for s in seqs]))

    system = list(range(100, 110))                     # 2 full pages + 2
    a = m.create(1)
    a.active = True
    m.grow(a, 13)
    a.token_ids = system + [1, 2, 3]
    a.cache_len = 12
    note('a grown', a)
    m.publish(a)                                       # insert-only: active
    note('a published while active', a)
    m.release(a)
    m.publish(a)
    note('a retired', a)
    b = m.create(2)
    hit = m.match_prefix(b, system + [7, 7, 7])
    log.append(('b hit', hit, m.prefix_hits, m.prefix_lookups))
    b.active = True
    m.grow(b, 15)
    b.token_ids = system + [7, 7, 7, 8, 8]
    b.cache_len = 14
    note('b grown', b)
    log.append(('b rewind', m.prepare_rewrite(b, 5)))
    note('b privatised', b)
    m.release(b)
    c = m.create(3)
    c.active = True
    m.grow(c, 20)                                      # 5 pages
    note('c grown', a, b, c)
    d = m.create(4)
    d.active = True
    try:
        m.grow(d, 40)                                  # evicts a, then b
        log.append('d grown')
    except Exception as e:            # each package's NoFreePages
        assert type(e).__name__ == 'NoFreePages', e
        log.append('d refused')
    note('after pressure', a, b, c, d)
    log.append(('contains', [i in m for i in (1, 2, 3, 4, 5)]))
    m.erase(3)
    m.erase(4)
    note('erased', a, b)
    m.flush_prefix()
    log.append(('flushed', m.free_count))
    e = m.create(5)
    log.append(('after flush hit', m.match_prefix(e, system + [1])))
    return log


def test_native_python_and_jax_managers_agree():
    """The same log from the three stores.  A refused grow leaves the
    sequence without new pages on each (the C++ store took pages one by
    one and kept them on a refusal until its grow was made all or
    nothing)."""
    logs = {name: script(m) for name, m in managers().items()}
    assert logs['native'] == logs['python'] == logs['jax']
    # the script exercised what it names
    log = logs['python']
    assert ('b hit', 8, 2, 3) in log           # 2 pages hit, 3 probed
    assert ('b rewind', 4) in log and 'd refused' in log
    assert ('flushed', PAGES) in log


def test_native_manager_max_entries_and_rng():
    """cache_max_entry_count trims the oldest inactive sessions, and the
    rng snapshot round-trips, on both of the port's managers."""
    out = {}
    for name, m in managers(max_entries=2).items():
        for i in (1, 2, 3):
            s = m.create(i)
            m.grow(s, 5)
        s = m.get(3)
        s.rng_key = [7, 9]
        out[name] = ([i in m for i in (1, 2, 3)], m.free_count,
                     [int(x) for x in m.get(3).rng_key])
    assert out['native'] == out['python'] == out['jax']
    assert out['native'][2] == [7, 9]


def test_create_never_trims_the_session_it_creates():
    """At the bound with every other session active, a new session stays
    (the count over the bound) and the next create trims the oldest
    inactive one; the JAX store erases the new session instead (the
    port's deliberate difference, kvcache/manager.py)."""
    for name, m in managers(max_entries=1).items():
        a = m.create(1)
        a.active = True
        b = m.create(2)
        if name == 'jax':
            assert 2 not in m
            continue
        assert 1 in m and 2 in m, name
        m.grow(b, 5)
        m.release(b)
        m.create(3)
        assert [i in m for i in (1, 2, 3)] == [True, False, True], name


@pytest.mark.parametrize('env,want', [(None, 1), ('0', 0), ('1', 1)])
def test_engine_uses_native_manager_by_default(monkeypatch, env, want):
    """LMDEPLOY_TPU_NATIVE=0 chooses the Python manager; metrics say which
    runs."""
    if env is None:
        monkeypatch.delenv('LMDEPLOY_TPU_NATIVE', raising=False)
    else:
        monkeypatch.setenv('LMDEPLOY_TPU_NATIVE', env)
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**ECFG), {},
                      device='cpu', start=False)
    store = eng.seqs.managers[0]
    assert isinstance(store, native.NativeSequenceManager) == bool(want)
    assert isinstance(eng.seqs, GroupedSequenceManager)
    assert eng.metrics()['native_cache_manager'] == want


def test_failed_native_build_raises_with_compiler_message(monkeypatch,
                                                         tmp_path):
    """No quiet switch to Python: a source g++ refuses raises, naming the
    error."""
    bad = tmp_path / 'cache_manager.cpp'
    bad.write_text('int cm_create( { this is not C++\n')
    monkeypatch.setattr(native, 'SOURCE', bad)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='error'):
        native.build()


def test_decode_frees_scratch_pages_before_answering(monkeypatch):
    """EngineInstance.decode's scratch session is erased before its answer
    is put: a store whose erase takes time (the native one releases the
    GIL) left the caller seeing the scratch pages still held."""
    from test_torch_prefix_cache import dense_f32_params

    from lmdeploy_tpu_torch.convert.workspace import params_from_numpy
    real = GroupedSequenceManager.erase
    slow = threading.Event()

    def slow_erase(self, seq_id):
        if seq_id < 0:                    # the scratch session
            slow.wait(0.3)
        return real(self, seq_id)
    monkeypatch.setattr(GroupedSequenceManager, 'erase', slow_erase)
    eng = TorchEngine(ModelConfig(**dict(CFG, weight_type='fp32')),
                      EngineConfig(**ECFG),
                      params_from_numpy(dense_f32_params(), 'cpu'),
                      device='cpu')
    try:
        logits = eng.create_instance().decode([5, 6, 7])
        assert logits.shape == (3, CFG['vocab_size'])
        assert eng.seqs.free_count(0) == ECFG['num_pages']
    finally:
        eng.shutdown()
