"""The port's utils against the JAX package's, on the CPU: version, the
leveled logger and its first-rank filter, the profiler helpers, and the
golden-file debugger, whose dumps each package's ``cmp`` reads from the
other's ``dump`` through one forward of each package's model."""
import importlib
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lmdeploy_tpu
import lmdeploy_tpu_torch
from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.kvcache.paged import init_cache as jinit_cache
from lmdeploy_tpu.models import llama as jllama
from lmdeploy_tpu.utils import debug as jdebug
from lmdeploy_tpu.utils.profiler import PhaseTimer as JPhaseTimer
from lmdeploy_tpu_torch.config import ModelConfig
from lmdeploy_tpu_torch.convert.workspace import params_from_numpy
from lmdeploy_tpu_torch.kvcache.paged import init_cache
from lmdeploy_tpu_torch.models import llama as tllama
from lmdeploy_tpu_torch.utils import debug as tdebug
from lmdeploy_tpu_torch.utils import logger as tlogger
from lmdeploy_tpu_torch.utils import profiler as tprofiler

torch.set_num_threads(1)
CFG = dict(head_num=2, kv_head_num=1, size_per_head=128, inter_size=256,
           num_layer=2, vocab_size=256, rotary_embedding=128,
           max_position_embeddings=512, session_len=256)


def test_version_matches_jax_package():
    assert lmdeploy_tpu_torch.__version__ == lmdeploy_tpu.__version__
    assert lmdeploy_tpu_torch.version_info == lmdeploy_tpu.version_info
    assert {'__version__', 'version_info'} <= set(lmdeploy_tpu_torch.__all__)


def _fresh_logger(name):
    lg = logging.getLogger(name)
    lg._lmdeploy_tpu_init = False
    return tlogger.get_logger(name)


def test_logger_env_level(monkeypatch):
    """LMDEPLOY_TPU_LOG_LEVEL sets the level, as in the JAX package."""
    monkeypatch.setenv('LMDEPLOY_TPU_LOG_LEVEL', 'DEBUG')
    monkeypatch.delenv('LMDEPLOY_TPU_LOG_FIRST_RANK_ONLY', raising=False)
    assert _fresh_logger('lmdeploy_tpu_torch_test_lvl').level == \
        logging.DEBUG
    monkeypatch.setenv('LMDEPLOY_TPU_LOG_LEVEL', 'trace')
    assert _fresh_logger('lmdeploy_tpu_torch_test_lvl').level == \
        tlogger.TRACE


@pytest.mark.parametrize('first_only,rank,dist_rank,want', [
    ('1', '1', None, logging.ERROR),     # a follower: errors only
    ('1', '0', None, logging.INFO),      # rank 0 keeps its level
    ('1', None, None, logging.INFO),     # no RANK: rank 0
    ('0', '1', None, logging.INFO),      # the filter is opt-in
    ('1', '0', 1, logging.ERROR),        # torch.distributed's rank wins
    ('1', '1', 0, logging.INFO),
])
def test_logger_first_rank_filter(monkeypatch, first_only, rank, dist_rank,
                                  want):
    """LMDEPLOY_TPU_LOG_FIRST_RANK_ONLY=1 raises the level to ERROR on
    every rank but 0 (lmdeploy_tpu/utils/logger.py:31-37); the rank is
    torch.distributed's when its group is initialised, else RANK's."""
    monkeypatch.setenv('LMDEPLOY_TPU_LOG_LEVEL', 'INFO')
    monkeypatch.setenv('LMDEPLOY_TPU_LOG_FIRST_RANK_ONLY', first_only)
    if rank is None:
        monkeypatch.delenv('RANK', raising=False)
    else:
        monkeypatch.setenv('RANK', rank)
    if dist_rank is not None:
        monkeypatch.setattr(torch.distributed, 'is_initialized',
                            lambda: True)
        monkeypatch.setattr(torch.distributed, 'get_rank',
                            lambda group=None: dist_rank)
    assert _fresh_logger('lmdeploy_tpu_torch_test_rank').level == want


def test_phase_timer_counts_match_jax():
    """The same phases give the JAX PhaseTimer's counts and report names."""
    timers = (JPhaseTimer(), tprofiler.PhaseTimer())
    for name in ('prefill', 'decode', 'decode', 'sample', 'decode'):
        for t in timers:
            with t.phase(name):
                pass
    for t in timers:
        with pytest.raises(ValueError):
            with t.phase('failed'):
                raise ValueError('counted all the same')
    j, p = timers
    assert dict(p.counts) == dict(j.counts) == {
        'prefill': 1, 'decode': 3, 'sample': 1, 'failed': 1}
    assert set(p.totals) == set(j.totals)
    names = [[line.split(':')[0] for line in t.report().splitlines()]
             for t in timers]
    assert names[0] == names[1] == ['decode', 'failed', 'prefill', 'sample']


def test_trace_writes_a_file_naming_the_annotation(tmp_path):
    """trace() writes a torch.profiler Chrome trace under log_dir on exit,
    and annotate() names a region in it."""
    with tprofiler.trace(str(tmp_path / 'tr')):
        with tprofiler.annotate('tools.decode'):
            (torch.ones(64) * 2).sum()
    files = list((tmp_path / 'tr').iterdir())
    assert len(files) == 1 and files[0].suffix == '.json'
    events = json.loads(files[0].read_text())['traceEvents']
    assert any(e.get('name') == 'tools.decode' for e in events)


def _numpy_params(seed=0):
    """Dense f32 parameters drawn with numpy (scaled so logits spread)."""
    rng = np.random.default_rng(seed)
    d, qkv, nl, inter, v = 256, 512, 2, 256, 256

    def w(*shape, s=0.06):
        return (rng.normal(size=shape) * s).astype(np.float32)
    return {'tok_embedding': w(v, d, s=1.0),
            'norm': rng.uniform(0.8, 1.2, size=(d,)).astype(np.float32),
            'lm_head': w(d, v),
            'layers': {'attn_norm': rng.uniform(0.8, 1.2, size=(nl, d)
                                                ).astype(np.float32),
                       'ffn_norm': rng.uniform(0.8, 1.2, size=(nl, d)
                                               ).astype(np.float32),
                       'wqkv': w(nl, d, qkv), 'wo': w(nl, d, d),
                       'w1': w(nl, d, inter), 'w3': w(nl, d, inter),
                       'w2': w(nl, inter, d)}}


# one prefill chunk of 2 rows x 16 and one decode step, identical
# StepBatch shapes in both packages
_PT = np.array([[0, 1], [2, 3]], np.int32)
_STEPS = [
    (np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32),
     np.tile(np.arange(16, dtype=np.int32), (2, 1)),
     np.ones((2, 16), bool), np.array([16, 16], np.int32)),
    (np.array([[7], [99]], np.int32), np.array([[16], [16]], np.int32),
     np.ones((2, 1), bool), np.array([17, 17], np.int32)),
]


def _jax_forwards(tree):
    cfg = JModelConfig(**CFG)
    jp = jax.tree.map(jnp.asarray, tree)
    cache = jinit_cache(2, 4, 16, 1, 128, jnp.float32)
    out = []
    for ids, pos, valid, ctx in _STEPS:
        batch = jllama.StepBatch(ids=jnp.asarray(ids),
                                 positions=jnp.asarray(pos),
                                 valid=jnp.asarray(valid),
                                 context_len=jnp.asarray(ctx),
                                 page_table=jnp.asarray(_PT))
        logits, cache = jllama.forward(jp, cache, batch, cfg)
        out.append(np.asarray(logits))
    jax.effects_barrier()
    return out


def _port_forwards(tree):
    cfg = ModelConfig(**CFG)
    params = params_from_numpy(tree, 'cpu')
    cache = init_cache(2, 4, 16, 1, 128, torch.float32, 'cpu')
    out = []
    for ids, pos, valid, ctx in _STEPS:
        batch = tllama.StepBatch(ids=torch.from_numpy(ids),
                                 positions=torch.from_numpy(pos),
                                 valid=torch.from_numpy(valid),
                                 context_len=torch.from_numpy(ctx),
                                 page_table=torch.from_numpy(_PT))
        logits, _ = tllama.forward(params, cache, batch, cfg)
        out.append(logits.numpy())
    return out


@pytest.fixture
def debug_mode(monkeypatch, tmp_path):
    """Set LMDEPLOY_TPU_DEBUG for both packages' debug modules (read at
    import: reload), clearing JAX's caches so that a forward traced with
    the mode off is traced anew; both are reloaded with the mode off
    afterwards."""
    def set_mode(mode):
        monkeypatch.setenv('LMDEPLOY_TPU_DEBUG', mode)
        monkeypatch.setenv('LMDEPLOY_TPU_DEBUG_DIR', str(tmp_path / 'cmp'))
        importlib.reload(jdebug)
        importlib.reload(tdebug)
        jax.clear_caches()
    yield set_mode
    monkeypatch.delenv('LMDEPLOY_TPU_DEBUG')
    importlib.reload(jdebug)
    importlib.reload(tdebug)
    jax.clear_caches()


@pytest.mark.parametrize('dumper', ['port', 'jax'])
def test_debug_dump_read_by_the_other_package(debug_mode, tmp_path, capsys,
                                              dumper):
    """One package dumps a prefill chunk and a decode step of a 2-layer f32
    model; the other, on identical parameters (params_from_numpy), reads
    the files with ``cmp``: every layer_out (one a layer, in layer order)
    and logits record reads OK, in the same f32 .npy files and names."""
    tree = _numpy_params()
    runs = {'port': _port_forwards, 'jax': _jax_forwards}
    debug_mode('dump')
    runs[dumper](tree)
    files = sorted(os.listdir(tmp_path / 'cmp'))
    assert files == sorted([f'layer_out.{n}.npy' for n in range(4)]
                           + ['logits.0.npy', 'logits.1.npy'])
    assert np.load(tmp_path / 'cmp' / 'layer_out.0.npy').shape == (2, 16,
                                                                   256)
    assert np.load(tmp_path / 'cmp' / 'logits.1.npy').dtype == np.float32
    capsys.readouterr()
    debug_mode('cmp')
    runs['jax' if dumper == 'port' else 'port'](tree)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('[cmp]')]
    assert len(lines) == 6, lines
    assert all(ln.startswith('[cmp] OK ') for ln in lines), lines
    assert sum('layer_out' in ln for ln in lines) == 4


def test_debug_off_writes_nothing_and_changes_nothing(debug_mode, tmp_path):
    """With the mode off, dbg returns before it touches its argument and a
    forward writes no file; its logits equal those of the same forward
    with the mode on (dump), bit for bit."""
    tree = _numpy_params(2)
    debug_mode('dump')
    on = _port_forwards(tree)
    assert os.listdir(tmp_path / 'cmp')
    debug_mode('')
    os.rename(tmp_path / 'cmp', tmp_path / 'was_on')
    assert not tdebug.enabled()
    tdebug.dbg('untouched', object())      # would raise if touched
    off = _port_forwards(tree)
    assert not (tmp_path / 'cmp').exists()
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
