"""The model family hook (``family.py``): a dry run reaches the weights,
the parameter tree, the pool's qparams, the reference and the operation
count only through the configuration's family; the check reads that
family's reference, which loads nothing of the program, and a reference
that loads JAX as it runs leaves no result; the trace's reduction takes
the family's kernel classes first; an unknown family stops the run before
any weight is drawn.  The families are the tests' own
(``data/families/``), reached through ``families_dir`` in the tests'
benchmark file."""
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

import counting
import family
import reference
import run
import serve
import tracing
import weights

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
FAMILIES = HERE / 'data' / 'families'


@pytest.fixture
def bench_for(tmp_path):
    """The tests' benchmark file with ``families_dir`` (``where``) and the
    tiny configuration naming ``name`` as its family."""
    def make(name, where=FAMILIES):
        config = json.loads((HERE / 'data' / 'tiny.json').read_text())
        config['family'] = name
        cfile = tmp_path / f'tiny-{name.replace("/", "_")}.json'
        cfile.write_text(json.dumps(config))
        bench = json.loads((HERE / 'data' / 'bench.json').read_text())
        bench['families_dir'] = str(where.relative_to(REPO))
        bench['configs'][0]['file'] = str(cfile)
        path = tmp_path / 'bench.json'
        path.write_text(json.dumps(bench, indent=1))
        return str(path)
    return make


def dry_run(capsys, bench, workload, *extra):
    rc = run.main(['--workload', workload, '--seed', '3000000031',
                   '--seconds', '2', '--device', 'cpu', '--benchmark',
                   bench, *extra])
    return rc, capsys.readouterr()


def test_the_llama_family_is_the_harness_own_functions():
    """The Llama family re-exports the functions the accepted cells ran,
    so that their numbers stay as they were."""
    llama = family.load('llama')
    assert family.load('llama') is llama
    assert (llama.make, llama.engine_params, llama.forward,
            llama.model_flops) == (weights.make, serve.engine_params,
                                   reference.forward, counting.model_flops)
    assert llama.KERNEL_CLASSES == ()
    q = weights.kv_qparams(3, 11, 8)
    assert llama.kv_qparams({'num_layer': 3}, 11, 8) == (
        (q['k_scale'], q['k_zp'], q['v_scale'], q['v_zp']), q)


def test_a_run_reaches_the_model_only_through_its_family(
        capsys, monkeypatch, bench_for):
    """A traced dry run of the chat cell (int8 pool, so the qparams too)
    under the counted family: correct, and every call of the contract
    went through it; the Llama functions, called directly, would fail.
    (The Llama family's ``kv_qparams`` calls ``weights.kv_qparams`` by
    name: that one is counted instead, and each call has to be the
    family's.)"""
    counted = family.load('counted', FAMILIES)
    counted.CALLS.clear()
    llama = family.load('llama')

    def bypass(*args, **kw):
        raise AssertionError('called around the family')
    for mod, name in ((weights, 'make'), (serve, 'engine_params'),
                      (reference, 'forward'), (counting, 'model_flops')):
        monkeypatch.setattr(mod, name, bypass)
    for name in ('forward', *family.CONTRACT[:-1]):
        monkeypatch.setattr(llama, name, bypass)
    forward = counted.forward

    def counted_forward(*args, **kw):
        counted.CALLS['forward'] += 1
        return forward(*args, **kw)
    monkeypatch.setattr(counted, 'forward', counted_forward)
    qparams, direct = weights.kv_qparams, []

    def kv_qparams(*args, **kw):
        direct.append(args)
        return qparams(*args, **kw)
    monkeypatch.setattr(weights, 'kv_qparams', kv_qparams)
    rc, out = dry_run(capsys, bench_for('counted'), 'tiny.chat',
                      '--trace', '1')
    assert rc == 0, out.err[-3000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res['correct'] is True, out.err[-2000:]
    assert res['metrics']['mfu.decode']['value'] > 0
    calls = dict(counted.CALLS)
    assert calls.pop('model_flops') > 0
    assert calls == {'make': 2, 'engine_params': 1, 'kv_qparams': 1,
                     'forward': 1}
    assert len(direct) == 1


@pytest.mark.parametrize('workload', ['tiny.chat', 'tiny.score'])
def test_the_check_reads_the_family_reference(capsys, bench_for, workload):
    """A family whose reference leaves out the last layer fails the check
    of a sound run."""
    rc, out = dry_run(capsys, bench_for('short'), workload)
    assert rc == 0, out.err[-3000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res['correct'] is False, out.err[-2000:]
    assert [k for k, v in res['check'].items() if v['value'] > v['limit']]


def _trace(names):
    """A decode range over one launch and one kernel a name."""
    evs = [{'ph': 'X', 'cat': 'user_annotation', 'name': 'portbench.decode',
            'ts': 0, 'dur': 100 * len(names)}]
    for i, name in enumerate(names):
        evs.append({'ph': 'X', 'cat': 'cuda_runtime',
                    'name': 'cudaLaunchKernel', 'ts': 100 * i, 'dur': 5,
                    'args': {'correlation': i}})
        evs.append({'ph': 'X', 'cat': 'kernel', 'name': name,
                    'ts': 100 * i + 10, 'dur': 10 + i,
                    'args': {'correlation': i}})
    return {'traceEvents': evs}


def test_the_trace_takes_the_family_kernel_classes_first():
    names = ['void w4a16_wgmma<128, 2, 2, 0>(Params)',
             'void paged_decode<1, 8, 1>(Params)',
             'void paged_prefill_wgmma<0>(Params)',
             'void moe_grouped_gemm<64>(Params)',
             'void w4a16_wgmma_grouped<128>(Params)',
             'void at::native::vectorized_elementwise_kernel<4>(float)']
    classes = family.load('counted', FAMILIES).KERNEL_CLASSES
    mine = tracing.reduce(_trace(names), classes)['time_by']
    assert mine == {f'{c}|decode': pytest.approx((10 + i) * 1e-6)
                    for i, c in enumerate(['k1', 'k2', 'k3', 'kx', 'ky',
                                           'other'])}
    base = tracing.reduce(_trace(names))['time_by']
    assert base == {'k1|decode': pytest.approx(24e-6),
                    'k2|decode': pytest.approx(11e-6),
                    'k3|decode': pytest.approx(12e-6),
                    'other|decode': pytest.approx(28e-6)}


def test_a_reference_that_loads_jax_leaves_no_result(capsys, bench_for):
    """A family whose reference puts ``jax`` into ``sys.modules`` as it
    runs, after the window and the guard's first chance: a nonzero exit
    that names it, and no result line."""
    had = sys.modules.pop('jax', None)
    try:
        rc, out = dry_run(capsys, bench_for('loads_jax'), 'tiny.score')
        stub = sys.modules.get('jax')
    finally:
        sys.modules.pop('jax', None)
        if had is not None:
            sys.modules['jax'] = had
    assert isinstance(stub, types.ModuleType) and \
        not hasattr(stub, '__file__')
    assert rc == 5, out.err[-3000:]
    assert "['jax']" in out.err
    assert out.out.strip() == ''


@pytest.mark.parametrize('name,where', [
    ('nosuch', FAMILIES), ('counted/../short', FAMILIES),
    ('counted_reference', FAMILIES), ('inline', FAMILIES),
    ('weights', HERE.parent)])
def test_an_unknown_family_stops_the_run(capsys, monkeypatch, bench_for,
                                         name, where):
    """No such module in the families' folder, no module name, a
    reference's module, a family that defines its reference beside the
    program (``inline``), or a module without the contract's names (the
    harness's ``weights.py``): a nonzero exit that names the family, no
    result, no weight drawn."""
    def drawn(*args, **kw):
        raise AssertionError('weights drawn')
    monkeypatch.setattr(weights, 'make', drawn)
    rc, out = dry_run(capsys, bench_for(name, where), 'tiny.chat')
    assert rc != 0
    assert repr(name) in out.err
    assert out.out.strip() == ''


def loaded_after(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter set up as ``run.py`` sets itself up."""
    prog = ('import json, sys\n'
            f'sys.path[:0] = [{str(HERE.parent)!r}, {str(REPO)!r}]\n'
            f'{code}\n'
            'print(json.dumps(sorted({m.split(".")[0] '
            'for m in sys.modules})))')
    out = subprocess.run([sys.executable, '-c', prog], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_families_load_no_jax():
    """Each family of the benchmark, loaded as ``run.py`` loads it, leaves
    no JAX, flax or JAX package in the process (top-level names compared
    whole)."""
    assert family.names() == ['llama']
    names = loaded_after('import family\n'
                         'for n in family.names():\n'
                         '    family.load(n)')
    assert 'lmdeploy_tpu_torch' in names
    assert not names & {'jax', 'jaxlib', 'flax', 'lmdeploy_tpu'}, names


@pytest.mark.parametrize('name', family.names())
def test_a_family_reference_loads_nothing_of_the_program(name):
    """Each family's reference, loaded alone, leaves neither the program
    nor JAX in the process."""
    path = family.reference_path(name)
    names = loaded_after(
        'import importlib.util\n'
        'spec = importlib.util.spec_from_file_location(\n'
        f'    "ref", {str(path)!r})\n'
        'spec.loader.exec_module(importlib.util.module_from_spec(spec))')
    assert 'torch' in names
    assert not names & {'lmdeploy_tpu_torch', 'jax', 'jaxlib', 'flax',
                        'lmdeploy_tpu'}, names
