"""Nothing the harness runs imports JAX, flax or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``lmdeploy_tpu_torch`` is the program, ``lmdeploy_tpu``
the JAX package."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent
MODULES = ['run', 'serve', 'reference', 'weights', 'check', 'tracing',
           'counting', 'readers', 'traffic']


def loaded_after(code: str) -> set:
    """Top-level names in sys.modules after ``code`` runs in a fresh
    interpreter set up as ``run.py`` sets itself up."""
    prog = (f'import sys; sys.path[:0] = [{str(BENCH)!r}, {str(REPO)!r}]\n'
            f'{code}\n'
            'import json; print(json.dumps(sorted({m.split(".")[0] '
            'for m in sys.modules})))')
    out = subprocess.run([sys.executable, '-c', prog], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    metrics = sorted(p.stem for p in (BENCH / 'metrics').glob('*.py'))
    code = '\n'.join(f'import {m}' for m in MODULES) + (
        '\nimport run\n'
        f'[run.reader(n) for n in {metrics!r}]')
    names = loaded_after(code)
    assert 'lmdeploy_tpu_torch' in names
    assert not names & {'jax', 'jaxlib', 'flax', 'lmdeploy_tpu'}, names
    # the JAX package's benchmark folder and scripts
    assert not names & {'benchmark', 'bench', 'bench_torch', 'chip_smoke'}


def test_reference_imports_nothing_of_the_program():
    names = loaded_after('import reference')
    assert 'lmdeploy_tpu_torch' not in names
    assert not names & {'jax', 'jaxlib', 'flax', 'lmdeploy_tpu'}


@pytest.mark.parametrize('loaded,found', [
    (['lmdeploy_tpu_torch', 'lmdeploy_tpu_torch.engine'], []),
    (['lmdeploy_tpu', 'lmdeploy_tpu.ops'], ['lmdeploy_tpu']),
    (['jaxlib.xla_client', 'jax_extra'], ['jaxlib']),
    (['flax', 'jax'], ['flax', 'jax']),
])
def test_forbidden_names_are_compared_whole(loaded, found):
    import run
    assert run.forbidden_modules(loaded) == found
