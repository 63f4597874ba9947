"""The per-layer metrics that read the program's own spans and counters
(``engine.stats``' request lifecycle, ``StepFns.host_s``' forward, sampler
and prefill issue), read by a traced dry run of each tiny cell on the CPU
with a copy of the tests' benchmark file that lists them."""
import json
from pathlib import Path

import pytest

import run

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
SPANS = {
    'tiny.chat': [('forward_issue_ms.chat', 'model (models/llama.py forward)',
                   'output_tok_s'),
                  ('sampler_issue_ms.chat', 'model (models/llama.py forward)',
                   'output_tok_s'),
                  ('queue_wait_ms.chat',
                   'scheduler (engine/engine.py TorchEngine)',
                   'output_tok_s')],
    'tiny.score': [('queue_wait_ms.docscore',
                    'scheduler (engine/engine.py TorchEngine)',
                    'prompt_tok_s'),
                   ('prefill_span_ms.docscore',
                    'scheduler (engine/engine.py TorchEngine)',
                    'prompt_tok_s'),
                   ('first_token_ms.docscore',
                    'scheduler (engine/engine.py TorchEngine)',
                    'prompt_tok_s'),
                   ('prefill_issue_ms.docscore',
                    'dispatch (engine/step.py StepFns)', 'prompt_tok_s')],
}


@pytest.fixture(scope='module')
def bench_file(tmp_path_factory):
    bench = json.loads((HERE / 'data' / 'bench.json').read_text())
    for cell, metrics in SPANS.items():
        for name, layer, moves in metrics:
            bench['per_layer'].append(
                {'name': name, 'unit': 'ms', 'better': 'lower',
                 'source': 'program_counter', 'layer': layer,
                 'moves': moves, 'workloads': [cell]})
    path = tmp_path_factory.mktemp('spans') / 'bench.json'
    path.write_text(json.dumps(bench, indent=1))
    return str(path)


def test_the_accepted_benchmark_lists_each_reader():
    """Every metric here is in BENCHMARK.json, under the cell whose mix
    the tiny one copies, and has its reader."""
    per_layer = {m['name']: m for m in json.loads(
        (REPO / 'BENCHMARK.json').read_text())['per_layer']}
    cells = {'tiny.chat': 'qwen14b-w4.chat',
             'tiny.score': 'internlm20b-w4.docscore'}
    for cell, metrics in SPANS.items():
        for name, layer, moves in metrics:
            m = per_layer[name]
            assert (m['layer'], m['moves'], m['workloads']) == \
                (layer, moves, [cells[cell]])
            assert m['source'] == 'program_counter' and m['unit'] == 'ms'
            assert (HERE.parent / 'metrics' / f'{name}.py').is_file()


@pytest.mark.parametrize('workload', sorted(SPANS))
def test_traced_dry_run_reads_each_span_metric(capsys, bench_file,
                                               workload):
    rc = run.main(['--workload', workload, '--seed', '3000000017',
                   '--seconds', '2', '--trace', '1', '--device', 'cpu',
                   '--benchmark', bench_file])
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res['correct'] is True, out.err[-2000:]
    for name, _, _ in SPANS[workload]:
        assert res['metrics'][name]['value'] > 0, name
        assert res['metrics'][name]['unit'] == 'ms'


def test_readers_find_nothing_in_a_program_without_the_counters():
    """A run of a program that keeps none of these counters (an older
    build) reads None, not an error."""
    class Bare:
        stats0 = stats1 = {'decode_steps': 5, 'prefill_passes': 3}
        host0 = host1 = {'issue': 0.0, 'wait': 0.0}

        def delta(self, key):
            return self.stats1.get(key, 0) - self.stats0.get(key, 0)
    for metrics in SPANS.values():
        for name, _, _ in metrics:
            assert run.reader(name)(Bare()) is None, name
