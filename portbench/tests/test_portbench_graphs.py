"""The per-layer metrics of the decode steps replayed from CUDA graphs
(``graph_step_share.chat`` / ``.docscore``: engine.stats' graph_steps over
decode_steps in the window), read from synthetic window counters."""
import json
from pathlib import Path

import pytest

import run

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
CELLS = {'graph_step_share.chat': ('qwen14b-w4.chat', 'output_tok_s'),
         'graph_step_share.docscore': ('internlm20b-w4.docscore',
                                       'prompt_tok_s')}


class Window:
    """The engine's stats at the window's open and close."""

    def __init__(self, stats0, stats1):
        self.stats0, self.stats1 = stats0, stats1

    def delta(self, key):
        return self.stats1.get(key, 0) - self.stats0.get(key, 0)


def test_the_benchmark_lists_each_reader():
    per_layer = {m['name']: m for m in json.loads(
        (REPO / 'BENCHMARK.json').read_text())['per_layer']}
    for name, (cell, moves) in CELLS.items():
        m = per_layer[name]
        assert (m['layer'], m['moves'], m['workloads'], m['unit'],
                m['source']) == ('dispatch (engine/step.py StepFns)', moves,
                                 [cell], '%', 'program_counter')
        assert (HERE.parent / 'metrics' / f'{name}.py').is_file()


@pytest.mark.parametrize('name', sorted(CELLS))
def test_share_of_the_windows_decode_steps(name):
    read = run.reader(name)
    w = Window({'decode_steps': 40, 'graph_steps': 32},
               {'decode_steps': 240, 'graph_steps': 224})
    assert read(w) == pytest.approx(96.0)
    w = Window({'decode_steps': 0, 'graph_steps': 0},
               {'decode_steps': 16, 'graph_steps': 0})
    assert read(w) == 0.0


@pytest.mark.parametrize('name', sorted(CELLS))
def test_none_without_decode_steps_or_the_counter(name):
    """No decode step in the window, or a program without graph_steps
    (one before CUDA graphs): nothing to read."""
    read = run.reader(name)
    assert read(Window({'decode_steps': 8, 'graph_steps': 8},
                       {'decode_steps': 8, 'graph_steps': 8})) is None
    assert read(Window({'decode_steps': 8}, {'decode_steps': 72})) is None
    assert read(Window({}, {})) is None
