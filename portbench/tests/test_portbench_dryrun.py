"""``run.py`` end to end at a tiny size on the CPU (the program's plain
versions), its look for a card skipped by ``--device cpu``: the result
line, the metrics each cell reports, the check and its control, and the
check failing when the served path is broken underneath.  The cells
themselves run on the card (``-m cuda``)."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import run

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
TINY_BENCH = str(HERE / 'data' / 'bench.json')


def dry_run(capsys, workload, *extra, seconds='2', seed='3000000011'):
    rc = run.main(['--workload', workload, '--seed', seed, '--seconds',
                   seconds, '--device', 'cpu', '--benchmark', TINY_BENCH,
                   *extra])
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize('workload,trace,names', [
    ('tiny.chat', '0', {'output_tok_s', 'setup_s'}),
    ('tiny.chat', '1', {'decode_batch_mean.chat', 'tpot_p95_ms.chat',
                        'decode_issue_ms.chat', 'pool_peak_share.chat',
                        'mfu.decode'}),
    ('tiny.score', '0', {'prompt_tok_s', 'setup_s'}),
    ('tiny.score', '1', {'prefill_tokens_per_pass.docscore',
                         'ttft_p95_ms.docscore', 'mfu.prefill'}),
])
def test_result_line(capsys, workload, trace, names):
    res, err = dry_run(capsys, workload, '--trace', trace)
    assert list(res)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                             'device']
    assert list(res)[-1] == 'check'
    assert res['correct'] is True, err[-2000:]
    assert res['failed'] == 0 and res['attempted'] > 0
    # the CPU has no device trace: its readers find nothing and are left
    # out; every other metric of the cell is there, and no other
    assert set(res['metrics']) == names
    for m in res['metrics'].values():
        assert m['value'] > 0
    assert res['device']['platform'] == 'cpu'
    assert err.strip().splitlines()[-1].startswith('check: ')


def failed_numbers(res):
    return [k for k, v in res['check'].items() if v['value'] > v['limit']]


@pytest.mark.parametrize('workload', ['tiny.chat', 'tiny.score'])
def test_control_is_not_correct(capsys, workload):
    """Each mix's control, read as a run is: the chat mix's program on its
    int4 pool, the docscore mix's on its int8 pool."""
    res, err = dry_run(capsys, workload, '--control')
    assert res['correct'] is False, err[-2000:]
    assert failed_numbers(res)


def _reference_records(raw, model, mix, n_new=6):
    """Two requests whose served tokens are the reference's own choices:
    its best token for the greedy one, for the sampled one the token at
    the middle of its nucleus after the repetition penalty."""
    import check
    import reference
    from serve import Record
    from traffic import Request, sampling_of
    recs = []
    for i, (n, greedy) in enumerate(((30, True), (45, False))):
        prompt = np.random.default_rng(i).integers(0, 512, n).astype(np.int32)
        req = Request(i, prompt, n_new, greedy, i)
        sp = sampling_of(req, mix)
        ids = torch.as_tensor(prompt, dtype=torch.int64)
        toks = []
        for _ in range(n_new):
            lg = reference.forward(raw, model, [ids],
                                   [torch.tensor([len(ids) - 1])])[0]
            lg = check.penalised(lg, torch.cat([ids, ids[:1]]), len(ids),
                                 sp['repetition_penalty'])
            floor = check.choice_floor(lg, sp['top_k'], sp['top_p'],
                                       sp['temperature'])
            inside = (lg[0] >= floor[0]).nonzero()[:, 0]
            order = lg[0, inside].argsort(descending=True)
            toks.append(int(inside[order[len(order) // 2]]))
            ids = torch.cat([ids, torch.tensor(toks[-1:])])
        recs.append(Record(req, 0.0, status=1, tokens=toks))
    return recs


def test_compare_reads_served_tokens_and_every_position():
    """The reference's own choices read 0, at the served tokens and at
    every position; one served token moved out of the nucleus, or one
    position's argmax moved, reads its gap."""
    import check
    import reference
    import weights
    model = json.load(open(HERE / 'data' / 'tiny.json'))['model']
    mix = json.load(open(HERE / 'data' / 'traffic' / 'tinychat.json'))
    raw = weights.make(model, 9, 'cpu')
    recs = _reference_records(raw, model, mix)
    out = check.compare(raw, model, mix, recs)
    assert out['max_gap'] == 0.0 and out['served_tokens'] == 12.0
    seqs = check._sequences(recs, 'cpu')
    full = reference.forward(raw, model, seqs,
                             [torch.arange(len(s)) for s in seqs])
    argmax = [lg.argmax(-1).numpy() for lg in full]
    out = check.compare(raw, model, mix, recs, program_argmax=argmax)
    assert out['max_gap'] == 0.0 and out['choices'] == 12.0 + sum(
        len(s) for s in seqs)
    argmax[0][3] = int(full[0][3].argmin())
    out = check.compare(raw, model, mix, recs, program_argmax=argmax)
    assert out['max_gap'] == pytest.approx(
        float(full[0][3].max() - full[0][3].min()), rel=1e-5)
    assert out['served_max_gap'] == 0.0
    # the sampled request's last token replaced by its worst
    last = full[1][-1:]
    worst = int(check.penalised(last, torch.cat([seqs[1], seqs[1][:1]]),
                                len(seqs[1]), 1.1).argmin())
    recs[1].tokens[-1] = worst
    out = check.compare(raw, model, mix, recs)
    assert out['served_max_gap'] > 0.1


def _token_altered(monkeypatch):
    from lmdeploy_tpu_torch.engine import step
    orig = step.sample_step

    def sample_step(logits, *a, **kw):
        out = orig(logits, *a, **kw)
        return ((out[0] + 1) % logits.shape[-1],) + tuple(out[1:])
    monkeypatch.setattr(step, 'sample_step', sample_step)


def _kv_not_stored(monkeypatch):
    from lmdeploy_tpu_torch.models import llama
    monkeypatch.setattr(llama, 'write_kv', lambda *a, **kw: None)


def _half_batch(monkeypatch):
    from lmdeploy_tpu_torch.models import llama
    orig = llama.paged_decode_attention_write
    calls = [0]

    def attend(*a, **kw):
        o = orig(*a, **kw)
        calls[0] += 1
        o = o.clone()
        o[(calls[0] // 2) % 2::2] = 0      # every other slot, by turns
        return o
    monkeypatch.setattr(llama, 'paged_decode_attention_write', attend)


def _nucleus_ignored(monkeypatch):
    """The sampler draws from the whole top-k, top-p left out."""
    import dataclasses
    from lmdeploy_tpu_torch.engine import step
    orig = step.sample_step

    def sample_step(logits, state, *a, **kw):
        state = dataclasses.replace(state,
                                    top_p=torch.ones_like(state.top_p))
        return orig(logits, state, *a, **kw)
    monkeypatch.setattr(step, 'sample_step', sample_step)


@pytest.mark.parametrize('workload,fault', [
    ('tiny.chat', _token_altered), ('tiny.chat', _kv_not_stored),
    ('tiny.chat', _half_batch), ('tiny.chat', _nucleus_ignored),
    ('tiny.score', _token_altered), ('tiny.score', _kv_not_stored),
    ('tiny.score', _half_batch)])
def test_broken_path_is_not_correct(capsys, monkeypatch, workload, fault):
    fault(monkeypatch)
    res, err = dry_run(capsys, workload)
    assert res['correct'] is False, err[-2000:]
    assert failed_numbers(res)


def test_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    out = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'qwen14b-w4.chat',
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert out.returncode != 0 and out.stdout.strip() == ''


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['qwen14b-w4.chat',
                                      'internlm20b-w4.docscore'])
def test_cell_and_its_control_on_the_card(workload):
    """The cell at its own size: correct on a fresh seed, and its control
    not correct (``python -m pytest portbench/tests -m cuda`` on the
    card)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    seen = []
    for extra in ([], ['--control']):
        out = subprocess.run(
            [sys.executable, 'portbench/run.py', '--workload', workload,
             '--seed', '3000000021', '--seconds', '20', '--trace', '0',
             *extra], capture_output=True, text=True, timeout=1200,
            cwd=str(REPO))
        assert out.returncode == 0, out.stderr[-3000:]
        seen.append(json.loads(out.stdout.strip().splitlines()[-1]))
    assert seen[0]['correct'] is True
    assert seen[1]['correct'] is False
