"""The traffic generator: the same seed gives the same requests, every
block holds the distribution's quantiles, and the worst case fits the
pools the cells give."""
import json
import math
from pathlib import Path

import numpy as np
import pytest

import traffic

HERE = Path(__file__).resolve().parent
MIXES = HERE.parent / 'traffic'


def load(name):
    with open(MIXES / f'{name}.json') as f:
        return json.load(f)


@pytest.mark.parametrize('name', ['chat', 'docscore'])
def test_same_seed_same_requests(name):
    seed = 3_000_000_017            # past 32 signed bits
    a = traffic.Traffic(load(name), seed, 152064)
    b = traffic.Traffic(load(name), seed, 152064)
    for i in (0, 5, 63, 64, 200):
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra.prompt, rb.prompt)
        assert (ra.max_new, ra.greedy, ra.seed) == \
            (rb.max_new, rb.greedy, rb.seed)
    c = traffic.Traffic(load(name), seed + 1, 152064)
    assert not np.array_equal(a.request(0).prompt, c.request(0).prompt)


@pytest.mark.parametrize('name,mean_prompt', [('chat', 932), ('docscore', 2043)])
def test_blocks_hold_the_quantiles(name, mean_prompt):
    mix = load(name)
    t = traffic.Traffic(mix, 11, 152064)
    block = [t.request(i) for i in range(mix['block'])]
    lens = np.array([len(r.prompt) for r in block])
    outs = np.array([r.max_new for r in block])
    lo, hi = mix['prompt']['lo'], mix['prompt']['hi']
    assert lens.min() >= lo and lens.max() <= hi
    # the log-uniform mean (hi - lo) / ln(hi / lo), within the grid's step
    assert (hi - lo) / math.log(hi / lo) == pytest.approx(mean_prompt, abs=1)
    assert lens.mean() == pytest.approx(mean_prompt, rel=0.01)
    # every seed draws the same lengths, in another order
    other = traffic.Traffic(mix, 12, 152064)
    lens2 = sorted(len(other.request(i).prompt) for i in range(mix['block']))
    assert sorted(lens) == lens2
    assert sum(r.greedy for r in block) == round(mix['block']
                                                 * mix['greedy_share'])
    if mix['output']['dist'] == 'uniform':
        assert outs.min() >= mix['output']['lo']
        assert outs.max() <= mix['output']['hi']
        assert outs.mean() == pytest.approx(
            (mix['output']['lo'] + mix['output']['hi']) / 2, rel=0.01)
    else:
        assert set(outs) == {mix['output']['value']}


def test_prompt_ids_cover_the_vocabulary_and_differ():
    t = traffic.Traffic(load('chat'), 5, 1000)
    a, b = t.request(0).prompt, t.request(1).prompt
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < 1000
    assert not np.array_equal(a[:100], b[:100])


def test_ramp_staggers_outputs_over_its_range():
    mix = load('chat')
    ramp = traffic.Traffic(mix, 9, 152064).ramp_requests()
    outs = sorted(r.max_new for r in ramp)
    assert len(ramp) == mix['clients'] and all(r.index < 0 for r in ramp)
    assert outs[0] >= mix['ramp']['output']['lo']
    assert outs[-1] <= mix['ramp']['output']['hi']
    assert len(set(outs)) > mix['clients'] // 2


def test_worst_case_fits_the_cells_pools():
    chat, doc = load('chat'), load('docscore')
    # chat: 64 sessions of at most 1536 + 384 + 8 tokens, 31 pages each
    need = traffic.worst_case_pages(chat, 64, 8)
    assert need == 64 * 31
    assert need <= chat['engine']['num_pages']
    int8_token = 40 * 2 * 40 * 128      # Qwen-14B's KV bytes a token, int8
    assert need * 64 * int8_token == pytest.approx(52.0e9, rel=0.01)
    # docscore: 12 sessions of 3584 + 1 + 8 tokens, 57 pages each; the
    # bf16 pool of InternLM-20B on about 59.7 GB holds 759 pages
    need = traffic.worst_case_pages(doc, 64, 8)
    assert need == 12 * 57
    bf16_page = 64 * 60 * 2 * 40 * 128 * 2
    assert need * bf16_page < 59.7e9
    assert traffic.worst_case_pages(doc, 64, 8) > int(50e9 // bf16_page)


def test_quantiles_of_each_kind():
    assert list(traffic.quantiles({'dist': 'fixed', 'value': 3}, 2)) == [3, 3]
    assert list(traffic.quantiles({'dist': 'uniform', 'lo': 0, 'hi': 10},
                                  5)) == [1, 3, 5, 7, 9]
    with pytest.raises(ValueError):
        traffic.quantiles({'dist': 'zipf'}, 2)
