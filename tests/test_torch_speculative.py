"""The port's speculative decoding (lmdeploy_tpu_torch/ops/speculative.py
and engine/step.py's speculative rounds) against the JAX package's on the
CPU, on identical inputs, keys and weights."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.engine import step as jstep
from lmdeploy_tpu.kvcache.paged import init_cache as jinit_cache
from lmdeploy_tpu.ops import sampling as jsmp
from lmdeploy_tpu.ops import speculative as jspec
from lmdeploy_tpu_torch.config import ModelConfig
from lmdeploy_tpu_torch.convert.workspace import params_from_numpy
from lmdeploy_tpu_torch.engine import step as tstep
from lmdeploy_tpu_torch.kvcache.paged import init_cache
from lmdeploy_tpu_torch.ops import sampling as tsmp
from lmdeploy_tpu_torch.ops import speculative as tspec

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def exact_topk(monkeypatch):
    monkeypatch.setenv('LMDEPLOY_TPU_APPROX_TOPK', '0')


def _ngram_cases():
    rng = np.random.default_rng(0)
    planted = np.zeros((2, 32), np.int32)
    planted[0, :9] = [1, 5, 6, 7, 9, 9, 5, 6, 7]
    planted[1, :6] = [1, 2, 3, 4, 5, 6]
    cascade = np.zeros((2, 32), np.int32)
    cascade[0, :9] = [1, 8, 9, 5, 5, 2, 7, 8, 9]
    cascade[1, :11] = [5, 6, 7, 9, 8, 1, 1, 2, 5, 6, 7]
    short = np.tile(np.array([[4, 4, 4, 4, 0, 0, 0, 0]], np.int32), (4, 1))
    full = rng.integers(0, 3, size=(3, 24)).astype(np.int32)
    rand = rng.integers(0, 5, size=(16, 48)).astype(np.int32)
    return [
        ('planted', planted, [9, 6]),
        ('cascade', cascade, [9, 11]),
        ('short', short, [0, 1, 2, 3]),
        ('full row', full, [24, 24, 23]),
        ('random', rand, rng.integers(0, 49, size=16)),
    ]


@pytest.mark.parametrize('ngram_min', [0, 1, 2])
@pytest.mark.parametrize('case', _ngram_cases(), ids=lambda c: c[0])
def test_ngram_propose_matches_jax(case, ngram_min):
    """Planted repeats, the longest-first cascade, histories shorter than
    ngram + 1 and full rows: the drafts equal the JAX package's."""
    _, hist, hl = case
    hl = np.asarray(hl, np.int32)
    for k in (2, 4):
        want = np.asarray(jspec.ngram_propose(
            jnp.asarray(hist), jnp.asarray(hl), k, 3, ngram_min))
        got = tspec.ngram_propose(torch.from_numpy(hist),
                                  torch.from_numpy(hl), k, 3, ngram_min)
        np.testing.assert_array_equal(got.numpy(), want)


def _fields(b, v, seed, greedy=False, penalties=False):
    rng = np.random.default_rng(seed)
    f = dict(
        top_k=rng.choice([0, 1, 5, 40], size=b).astype(np.int32),
        top_p=rng.choice([1.0, 0.9, 0.6], size=b).astype(np.float32),
        min_p=rng.choice([0.0, 0.05], size=b).astype(np.float32),
        temperature=rng.choice([0.7, 1.0, 1.3], size=b).astype(np.float32),
        repetition_penalty=np.ones(b, np.float32),
        presence_penalty=np.zeros(b, np.float32),
        frequency_penalty=np.zeros(b, np.float32),
        rng_key=tsmp.make_rng_keys(rng.integers(0, 2 ** 31 - 1, b)).numpy(),
        bad_words=np.full((b, 32), -1, np.int32),
        stop_words=np.full((b, 32), -1, np.int32),
        eos_id=np.full(b, 2, np.int32),
        ignore_eos=np.zeros(b, bool),
        min_new_tokens=np.zeros(b, np.int32),
        max_new_tokens=np.full(b, 512, np.int32))
    if greedy:
        f['top_k'][:] = 1
    if penalties:
        f['repetition_penalty'][:] = rng.choice([1.0, 1.3], size=b)
        f['presence_penalty'][:] = rng.choice([0.0, 0.5], size=b)
        f['frequency_penalty'][:] = rng.choice([0.0, 0.4], size=b)
        f['bad_words'][0, :2] = [3, 11]
        f['min_new_tokens'][:] = rng.choice([0, 6], size=b)
    return f


def _states(f):
    j = jsmp.SamplingState(**{k: jnp.asarray(v.view(np.uint32)
                                             if k == 'rng_key' else v)
                              for k, v in f.items()})
    t = tsmp.SamplingState(**{k: torch.from_numpy(np.array(v))
                              for k, v in f.items()})
    return j, t


VERIFY_CASES = [('greedy-degenerate', 'candidates', dict(greedy=True)),
                ('candidates', 'candidates', {}),
                ('full', 'full', {}),
                ('penalties', 'candidates', dict(penalties=True))]


@pytest.mark.parametrize('topn', [0, 3])
@pytest.mark.parametrize('case', VERIFY_CASES, ids=lambda c: c[0])
def test_spec_verify_sample_matches_jax(case, topn):
    """g and accept equal, logp and the top-N planes within 1e-5."""
    _, mode, kw = case
    b, k, v, s = 6, 4, 256, 40
    rng = np.random.default_rng(7 + topn)
    logits = (rng.normal(size=(b, k + 1, v)) * 3).astype(np.float32)
    am = logits.argmax(-1)
    draft = rng.integers(0, v, size=(b, k)).astype(np.int32)
    draft[:3] = am[:3, :k]                     # some drafts match the argmax
    hist = rng.integers(0, 16, size=(b, s)).astype(np.int32)
    hl = rng.integers(8, s - k, size=b).astype(np.int32)
    gen = np.minimum(rng.integers(0, 8, size=b), hl - 1).astype(np.int32)
    f = _fields(b, v, 11 + topn, **kw)
    jst, tst = _states(f)
    keys = f['rng_key']
    want = jspec.spec_verify_sample(
        jnp.asarray(logits), jnp.asarray(draft), jst, jnp.asarray(hist),
        jnp.asarray(hl), jnp.asarray(gen),
        jax.vmap(jax.random.wrap_key_data)(jnp.asarray(keys.view(np.uint32))),
        mode=mode, topn=topn)
    got = tspec.spec_verify_sample(
        torch.from_numpy(logits), torch.from_numpy(draft), tst,
        torch.from_numpy(hist), torch.from_numpy(hl), torch.from_numpy(gen),
        torch.from_numpy(keys), mode=mode, topn=topn)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-5)
    if topn:
        np.testing.assert_array_equal(got[3][0].numpy(),
                                      np.asarray(want[3][0]))
        np.testing.assert_allclose(got[3][1].numpy(), np.asarray(want[3][1]),
                                   rtol=1e-5, atol=1e-5)
    if kw.get('greedy'):
        assert (got[0].numpy() == am).all() and got[1][:3].all()


def test_spec_verify_sample_marginal_is_exact():
    """The port's rejection-sampling verify emits the plain path's
    processed distribution (tests/test_speculative.py:305): the
    position-0 marginal, the acceptance probability and the position-1
    marginal given acceptance, over 8192 keys, against the JAX package's
    full-vocab oracles."""
    rng = np.random.default_rng(0)
    b, k, v, n = 2, 2, 64, 8192
    logits = (rng.normal(size=(b, k + 1, v)) * 2.0).astype(np.float32)
    draft = np.asarray([[3, 7], [10, 11]], np.int32)
    f = _fields(b, v, 0)
    f.update(top_k=np.asarray([8, 0], np.int32),
             top_p=np.asarray([0.85, 1.0], np.float32),
             min_p=np.zeros(b, np.float32),
             temperature=np.asarray([0.7, 1.0], np.float32),
             repetition_penalty=np.asarray([1.0, 1.4], np.float32),
             presence_penalty=np.asarray([0.6, 0.0], np.float32),
             frequency_penalty=np.asarray([0.0, 0.5], np.float32),
             eos_id=np.ones(b, np.int32))
    hist = rng.integers(0, v, (b, 24)).astype(np.int32)
    hl = np.asarray([10, 12], np.int32)
    gen = np.asarray([4, 6], np.int32)

    def oracle(pos, hist_o, hl_o):
        lg = jsmp.apply_repetition_penalty(
            jnp.asarray(logits[:, pos]), jnp.asarray(hist_o),
            jnp.asarray(hl_o), jnp.asarray(f['repetition_penalty']),
            jnp.asarray(f['presence_penalty']),
            jnp.asarray(f['frequency_penalty']),
            gen_start=jnp.asarray(hl - gen))
        lg = lg / jnp.asarray(f['temperature'])[:, None]
        lg = jsmp.top_k_mask(lg, jnp.asarray(f['top_k']))
        lg = jsmp.top_p_mask(lg, jnp.asarray(f['top_p']))
        return np.asarray(jax.nn.softmax(lg, axis=-1), np.float64)

    p0 = oracle(0, hist, hl)
    hist1 = hist.copy()
    hist1[np.arange(b), hl] = draft[:, 0]
    p1 = oracle(1, hist1, hl + 1)

    # n independent copies of the two slots, one key each
    _, tst = _states({key: np.tile(val, (n,) + (1,) * (val.ndim - 1))
                      for key, val in f.items()})
    keys = tsmp.make_rng_keys(range(n * b))
    g, accept, logp = tspec.spec_verify_sample(
        torch.from_numpy(np.tile(logits, (n, 1, 1))),
        torch.from_numpy(np.tile(draft, (n, 1))), tst,
        torch.from_numpy(np.tile(hist, (n, 1))),
        torch.from_numpy(np.tile(hl, n)), torch.from_numpy(np.tile(gen, n)),
        keys)
    g = g.numpy().reshape(n, b, k + 1)
    accept = accept.numpy().reshape(n, b, k)
    logp = logp.numpy().reshape(n, b, k + 1)
    for i in range(b):
        np.testing.assert_allclose(np.exp(logp[:100, i, 0]),
                                   p0[i, g[:100, i, 0]], rtol=2e-3)
        emp0 = np.bincount(g[:, i, 0], minlength=v) / n
        assert 0.5 * np.abs(emp0 - p0[i]).sum() < 0.06, i
        assert abs(accept[:, i, 0].mean() - p0[i, draft[i, 0]]) < 0.03, i
        sel = g[accept[:, i, 0], i, 1]
        if sel.size > 500:
            emp1 = np.bincount(sel, minlength=v) / sel.size
            assert 0.5 * np.abs(emp1 - p1[i]).sum() < 0.08, i


# a tiny f32 model (tests/test_torch_model.py's shapes, dense weights)
CFG = dict(head_num=2, kv_head_num=1, size_per_head=128, inter_size=256,
           num_layer=2, vocab_size=256, rotary_embedding=128,
           max_position_embeddings=512, session_len=256, group_size=128)


CYCLE = [17, 40, 99, 5, 60]


def _params(seed):
    """Dense f32 weights whose greedy next token is CYCLE's successor of
    the current one (identity elsewhere): the lm_head's column j is the
    embedding of j's predecessor, and the layers are small perturbations
    of the residual stream, so the drafts of a cycling history are
    accepted."""
    rng = np.random.default_rng(seed)
    d, qkv, inter, nl, v = 256, 512, 256, 2, 256

    def w(*shape, s=0.02):
        return (rng.normal(size=shape) * s).astype(np.float32)
    emb = w(v, d, s=1.0)
    pred = np.arange(v)
    pred[CYCLE] = np.roll(CYCLE, 1)
    return {'tok_embedding': emb, 'norm': np.ones(d, np.float32),
            'lm_head': np.ascontiguousarray(emb[pred].T),
            'layers': {'attn_norm': np.ones((nl, d), np.float32),
                       'ffn_norm': np.ones((nl, d), np.float32),
                       'wqkv': w(nl, d, qkv), 'wo': w(nl, d, d),
                       'w1': w(nl, d, inter), 'w3': w(nl, d, inter),
                       'w2': w(nl, inter, d)}}


@pytest.mark.parametrize('sampling', ['greedy', 'candidates'])
def test_spec_decode_rounds_match_jax(sampling):
    """Three rounds of k = 4 over a prepared state (one slot on a cycle
    the drafts hit, one random, one idle, one near its token limit): the
    packed readback's token, finish, count and rng rows are equal and the
    logprob rows within 1e-5, for the running slots; the idle slot's rows
    are padding on the port's side and garbage on JAX's, and are not
    compared (apart from its key, which stays put)."""
    jcfg, tcfg = JModelConfig(**CFG), ModelConfig(**CFG)
    tree = _params(3)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device='cpu')
    b, maxp, hist_len, page, pages = 4, 8, 96, 16, 24
    rng = np.random.default_rng(4)
    kv = rng.normal(size=(2, pages, page, 1, 128)).astype(np.float32)
    pt = np.full((b, maxp), -1, np.int32)
    pt[0, :4], pt[1, :3], pt[2, :2], pt[3, :3] = \
        [3, 7, 9, 11], [1, 2, 4], [5, 6], [12, 13, 14]
    history = np.zeros((b, hist_len), np.int32)
    history[0, :30] = CYCLE * 6
    history[1, :21] = rng.integers(0, 256, 21)
    history[2, :9] = rng.integers(0, 256, 9)
    history[3, :25] = CYCLE * 5
    hl = np.array([30, 21, 9, 25], np.int32)
    fields = dict(tokens=history[np.arange(b), hl - 1], context_len=hl - 1,
                  history=history, history_len=hl,
                  active=np.array([1, 1, 0, 1], bool), page_table=pt)
    f = _fields(b, 256, 9, greedy=sampling == 'greedy')
    f['max_new_tokens'][:] = [40, 40, 40, 3]
    f['top_k'][:] = [1, 40, 5, 1] if sampling == 'candidates' else 1
    f['top_p'][:] = [1.0, 0.9, 1.0, 1.0]

    jst, tst = _states(f)
    js = jstep.init_decode_state(b, maxp, hist_len)
    js = dataclasses.replace(js, sampling=jst,
                             **{k: jnp.asarray(v) for k, v in fields.items()})
    jc = dataclasses.replace(jinit_cache(2, pages, page, 1, 128, jnp.float32),
                             k=jnp.asarray(kv), v=jnp.asarray(kv * 0.5))
    jc, js, jpacked = jstep.spec_decode_rounds(
        jp, jc, js, jcfg, num_rounds=3, k_draft=4, ngram=3, ngram_min=2,
        sampling=sampling)

    ts = tstep.init_decode_state(b, maxp, hist_len, device='cpu')
    for k, v in fields.items():
        getattr(ts, k).copy_(torch.from_numpy(v))
    ts.sampling = tst
    tc = init_cache(2, pages, page, 1, 128, torch.float32, 'cpu')
    tc.k.copy_(torch.from_numpy(kv))
    tc.v.copy_(torch.from_numpy(kv * 0.5))
    ts, tpacked = tstep.spec_decode_rounds(tp, tc, ts, tcfg, num_rounds=3,
                                           k_draft=4, ngram=3, ngram_min=2,
                                           sampling=sampling)
    jpk, tpk = np.asarray(jpacked), tpacked.numpy()
    kp1 = 5
    assert tpk.shape == jpk.shape == (3, 3 * kp1 + 3, b)
    live = [0, 1, 3]
    exact = list(range(2 * kp1 + 1)) + [3 * kp1 + 1, 3 * kp1 + 2]
    np.testing.assert_array_equal(tpk[:, exact][..., live],
                                  jpk[:, exact][..., live])
    np.testing.assert_array_equal(tpk[:, 3 * kp1 + 1:, 2],
                                  jpk[:, 3 * kp1 + 1:, 2])
    lp = slice(2 * kp1 + 1, 3 * kp1 + 1)
    np.testing.assert_allclose(tpk[:, lp][..., live].view(np.float32),
                               jpk[:, lp][..., live].view(np.float32),
                               rtol=1e-5, atol=1e-5)
    n = tpk[:, 2 * kp1]
    assert n[:, 0].sum() == 15          # the cycle's drafts were accepted
    # the slot at its limit emits 3 tokens in round 0, the last finishing
    assert n[:, 3].tolist() == [3, 0, 0]
    assert tpk[0, kp1:2 * kp1, 3].tolist() == [0, 0, 1, 0, 0]
    for name in ('tokens', 'context_len', 'history_len', 'generated',
                 'finished'):
        np.testing.assert_array_equal(getattr(ts, name).numpy()[live],
                                      np.asarray(getattr(js, name))[live])
    np.testing.assert_array_equal(ts.history.numpy()[live],
                                  np.asarray(js.history)[live])
    # valid=False rows wrote no KV: the idle slot's pages are untouched
    np.testing.assert_array_equal(tc.k[:, [5, 6]].numpy(), kv[:, [5, 6]])


def test_spec_round_topn_planes_layout():
    """With topn > 0 the packed rows carry (K+1)*topn ids and their
    logprob bits, position-major, equal to the JAX package's."""
    jcfg, tcfg = JModelConfig(**CFG), ModelConfig(**CFG)
    tree = _params(5)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device='cpu')
    b, maxp, hist_len = 2, 4, 48
    history = np.zeros((b, hist_len), np.int32)
    history[0, :12] = [3, 4, 5] * 4
    history[1, :7] = [9, 8, 7, 6, 5, 4, 3]
    hl = np.array([12, 7], np.int32)
    pt = np.array([[0, 1, -1, -1], [2, 3, -1, -1]], np.int32)
    fields = dict(tokens=history[np.arange(b), hl - 1], context_len=hl - 1,
                  history=history, history_len=hl,
                  active=np.ones(b, bool), page_table=pt)
    f = _fields(b, 256, 2, greedy=True)
    jst, tst = _states(f)
    js = dataclasses.replace(jstep.init_decode_state(b, maxp, hist_len),
                             sampling=jst, **{k: jnp.asarray(v)
                                              for k, v in fields.items()})
    kv = np.random.default_rng(6).normal(
        size=(2, 6, 16, 1, 128)).astype(np.float32)
    jc = dataclasses.replace(jinit_cache(2, 6, 16, 1, 128, jnp.float32),
                             k=jnp.asarray(kv), v=jnp.asarray(kv))
    _, _, jpacked = jstep.spec_decode_rounds(
        jp, jc, js, jcfg, num_rounds=1, k_draft=2, ngram=2, sampling='greedy',
        topn=3)
    ts = tstep.init_decode_state(b, maxp, hist_len, device='cpu')
    for k, v in fields.items():
        getattr(ts, k).copy_(torch.from_numpy(v))
    ts.sampling = tst
    tc = init_cache(2, 6, 16, 1, 128, torch.float32, 'cpu')
    tc.k.copy_(torch.from_numpy(kv))
    tc.v.copy_(torch.from_numpy(kv))
    _, tpacked = tstep.spec_decode_rounds(tp, tc, ts, tcfg, num_rounds=1,
                                          k_draft=2, ngram=2,
                                          sampling='greedy', topn=3)
    jpk, tpk = np.asarray(jpacked), tpacked.numpy()
    assert tpk.shape == jpk.shape == (1, 3 * 3 + 3 + 2 * 3 * 3, b)
    ids = slice(12, 21)
    np.testing.assert_array_equal(tpk[:, :12 - 3], jpk[:, :12 - 3])
    np.testing.assert_array_equal(tpk[:, ids], jpk[:, ids])
    np.testing.assert_allclose(tpk[:, 21:].view(np.float32),
                               jpk[:, 21:].view(np.float32), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('kv_bits', [0, 8, 4])
def test_write_kv_masked_rows_collide_without_effect(kv_bits):
    """The verify's masked rows go through write_kv with every row written
    (no boolean-mask selection): masked rows whose stale page table points
    at the same places as kept rows, and a call with no kept row, leave the
    pool bit-identical to the JAX package's scatter."""
    from lmdeploy_tpu.kvcache import paged as jpaged
    from lmdeploy_tpu_torch.kvcache import paged as tpaged
    rng = np.random.default_rng(kv_bits)
    dh = 128
    shape = (2, 6, 8, 2, dh // 2 if kv_bits == 4 else dh)
    dtype = {0: np.float32, 8: np.int8, 4: np.uint8}[kv_bits]
    pool = (rng.normal(size=shape) if kv_bits == 0 else
            rng.integers(-100 if kv_bits == 8 else 0, 100, size=shape)
            ).astype(dtype)
    qp = (0.05, 1.0, 0.04, -2.0) if kv_bits else None
    # slot 0 keeps 5 rows at page 3; slot 1 (masked) maps the same page
    pt = np.array([[3, 4], [3, 4], [1, -1]], np.int32)
    pos = np.array([[2, 3, 4, 5, 6], [2, 3, 4, 5, 6], [6, 7, 8, 9, 10]],
                   np.int32)
    valid = np.array([[1, 1, 1, 1, 0], [0, 0, 0, 0, 0], [1, 1, 0, 0, 0]],
                     bool)
    for v_mask in (valid, np.zeros_like(valid)):
        kn = rng.normal(size=(3, 5, 2, dh)).astype(np.float32)
        vn = rng.normal(size=(3, 5, 2, dh)).astype(np.float32)
        jk, jv = jpaged.write_kv(jnp.asarray(pool), jnp.asarray(pool), 1,
                                 jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(pos), jnp.asarray(pt),
                                 jnp.asarray(v_mask), qp)
        tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
        tpaged.write_kv(tk, tv, 1, torch.from_numpy(kn), torch.from_numpy(vn),
                        torch.from_numpy(pos), torch.from_numpy(pt),
                        torch.from_numpy(v_mask), qp)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert np.array_equal(tk.numpy(), pool) == (not v_mask.any())
