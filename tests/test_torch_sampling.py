"""The port's sampling pipeline (lmdeploy_tpu_torch/ops/sampling.py) against
the JAX package's on the CPU, on identical f32 logits, keys and per-slot
parameters.  The JAX side runs its exact top-k (LMDEPLOY_TPU_APPROX_TOPK=0;
the TPU's approx_max_k is not ported)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lmdeploy_tpu.ops import sampling as js
from lmdeploy_tpu_torch.ops import sampling as ts

torch.set_num_threads(1)
B, S = 8, 40


@pytest.fixture(autouse=True)
def exact_topk(monkeypatch):
    monkeypatch.setenv('LMDEPLOY_TPU_APPROX_TOPK', '0')


def fields(v, seed=0, penalties=True, bad=True):
    """Per-slot parameters as numpy: a mix of filters, temperatures
    (one effectively greedy), penalties, bad words and min lengths."""
    rng = np.random.default_rng(seed)
    bad_words = np.full((B, js.MAX_STOP_BAD_WORDS), -1, np.int32)
    if bad:
        bad_words[1, :3] = rng.integers(0, v, 3)
        bad_words[4, 0] = 7
    f = dict(
        top_k=np.array([0, 1, 40, 5, 0, 2000, 40, 0], np.int32),
        top_p=np.array([1.0, 0.9, 0.8, 1.0, 0.5, 0.95, 1.0, 0.7], np.float32),
        min_p=np.array([0.0, 0.0, 0.05, 0.0, 0.1, 0.0, 0.0, 0.02],
                       np.float32),
        temperature=np.array([1.0, 0.7, 0.8, 1e-4, 1.3, 1.0, 0.5, 0.9],
                             np.float32),
        repetition_penalty=np.ones(B, np.float32),
        presence_penalty=np.zeros(B, np.float32),
        frequency_penalty=np.zeros(B, np.float32),
        rng_key=np.stack([jax.random.key_data(jax.random.PRNGKey(s))
                          for s in rng.integers(0, 2 ** 31 - 1, B)])
        .astype(np.uint32).view(np.int32),
        bad_words=bad_words,
        stop_words=np.full((B, js.MAX_STOP_BAD_WORDS), -1, np.int32),
        eos_id=np.full(B, 2, np.int32),
        ignore_eos=np.zeros(B, bool),
        min_new_tokens=np.array([0, 5, 0, 0, 9, 0, 0, 0], np.int32),
        max_new_tokens=np.full(B, 64, np.int32))
    if penalties:
        f['repetition_penalty'][[0, 2, 5]] = [1.3, 0.8, 1.1]
        f['presence_penalty'][[2, 6]] = [0.5, -0.3]
        f['frequency_penalty'][[0, 6, 7]] = [0.4, 0.2, 0.7]
    return f


def states(f):
    """(JAX SamplingState, port SamplingState) from the same numpy."""
    j = js.SamplingState(**{k: jnp.asarray(v.view(np.uint32)
                                           if k == 'rng_key' else v)
                            for k, v in f.items()})
    t = ts.SamplingState(**{k: torch.from_numpy(np.array(v))
                            for k, v in f.items()})
    return j, t


def inputs(v, seed=1):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, v)) * 3).astype(np.float32)
    logits[:, 2] += 4.0                            # EOS often the argmax
    history = rng.integers(0, v, size=(B, S)).astype(np.int32)
    history[:, :6] = rng.integers(0, 12, size=(B, 6))   # repeats
    hl = rng.integers(8, S + 1, size=B).astype(np.int32)
    gen = np.minimum(rng.integers(0, 12, size=B), hl - 1).astype(np.int32)
    return logits, history, hl, gen


def near_filter_boundary(vals, top_k, top_p, min_p):
    """Candidates within rounding of a top-p or min-p cut, in float64:
    XLA's and PyTorch's exp and cumsum differ in the last bits, so the
    cut can fall on either side of them.  With top_p 1.0 the whole tail
    whose preceding mass rounds to 1 sits on that boundary."""
    c = vals.shape[1]
    kk = np.where(top_k <= 0, c, np.clip(top_k, 1, c))[:, None]
    v = np.where(np.arange(c)[None] < kk, vals.astype(np.float64), -np.inf)
    p = np.exp(v - v.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    near_p = np.abs(np.cumsum(p, axis=1) - p - top_p[:, None]) < 1e-5
    near_m = (np.abs(p - p[:, :1] * min_p[:, None]) < 1e-6) \
        & (min_p[:, None] > 0)
    return (near_p | near_m) & (p > 0)


def both(fn_j, fn_t, *arrays):
    return (np.asarray(fn_j(*[jnp.asarray(a) for a in arrays])),
            fn_t(*[torch.from_numpy(np.array(a)) for a in arrays]).numpy())


@pytest.mark.parametrize('v', [256, 32000])
def test_logit_passes_match_jax(v):
    """ban_words, mask_eos_below_min_len, apply_repetition_penalty (all
    three penalties, generated tokens from gen_start) and
    filter_candidates, to 1e-6."""
    f = fields(v)
    logits, history, hl, gen = inputs(v)
    want, got = both(js.ban_words, ts.ban_words, logits, f['bad_words'])
    np.testing.assert_array_equal(got, want)
    want, got = both(js.mask_eos_below_min_len, ts.mask_eos_below_min_len,
                     logits, f['eos_id'], gen, f['min_new_tokens'])
    np.testing.assert_array_equal(got, want)
    pen = [f['repetition_penalty'], f['presence_penalty'],
           f['frequency_penalty']]
    want, got = both(
        lambda *a: js.apply_repetition_penalty(*a[:6], gen_start=a[6]),
        lambda *a: ts.apply_repetition_penalty(*a[:6], gen_start=a[6]),
        logits, history, hl, *pen, hl - gen)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got != logits).any()
    want, got = both(js.apply_repetition_penalty, ts.apply_repetition_penalty,
                     logits, history, hl, pen[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    vals = -np.sort(-logits, axis=1)[:, :min(v, 1024)]
    want, got = both(js.filter_candidates, ts.filter_candidates, vals,
                     f['top_k'], f['top_p'], f['min_p'])
    far = ~near_filter_boundary(vals, f['top_k'], f['top_p'], f['min_p'])
    np.testing.assert_allclose(got[far], want[far], rtol=1e-6, atol=1e-6)
    assert far.mean() > 0.9
    assert (got <= -1e29).any() and (got > -1e29).any()


@pytest.mark.parametrize('topn', [0, 5])
@pytest.mark.parametrize('mode', ['greedy', 'candidates', 'full'])
@pytest.mark.parametrize('v', [256, 32000])
def test_sample_step_matches_jax(v, mode, topn):
    """Tokens and new keys equal; logprobs and top-N within 1e-5."""
    f = fields(v, seed=v + topn)
    logits, history, hl, gen = inputs(v, seed=2 + topn)
    jst, tst = states(f)
    want = js.sample_step(jnp.asarray(logits), jst, jnp.asarray(history),
                          jnp.asarray(hl), jnp.asarray(gen), mode=mode,
                          topn=topn)
    got = ts.sample_step(torch.from_numpy(logits), tst,
                         torch.from_numpy(history), torch.from_numpy(hl),
                         torch.from_numpy(gen), mode=mode, topn=topn)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(want[1]).view(np.int32))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-5)
    if topn:
        np.testing.assert_array_equal(got[3][0].numpy(),
                                      np.asarray(want[3][0]))
        np.testing.assert_allclose(got[3][1].numpy(), np.asarray(want[3][1]),
                                   rtol=1e-5, atol=1e-5)
    # the banned and min-length-blocked ids never come out
    toks = got[0].numpy()
    assert toks[1] not in f['bad_words'][1] and toks[4] not in (7, 2)


def test_host_passes_decision_is_the_identity_where_off():
    """passes=(False, False) on slots that enable neither pass equals the
    device-side decision: the passes are per-slot identities."""
    f = fields(256, penalties=False, bad=False)
    logits, history, hl, gen = inputs(256)
    _, tst = states(f)
    args = (torch.from_numpy(logits), tst, torch.from_numpy(history),
            torch.from_numpy(hl), torch.from_numpy(gen))
    a = ts.sample_step(*args, mode='candidates')
    b = ts.sample_step(*args, mode='candidates', passes=(False, False))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert ts.full_vocab_passes(tst) == (False, False)


def test_make_rng_keys_matches_jax():
    seeds = [0, 5, 2 ** 31 - 1, 123456789]
    np.testing.assert_array_equal(
        ts.make_rng_keys(seeds).numpy(),
        np.asarray(js.make_rng_keys(seeds)).view(np.int32))


def test_unconstrained_sampling_covers_full_vocab():
    """top_k = 0 in 'full' mode samples the whole vocabulary (uniform
    logits over 2048: draws land above index 1024); in 'candidates' mode
    it is the top 1024 (tests/test_sampling.py:97)."""
    v, b = 2048, 4
    f = {k: x[:b] for k, x in fields(v, penalties=False, bad=False).items()}
    f['top_k'][:] = 0
    f['top_p'][:] = 1.0
    f['min_p'][:] = 0.0
    f['min_new_tokens'][:] = 0
    _, st = states(f)
    logits = torch.zeros((b, v))
    hist = torch.zeros((b, 8), dtype=torch.int32)
    zeros = torch.zeros(b, dtype=torch.int32)
    high = {'full': 0, 'candidates': 0}
    for mode in high:
        st.rng_key = ts.make_rng_keys(range(b))
        for _ in range(16):
            toks, st.rng_key, _ = ts.sample_step(logits, st, hist, zeros,
                                                 zeros, mode=mode)
            high[mode] += int((toks >= 1024).sum())
    assert high['full'] > 0 and high['candidates'] == 0


def test_sampled_marginal_matches_the_filtered_distribution():
    """4096 independent keys on one row: the empirical token distribution
    is the top-k / top-p / penalised / tempered softmax (the JAX package's
    full-vocab oracles), within 0.05 total variation."""
    v, n = 64, 4096
    rng = np.random.default_rng(5)
    row = (rng.normal(size=v) * 2).astype(np.float32)
    hist = np.tile(rng.integers(0, v, size=(1, 16)).astype(np.int32), (n, 1))
    f = {k: np.repeat(x[:1], n, axis=0)
         for k, x in fields(v, penalties=False, bad=False).items()}
    f.update(top_k=np.full(n, 12, np.int32), top_p=np.full(n, 0.9,
                                                           np.float32),
             temperature=np.full(n, 0.8, np.float32),
             repetition_penalty=np.full(n, 1.2, np.float32),
             rng_key=ts.make_rng_keys(range(n)).numpy())
    jst, tst = states(f)
    hl = np.full(n, 16, np.int32)
    gen = np.zeros(n, np.int32)
    logits = np.tile(row, (n, 1))
    toks = ts.sample_step(torch.from_numpy(logits), tst,
                          torch.from_numpy(hist), torch.from_numpy(hl),
                          torch.from_numpy(gen), mode='candidates')[0]
    lg = js.apply_repetition_penalty(jnp.asarray(logits[:1]),
                                     jnp.asarray(hist[:1]), jnp.asarray(hl[:1]),
                                     jnp.asarray([1.2], jnp.float32))
    lg = js.top_p_mask(js.top_k_mask(lg / 0.8, jnp.asarray([12])),
                       jnp.asarray([0.9], jnp.float32))
    p = np.asarray(jax.nn.softmax(lg, axis=-1), np.float64)[0]
    emp = np.bincount(toks.numpy(), minlength=v) / n
    assert 0.5 * np.abs(emp - p).sum() < 0.05
    assert (emp[p == 0] == 0).all()


def test_greedy_keys_advance_every_step():
    """Greedy draws nothing, yet its keys split like every other mode's
    (so a greedy turn followed by a sampled one stays reproducible)."""
    f = fields(256)
    logits, history, hl, gen = inputs(256)
    _, tst = states(f)
    args = (torch.from_numpy(logits), tst, torch.from_numpy(history),
            torch.from_numpy(hl), torch.from_numpy(gen))
    g = ts.sample_step(*args, mode='greedy')[1]
    c = ts.sample_step(*args, mode='candidates')[1]
    np.testing.assert_array_equal(g.numpy(), c.numpy())
    assert not torch.equal(g, tst.rng_key)
    jk = jax.vmap(jax.random.split)(jnp.asarray(f['rng_key'].view(np.uint32)))
    np.testing.assert_array_equal(g.numpy(),
                                  np.asarray(jk[:, 0]).view(np.int32))


def test_state_init_matches_jax_defaults():
    j = js.SamplingState.init(3)
    t = ts.SamplingState.init(3, device='cpu')
    for fld in dataclasses.fields(t):
        np.testing.assert_array_equal(
            getattr(t, fld.name).numpy(),
            np.asarray(getattr(j, fld.name)).astype(
                getattr(t, fld.name).numpy().dtype))
