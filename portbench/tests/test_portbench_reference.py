"""The plain reference against an independent float64 forward at a tiny
size: numpy, token by token, from the weight bytes."""
import math

import numpy as np
import pytest
import torch

import check
import reference
import weights

TINY = dict(head_num=2, kv_head_num=1, size_per_head=8, inter_size=24,
            num_layer=2, vocab_size=40, norm_eps=1e-6, rotary_embedding=8,
            rope_theta=10000.0, max_position_embeddings=64,
            use_dynamic_ntk=False, use_logn_attn=False, attn_bias=True,
            qkv_bias_only=True, group_size=8)


def np_dequant(w, layer):
    p = w['packed'][layer].numpy().astype(np.int64)
    q = np.concatenate([p & 15, p >> 4], axis=0).astype(np.float64)
    s = w['scales'][layer].float().numpy().astype(np.float64)
    sz = w['sz'][layer].float().numpy().astype(np.float64)
    g = q.shape[0] // s.shape[0]
    return q * np.repeat(s, g, 0) - np.repeat(sz, g, 0)


def f64(t):
    return t.float().numpy().astype(np.float64)


def np_forward(raw, m, ids, kv=None):
    """Token by token in float64: Llama / Qwen as published."""
    h, kh, dh = m['head_num'], m['kv_head_num'], m['size_per_head']
    t = len(ids)
    x = f64(raw['embed'])[ids]
    lmax = m['max_position_embeddings']
    base = m['rope_theta']
    if m['use_dynamic_ntk'] and t > lmax:
        alpha = max(2 ** math.ceil(math.log(t / lmax, 2) + 1) - 1, 1)
        base = base * alpha ** (dh / (dh - 2))

    def norm(v, w):
        return v / np.sqrt((v * v).mean(-1, keepdims=True) + m['norm_eps']) \
            * f64(w)

    def rot(v, p):
        out = np.empty_like(v)
        for i in range(dh // 2):
            th = p * base ** (-2 * i / dh)
            a, b = v[..., i], v[..., i + dh // 2]
            out[..., i] = a * math.cos(th) - b * math.sin(th)
            out[..., i + dh // 2] = b * math.cos(th) + a * math.sin(th)
        return out

    for li in range(m['num_layer']):
        w = {n: np_dequant(raw[n], li) for n in reference.PROJ}
        a = norm(x, raw['attn_norm'][li])
        qkv = a @ w['wqkv'] + f64(raw['bqkv'][li])
        q = qkv[:, :h * dh].reshape(t, h, dh)
        k = qkv[:, h * dh:(h + kh) * dh].reshape(t, kh, dh)
        v = qkv[:, (h + kh) * dh:].reshape(t, kh, dh)
        for p in range(t):
            q[p], k[p] = rot(q[p], p), rot(k[p], p)
            if m['use_logn_attn'] and p + 1 > lmax:
                q[p] *= math.log(p + 1) / math.log(lmax)
        if kv is not None:
            lo, hi = (-128, 127) if kv['bits'] == 8 else (-8, 7)
            for arr, s, z in ((k, kv['k_scale'][li], kv['k_zp'][li]),
                              (v, kv['v_scale'][li], kv['v_zp'][li])):
                arr[:] = (np.clip(np.round(arr / s + z), lo, hi) - z) * s
        o = np.zeros((t, h, dh))
        for p in range(t):
            for hh in range(h):
                g = hh // (h // kh)
                sc = np.array([q[p, hh] @ k[j, g] for j in range(p + 1)]) \
                    / math.sqrt(dh)
                e = np.exp(sc - sc.max())
                o[p, hh] = (e / e.sum()) @ v[:p + 1, g]
        x = x + o.reshape(t, -1) @ w['wo']
        a = norm(x, raw['ffn_norm'][li])
        g1 = a @ w['w1']
        x = x + (g1 / (1 + np.exp(-g1)) * (a @ w['w3'])) @ w['w2']
    return norm(x, raw['norm']) @ f64(raw['lm_head'])[:, :m['vocab_size']]


def run_ref(raw, m, ids, **kw):
    seq = torch.as_tensor(ids)
    return reference.forward(raw, m, [seq], [torch.arange(len(ids))],
                             **kw)[0].double().numpy()


@pytest.mark.parametrize('case', ['plain', 'kv8', 'kv4', 'qwen'])
def test_reference_matches_float64(case):
    m = dict(TINY)
    kw = {}
    if case == 'qwen':     # dynamic NTK and logn past 6 positions
        m.update(max_position_embeddings=6, use_dynamic_ntk=True,
                 use_logn_attn=True)
    raw = weights.make(m, 123, 'cpu')
    if case.startswith('kv'):
        kw['kv'] = weights.kv_qparams(m['num_layer'], 5, int(case[2:]))
    ids = np.random.default_rng(0).integers(0, 40, 13)
    got = run_ref(raw, m, ids, **kw)
    want = np_forward(raw, m, ids, **kw)
    err = np.abs(got - want).max() / np.abs(want).max()
    # a rounding step that lands on the other side in float32 moves one
    # code: allowed for the quantised cases only
    tol = 1e-5 if case in ('plain', 'qwen') else 2e-2
    assert err < tol, err
    if case in ('plain', 'qwen'):
        assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_dequant_reads_half_split_nibbles():
    packed = torch.tensor([[[0x21, 0xF0]]], dtype=torch.uint8)  # K/2=1, N=2
    w = {'packed': packed,
         'scales': torch.tensor([[[2.0, 1.0]]], dtype=torch.bfloat16),
         'sz': torch.tensor([[[1.0, 0.0]]], dtype=torch.bfloat16)}
    # one group of K = 2: row 0 low nibbles (1, 0), row 1 high (2, 15)
    assert reference.dequant(w, 0).tolist() == [[1.0, 0.0], [3.0, 15.0]]


def test_gaps():
    lg = torch.tensor([[0.0, 2.0, 1.0], [3.0, 3.0, -1.0]])
    assert reference.gaps(lg, torch.tensor([2, 0])).tolist() == [1.0, 0.0]


def test_kv_qparams_do_not_saturate_at_the_estimated_spread():
    q = weights.kv_qparams(40, 3_000_000_001, 8)
    for s, z in zip(q['k_scale'], q['k_zp']):
        assert (127 - z) * s > 7.5 * weights.KV_STD
        assert (128 + z) * s > 7.5 * weights.KV_STD
    q4 = weights.kv_qparams(40, 3_000_000_001, 4)
    assert q4['k_scale'][0] == pytest.approx(q['k_scale'][0] * 17, rel=1e-6)


def test_choice_floor_by_hand():
    """Probabilities 0.5, 0.3, 0.15, 0.05 (logits their logs): top-p 0.8
    keeps the first two (0.5 < 0.8, 0.8 is not), top-p 0.81 three, top-k
    1 the best alone, top-k 2 then top-p 0.5 the first (0.5 / 0.8 =
    0.625 above the second)."""
    p = torch.tensor([[0.15, 0.5, 0.05, 0.3]])
    lg = p.log()
    cases = [(0, 0.8, 0.3), (0, 0.81, 0.15), (1, 1.0, 0.5), (2, 0.5, 0.5),
             (0, 1.0, 0.05)]
    for k, top_p, want in cases:
        got = check.choice_floor(lg, k, top_p, 1.0)
        assert got.tolist() == pytest.approx([math.log(want)]), (k, top_p)
    # temperature 0.5 squares the ratios: 0.25, 0.09, 0.0225, 0.0025 of
    # 0.365: the first holds 0.685, so top-p 0.8 keeps two
    assert check.choice_floor(lg, 0, 0.8, 0.5).tolist() == pytest.approx(
        [math.log(0.3)])
    assert check.choice_floor(lg, 0, 0.6, 0.5).tolist() == pytest.approx(
        [math.log(0.5)])


def test_penalised_by_hand():
    """Row r sees the history before token first + r: a seen positive logit
    is divided by the penalty, a seen negative one multiplied."""
    lg = torch.tensor([[2.0, -1.0, 3.0, -4.0], [2.0, -1.0, 3.0, -4.0]])
    hist = torch.tensor([1, 0, 2, 3])       # prompt (1, 0), then 2, 3
    out = check.penalised(lg, hist, 2, 2.0)
    assert out.tolist() == [[1.0, -2.0, 3.0, -4.0], [1.0, -2.0, 1.5, -4.0]]
    assert check.penalised(lg, hist, 2, 1.0) is lg


@pytest.mark.parametrize('logit_std', [0.32, 4.0])
def test_logits_spread_by_logit_std(logit_std):
    m = dict(TINY, head_num=4, kv_head_num=4, size_per_head=32,
             vocab_size=4096, inter_size=256, group_size=32)
    raw = weights.make(m, 7, 'cpu', logit_std)
    ids = np.random.default_rng(1).integers(0, 4096, 20)
    lg = run_ref(raw, m, ids)
    assert lg.std(-1).mean() == pytest.approx(logit_std, rel=0.15)
