"""The counting functions against sums worked out by hand."""
import pytest

import counting

TINY = dict(head_num=2, kv_head_num=1, size_per_head=4, inter_size=24,
            num_layer=3, vocab_size=10, group_size=4)


def test_projections_pad_inter_to_even_groups():
    # inter 24 = 6 groups of 4: even, unchanged; 20 = 5 groups -> 24
    assert counting.projections(TINY) == [
        ('wqkv', 8, 16), ('wo', 8, 8), ('w1', 8, 24), ('w3', 8, 24),
        ('w2', 24, 8)]
    odd = dict(TINY, inter_size=20)
    assert counting.projections(odd)[4] == ('w2', 24, 8)
    assert counting.projections(odd, padded=False)[4] == ('w2', 20, 8)


def test_qwen14b_w2_pads_107_groups_to_108():
    qwen = dict(head_num=40, kv_head_num=40, size_per_head=128,
                inter_size=13696, group_size=128)
    assert counting.projections(qwen)[4] == ('w2', 13824, 5120)


def test_gemm_flops_bytes_by_hand():
    flops, nbytes = counting.gemm_flops_bytes(m=3, k=8, n=16, group=4)
    assert flops == 2 * 3 * 8 * 16
    # packed 8*16/2, scales 2 groups * 16 * 2 B, x 3*8*2, y 3*16*4
    assert nbytes == 64 + 64 + 48 + 192


def test_least_s_takes_the_larger_bound():
    assert counting.least_s(989e12, 0) == pytest.approx(1.0)
    assert counting.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert counting.least_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_layer_gemm_least_s_sums_five_products():
    want = sum(counting.least_s(*counting.gemm_flops_bytes(2, k, n, 4))
               for k, n in ((8, 16), (8, 8), (8, 24), (8, 24), (24, 8)))
    assert counting.layer_gemm_least_s(TINY, 2) == pytest.approx(want)
    assert counting.layer_gemm_least_s(TINY, 0) == 0.0


def test_decode_attention_by_hand():
    # contexts 3 and 5, int8: K and V of kv_head_num 1 x Dh 4 = 8 B a token
    flops, nbytes = counting.decode_attn_flops_bytes(TINY, [3, 5], 8)
    assert flops == 4 * 2 * 4 * 8
    assert nbytes == 8 * (8 + 2) + 2 * 2 * 4 * 2 * 2
    assert counting.kv_bytes_per_token(TINY, 0) == 16
    assert counting.kv_bytes_per_token(TINY, 4) == 4


def test_prefill_attention_is_causal_over_history():
    # a chunk of 3 after 2 tokens of history: tokens attend 3, 4, 5
    flops, nbytes = counting.prefill_attn_flops_bytes(TINY, [(2, 3)], 0)
    assert flops == 4 * 2 * 4 * (3 + 4 + 5)
    assert nbytes == 16 * 5 + 3 * 2 * 4 * 2 * 2
    assert counting.prefill_attn_flops_bytes(TINY, [(5, 0)], 0) == (0, 0)


def test_contexts_stop_when_a_slot_runs_out():
    assert counting.decode_contexts([(10, 2), (4, 5)], 3) == [11, 12, 5, 6, 7]
    assert counting.prefill_contexts([(0, 2), (7, 1)]) == [1, 2, 8]


def test_model_flops_by_hand():
    p = counting.published_params(TINY)
    assert p['layers'] == 3 * (8 * 16 + 8 * 8 + 2 * 8 * 24 + 24 * 8)
    assert p['lm_head'] == 8 * 10
    f = counting.model_flops(TINY, [1, 2], logits=1)
    assert f == 2 * p['layers'] * 2 + 2 * p['lm_head'] + 4 * 3 * 2 * 4 * 3
