"""The yardstick's arithmetic against counts made by hand: the shared
SpMM counts and the dense architecture's."""
import pytest

import counts
from conftest import DENSE

TINY = dict(hidden_size=4, intermediate_size=8, num_attention_heads=2,
            num_key_value_heads=1, vocab_size=10, num_hidden_layers=1,
            keep=0.5)


def test_spmm_min_bytes_and_flops():
    # vals + cols 5 x 8 B, B 3 x 4 x 4 B, C 2 x 4 x 4 B
    assert counts.spmm_min_bytes(2, 3, 4, 5) == 40 + 48 + 32
    assert counts.spmm_min_bytes(2, 3, 4, 5, val_bytes=2, out_bytes=2) \
        == 5 * 6 + 3 * 4 * 2 + 2 * 4 * 2
    assert counts.spmm_flops(5, 4) == 40.0


@pytest.mark.parametrize("d_in,keep,want", [(2048, 0.25, 512),
                                            (8192, 0.25, 2048),
                                            (29568, 0.25, 7392),
                                            (3, 0.1, 1), (4, 1.0, 4)])
def test_kept_per_row(d_in, keep, want):
    assert counts.kept_per_row(d_in, keep) == want


def test_ffn_matrices_granite():
    cfg = dict(hidden_size=2048, intermediate_size=8192, keep=0.25)
    assert counts.ffn_matrices(cfg) == [("w1", 8192, 2048, 8192 * 512),
                                        ("w3", 8192, 2048, 8192 * 512),
                                        ("w2", 2048, 8192, 2048 * 2048)]


def test_spmm_bound_takes_the_larger_side():
    # n = 1024: 2 * 1e6 * 1024 flops at 67 TFLOP/s against
    # 8e6 + 4 * 1024 * (1000 + 1000) + 4 * 1001 bytes at 3.35 TB/s.
    flops = 2 * 1e6 * 1024 / 67e12
    byts = (8e6 + 4 * 1024 * 2000 + 4 * 1001) / 3.35e12
    assert counts.spmm_bound_s(1000, 1000, 1024, 10 ** 6) == \
        pytest.approx(max(flops, byts))
    assert flops > byts
    # n = 1: bytes bound
    byts1 = (8e6 + 4 * 2000 + 4 * 1001) / 3.35e12
    assert counts.spmm_bound_s(1000, 1000, 1, 10 ** 6) == \
        pytest.approx(byts1)


def test_forward_bound_sums_every_matrix_of_every_layer():
    cfg = dict(TINY, num_hidden_layers=3)
    one = sum(counts.spmm_bound_s(m, k, 6, nnz)
              for _, m, k, nnz in counts.ffn_matrices(cfg))
    launches = DENSE.counts.spmm_launches(cfg)
    assert counts.forward_spmm_bound_s(launches, 6) == pytest.approx(3 * one)


def test_request_flops_by_hand():
    # d 4, 2 heads of 2, 1 kv head: wq, wo 16 params each, wk, wv 8 each
    # -> 48; FFN nonzeros: w1, w3 8 rows x 2 kept, w2 4 rows x 4 kept
    # -> 48; 3 tokens: 2 * 96 * 3 = 576; attention: 6 query-key pairs x
    # 2 heads x 2 dims x 2 (QK and PV) x 2 = 96; logits 2 * 4 * 10 * 3.
    assert DENSE.counts.request_flops(TINY, 3) == 576 + 96 + 240


def test_request_flops_scales_with_layers():
    one = DENSE.counts.request_flops(TINY, 5) - 2 * 4 * 10 * 5
    two = DENSE.counts.request_flops(dict(TINY, num_hidden_layers=2), 5) \
        - 2 * 4 * 10 * 5
    assert two == 2 * one
