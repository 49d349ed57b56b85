"""The frozen operation and byte counts, against cases worked by hand."""

import pytest

from harness import costs
from harness.serve import Call


def test_paged_attn_cost_by_hand():
    # one row: ctx 16 keys, 2 queries, H 4, KVH 2, D 8, page 16, bf16
    f, b = costs.paged_attn_cost([(16, 2)], 4, 2, 8, 16, 2)
    assert f == 4 * 16 * 2 * 4 * 8
    q = 2 * 4 * 8 * 2
    kv = 16 * 2 * 8 * 2 * 2
    table, ctx_len = 1 * 4, 4
    out = 2 * 4 * (8 + 2) * 4
    assert b == q + kv + table + ctx_len + out


def test_paged_attn_cost_adds_rows_and_pages_round_up():
    f1, b1 = costs.paged_attn_cost([(17, 1)], 1, 1, 4, 16, 2)
    f2, b2 = costs.paged_attn_cost([(17, 1), (0, 3)], 1, 1, 4, 16, 2)
    assert f1 == f2 == 4 * 17 * 4
    assert b2 - b1 == 3 * 4 * 2 + 4 + 3 * (4 + 2) * 4
    assert b1 - (1 * 4 * 2 + 17 * 4 * 2 * 2 + 4 + 1 * 6 * 4) == 2 * 4


def test_roofline_picks_the_larger_bound():
    t, which = costs.roofline_seconds(costs.PEAK_BF16_FLOPS, 1.0)
    assert which == "compute" and t == pytest.approx(1.0)
    t, which = costs.roofline_seconds(1.0, costs.PEAK_HBM_BYTES * 2)
    assert which == "memory" and t == pytest.approx(2.0)


def test_block_causal_keys_of_a_prefill_chunk():
    # block 4, a chunk of positions 2..9 after 2 prefix tokens:
    # 2,3 see [0,4); 4..7 see [0,8); 8,9 see [0,10)
    assert costs._block_keys(2, 8, 4) == 2 * 4 + 4 * 8 + 2 * 10


def test_step_flops_by_hand():
    call = Call(0.0, 1.0, 4, rows=[(10, 3)], prefill=[(0, 4)], commits=1,
                computed=3)
    f = costs.step_flops(call, params=100, d_model=2, vocab=5,
                         n_attn_layers=2, n_heads=3, head_dim=4, block=4)
    attn = 4 * 2 * 3 * 4
    decode = 2 * 100 * 3 + 2 * 2 * 5 * 3 + attn * 3 * (10 + 3)
    prefill = 2 * 100 * 4 + 2 * 2 * 5 + attn * 4 * 4
    assert f == pytest.approx(decode + prefill)


def test_matmul_params_skip_embeddings_norms_and_named_leaves():
    import torch
    layout = {"embed": torch.empty(10, 4, device="meta"),
              "lm_head": torch.empty(4, 10, device="meta"),
              "blocks/pos0/norm1/scale": torch.empty(2, 4, device="meta"),
              "blocks/pos0/mixer/wq": torch.empty(2, 4, 4, device="meta"),
              "blocks/pos0/mixer/mu": torch.empty(2, 5, 4, device="meta")}
    assert costs.matmul_params(layout, ("mu",)) == 32
