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


def test_matmul_params_count_the_routed_experts():
    """A stack of experts ``[layers, E, in, out]`` counts ``top_k`` of its
    ``E``; the router and every other leaf in full."""
    import torch
    layout = {"blocks/pos0/ffn/router": torch.empty(2, 4, 8, device="meta"),
              "blocks/pos0/ffn/w_up": torch.empty(2, 8, 4, 6, device="meta"),
              "blocks/pos0/mixer/wq": torch.empty(2, 4, 4, device="meta")}
    assert costs.matmul_params(layout) == 64 + 384 + 32
    assert costs.matmul_params(layout, (), 8, 2) == 64 + 384 * 2 // 8 + 32


def _shape(arch: dict) -> dict:
    from harness import runner, serve
    cfg = {"arch": arch}
    model = serve.build_model(cfg)
    return runner.model_shape(model, model.init_params(device="meta"), cfg)


def test_model_shape_counts_a_moe_layer_by_hand():
    """Scout's SMOKE layout (2 layers, d 64, 8 heads and 2 KV heads of 8,
    4 experts of width 64, top-1): a layer's attention 4,096 + 1,024 +
    1,024 + 4,096, its router 256, one expert's three products 12,288."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    arch = dataclasses.asdict(get_smoke_config("llama4-scout-17b-a16e"))
    assert (arch["n_experts"], arch["top_k"]) == (4, 1)
    assert _shape(arch)["params"] == 2 * (10_240 + 256 + 12_288) == 45_568


def test_a_dense_configuration_counts_as_before():
    """SDAR-8B: 36 layers of attention (41,943,040) and FFN (150,994,944)."""
    import json

    from harness.spec import BENCH
    cfg = json.loads((BENCH / "configs" / "sdar-8b.json").read_text())
    assert _shape(cfg["arch"])["params"] == 6_945_767_424 == \
        36 * (41_943_040 + 150_994_944)
