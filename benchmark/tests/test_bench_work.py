"""The frozen work counts against hand counts at the flagship and Lite
shapes."""

import pytest

from benchmark import work

FLAGSHIP = dict(dim_feat=512, mlp_ratio=2, num_joints=17, depth=5,
                dim_rep=512)
LITE = dict(dim_feat=256, mlp_ratio=4, num_joints=17, depth=5, dim_rep=512)
M = 32 * 243 * 17   # tokens of a (32, 243) batch


@pytest.mark.parametrize("cfg, products, temporal, spatial, gate, weights", [
    # 2 (3C^2 + C^2 + 2 C H) per token; 4 n C for the core; 2 * 2C * 2
    (FLAGSHIP, 4_194_304, 497_664, 34_816, 4_096, 2_097_152),
    (LITE, 1_572_864, 248_832, 17_408, 2_048, 786_432),
])
def test_pair_flops_and_bytes(cfg, products, temporal, spatial, gate,
                              weights):
    C = cfg["dim_feat"]
    H = C * cfg["mlp_ratio"]
    fixed = weights * 2 + (5 * C + H) * 2 + 4 * C * 4
    assert work.pair_cost(cfg, 32, 243, "temporal", False) == (
        M * (products + temporal), 2 * M * C * 2 + fixed)
    assert work.pair_cost(cfg, 32, 243, "spatial", True) == (
        M * (products + spatial + gate),
        3 * M * C * 2 + fixed + (4 * C + 2) * 2)
    f, b = work.pair_bwd_cost(cfg, 32, 243, "spatial", False)
    assert f == 2 * M * (products + spatial)
    assert b == 3 * M * C * 2 + 2 * fixed


def test_model_flops_per_token():
    # 20 pairs of products, 10 temporal and 10 spatial cores, 5 gates, the
    # embedding (3 -> C), pre-logits (C -> 512) and head (512 -> 3)
    per_token = (20 * 4_194_304 + 10 * 497_664 + 10 * 34_816 + 5 * 4_096
                 + 2 * 3 * 512 + 2 * 512 * 512 + 2 * 512 * 3)
    assert per_token == 89_761_792
    assert work.model_forward_flops(FLAGSHIP, 32, 243) == M * per_token
    assert work.train_step_flops(FLAGSHIP, 32, 243) == 3 * M * per_token


def test_train_step_least_time_is_compute_bound():
    least = work.train_step_least_s(FLAGSHIP, 32, 243)
    flops = 3 * sum(work.pair_cost(FLAGSHIP, 32, 243, m, g)[0]
                    for m, g in work.pairs(FLAGSHIP))
    assert least == pytest.approx(flops / work.PEAK_BF16_FLOPS)
    assert 0.034 < least < 0.038


def test_pairs_of_a_forward():
    p = work.pairs(LITE)
    assert len(p) == 20 and sum(g for _, g in p) == 5
    assert sum(m == "temporal" for m, _ in p) == 10

