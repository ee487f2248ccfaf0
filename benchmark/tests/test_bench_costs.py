"""``costs.py`` against counts made by hand."""

import json
from pathlib import Path

import costs

CFG = json.loads((Path(__file__).resolve().parents[1] / "configs"
                  / "sml_yelp_5m1m.json").read_text())


def test_k1_operations_per_row():
    # conv mixes 2*(3*10 + 10*5)*64 = 10,240; FCs 2*(320*512 + 512*64)
    # = 393,216
    assert costs.tower_flops(64, 10, 5, 512) == 403_456
    assert costs.k1_flops(6_000_000, 64, 10, 5, 512) == 6_000_000 * 403_456


def test_k1_bytes_bf16_snapshots():
    theta_tower = (30 + 10) + (50 + 5) + (320 * 512 + 512) + (512 * 64 + 64)
    assert costs.theta_params(64, 10, 5, 512) == 2 * theta_tower
    assert (costs.k1_bytes(1000, 64, 10, 5, 512, "bfloat16")
            == 1000 * 64 * (2 + 2 + 4) + theta_tower * 4)


def test_k3_bytes_and_elements():
    el = costs.k3_elements(5_000_000, 1_000_000, 64)
    assert el == 6_000_000 * 65
    # p, mu, nu in f32, each read once and written once
    assert costs.k3_bytes(el) == el * 24
    # its bound: 9.36 GB over 3.35 TB/s
    assert abs(costs.least_s(costs.k3_flops(el), costs.k3_bytes(el))
               - el * 24 / 3.35e12) < 1e-12


def test_sweep_counts_at_the_cell():
    c = costs.sweep_counts(CFG, 30_000, 30_000, 30_720, 30_720)
    assert c == {"inner_steps": 300, "outer_steps": 1180, "refreshes": 21,
                 "examples": 600_000, "inner_slots": 30,
                 "outer_slots": 120}


def test_period_least_time_is_k1_and_k3_mostly():
    c = costs.sweep_counts(CFG, 30_000, 30_000, 30_720, 30_720)
    least = costs.sweep_period_least_s(CFG, c, 30_000, 1000)
    k1 = 21 * 6_000_000 * 403_456 / 67e12
    k3 = 300 * 6_000_000 * 65 * 24 / 3.35e12
    assert k1 + k3 < least < (k1 + k3) * 1.05


def test_request_least_time():
    # one user: the 1.28 GB item table over the bandwidth
    t = costs.request_least_s(1, 5_000_000, 64, 20)
    assert abs(t - (5_000_001 * 256 + 20 * 12) / 3.35e12) < 1e-12
    # 1024 users: operation-bound
    t = costs.request_least_s(1024, 5_000_000, 64, 20)
    assert abs(t - 2 * 1024 * 5_000_000 * 64 / 67e12) < 1e-12
    assert (costs.score_bytes(2, 10, 4)
            == (2 + 10) * 4 * 4 + 2 * 10 * 4)
