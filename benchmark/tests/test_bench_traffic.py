"""The generator of requests: a seed gives one sequence, another seed
another, and the mixes have the statistics they state."""

import numpy as np
import pytest

from _paths import BENCH
from harness.spec import load_json
from harness.traffic import Requests

SEED = 2 ** 31 + 987654321          # larger than 32 signed bits hold
MG = load_json(BENCH / "configs" / "mg-hcp-96-wtexp-pbe-f64.json")


def _take(mix_name, seed, n):
    mix = load_json(BENCH / "traffic" / f"{mix_name}.json")
    r = Requests(mix, MG, seed)
    return r, [r.next() for _ in range(n)]


def _unwrapped(r, cart):
    d = cart - r.frac0 @ r.box
    return d - np.round(d @ np.linalg.inv(r.box)) @ r.box


@pytest.mark.parametrize("mix", ["gs-cold", "md-warm", "eos-scan"])
def test_same_seed_same_requests_other_seed_other(mix):
    _, a = _take(mix, SEED, 4)
    _, b = _take(mix, SEED, 4)
    _, c = _take(mix, SEED + 1, 4)
    key = "c_over_a" if "c_over_a" in a[0] else "cart_A"
    for x, y, z in zip(a, b, c):
        assert np.array_equal(np.asarray(x[key]), np.asarray(y[key]))
        assert not np.array_equal(np.asarray(x[key]), np.asarray(z[key]))


def test_gs_cold_displacements_are_iid_at_sigma():
    r, reqs = _take("gs-cold", SEED, 3)
    us = [_unwrapped(r, q["cart_A"]) for q in reqs]
    for u in us:
        assert abs(np.std(u) - 0.10) < 0.01
    assert abs(np.corrcoef(us[0].ravel(), us[1].ravel())[0, 1]) < 0.15


def test_md_warm_steps_are_small_and_stationary():
    r, reqs = _take("md-warm", SEED, 40)
    u = [_unwrapped(r, q["cart_A"]) for q in reqs]
    steps = [np.sqrt(np.mean((b - a) ** 2)) for a, b in zip(u, u[1:])]
    assert 0.004 < np.mean(steps) < 0.006
    assert abs(np.std(u[-1]) - 0.10) < 0.015


def test_eos_c_over_a_in_range():
    _, reqs = _take("eos-scan", SEED, 50)
    ca = [q["c_over_a"] for q in reqs]
    assert min(ca) >= 1.58 and max(ca) <= 1.68 and np.std(ca) > 0.02
