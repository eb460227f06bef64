"""The one traffic generator: seeded, within the stated lengths, the same
multiset of lengths for every seed."""

import numpy as np
import pytest

from benchmark import harness, traffic

MIXES = sorted((harness.HERE / "traffic").glob("*.json"))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_lengths_seeded_and_in_range(path):
    spec = harness.load_json(path)["lengths"]
    a = traffic.lengths(spec, 512, np.random.default_rng(2 ** 31 + 5))
    b = traffic.lengths(spec, 512, np.random.default_rng(2 ** 31 + 5))
    c = traffic.lengths(spec, 512, np.random.default_rng(2 ** 33 + 9))
    assert (a == b).all() and not (a == c).all()
    assert sorted(a) == sorted(c)
    assert a.min() >= spec["low"] and a.max() <= spec["high"]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_driver_named_by_the_mix_exists(path):
    assert (harness.HERE / "drivers" / f"{harness.load_json(path)['driver']}.py").is_file()


def test_lengths_follow_their_distribution():
    lo = traffic.lengths({"dist": "loguniform", "low": 25, "high": 240}, 4096,
                         np.random.default_rng(1))
    assert 90 < lo.mean() < 100                    # (240 - 25) / ln(240 / 25) = 95
    un = traffic.lengths({"dist": "uniform", "low": 360, "high": 600}, 4096,
                         np.random.default_rng(1))
    assert abs(un.mean() - 480) < 1 and un.min() == 360 and un.max() == 600


def test_speakers_have_unit_norm():
    s = traffic.unit_speaker(np.random.default_rng(3), 5)
    assert s.shape == (5, 256) and np.allclose(np.linalg.norm(s, axis=1), 1.0, atol=1e-6)


def test_client_blocks_hold_the_same_lengths_for_every_seed():
    spec = {"dist": "uniform", "low": 360, "high": 600}
    a = [traffic.client_lengths(spec, 64, np.random.default_rng(s), c, 8, 8)
         for s in (5, 2 ** 40 + 1) for c in range(8)]
    for c in range(8):
        x, y = a[c], a[8 + c]
        assert not (x == y).all()
        for k in range(0, 64, 8):
            assert sorted(x[k:k + 8]) == sorted(y[k:k + 8])
    every = np.concatenate([a[c][:8] for c in range(8)])
    assert abs(every.mean() - 480) < 2 and every.min() >= 360 and every.max() <= 600
