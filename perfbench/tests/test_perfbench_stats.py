"""The rate is taken over every call of the window, and the calls kept
for the comparison are a sample of them all, bounded in size."""

import collections

import numpy as np
import pytest

import tiny
from pb import harness, score

CELL = "stablelm-12b.score-4k"


def test_rate_counts_every_call_of_the_window():
    out = harness.run_cell(CELL, 2 ** 31 + 71, 1.0, False, device="cpu",
                           overrides=tiny.overrides(CELL))
    drv = out["_work"]
    assert drv.n_calls > 2
    n = drv.n_calls * drv.B * drv.T
    assert out["metrics"]["score_tokens_per_s"]["value"] == pytest.approx(
        n / drv.window_s)
    assert out["attempted"] == drv.n_calls * drv.B
    # only ``sample_calls`` calls are held, whatever the window's length
    assert len(drv.rows) == len(drv.kept) == drv.n_slots


def _kept_calls(seed: int, n_calls: int, n_slots: int) -> list:
    s = score.Score.__new__(score.Score)
    s.rng, s.n_slots = np.random.default_rng(seed), n_slots
    slots = [None] * n_slots
    for i in range(n_calls):
        k = s._slot(i)
        if k is not None:
            slots[k] = i
    return slots


def test_every_call_is_kept_alike_and_the_seed_decides():
    assert _kept_calls(2 ** 31 + 5, 40, 2) == _kept_calls(2 ** 31 + 5, 40, 2)
    counts = collections.Counter()
    trials = 4000
    for seed in range(trials):
        counts.update(_kept_calls(seed, 10, 2))
    assert sum(counts.values()) == 2 * trials
    for i in range(10):
        assert counts[i] / trials == pytest.approx(0.2, abs=0.03)
