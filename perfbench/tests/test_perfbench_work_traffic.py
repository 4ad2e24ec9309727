"""The work functions and the traffic generators."""

from __future__ import annotations

import collections

import numpy as np
import pytest

from perfbench.harness import loop, work

open_loop = loop.generator("open_loop")


def test_union_rows_merges_overlaps_band_by_band():
    starts = np.array([[0, 5, 20, 8], [100, 100, 0, 0]])
    lens = np.array([[10, 10, 5, 0], [3, 5, 0, 0]])
    # band 0: [0,10) u [5,15) u [20,25) = 20 rows; band 1: [100,105) = 5
    assert work.union_rows(starts, lens) == 25
    assert work.union_rows(np.zeros((1, 2), int), np.zeros((1, 2), int)) == 0


@pytest.mark.parametrize("n", [1, 7, 32])
def test_exact_and_banded_count_the_same_work_for_a_whole_bank(n):
    rows, dim, k = 1000, 8192, 4
    # the two blocks of a [decoys; targets] bank, every query's window
    # covering each whole block
    starts = np.array([[0] * 32, [500] * 32])
    lens = np.array([[500] * 32, [500] * 32])
    a = work.exact_scan(n, rows, dim, dim // 8, 4096, k)
    b = work.banded_scan(n, starts, lens, dim, dim // 8, 4096, k)
    assert a == b
    assert a.ops == 2 * dim * n * rows
    assert a.bytes == rows * dim // 8 + n * 4096 + n * k * 8


def test_banded_work_counts_real_queries_only():
    starts = np.array([[10, 10, 900]])
    lens = np.array([[5, 5, 50]])
    w = work.banded_scan(2, starts, lens, 64, 8, 0, 1)
    assert w.bytes == 5 * 8 + 2 * 8
    assert w.ops == 2 * 64 * 10


def test_roofline_uses_the_larger_bound():
    p = work.peaks("NVIDIA H100 80GB HBM3")
    w = work.Work(bytes=3.35e12, ops=1.979e15 / 2)
    assert work.roofline_pct(w, 2.0, p) == pytest.approx(50.0)
    assert work.roofline_pct(w, 0.0, p) is None
    assert work.peaks("cpu") is None


def test_open_loop_repeats_from_a_seed_and_meets_its_rate():
    mix = {"generator": "open_loop", "rate_per_s": 3000.0, "burst": [1, 32],
           "pool_spectra": 10}
    a = open_loop.schedule(mix, 60.0, 2**33 + 5)
    b = open_loop.schedule(mix, 60.0, 2**33 + 5)
    c = open_loop.schedule(mix, 60.0, 11)
    assert np.array_equal(a.due, b.due) and np.array_equal(a.size, b.size)
    assert not np.array_equal(a.due, c.due)
    assert np.all(np.diff(a.due) >= 0) and a.due[-1] < 60.0
    assert a.size.min() >= 1 and a.size.max() <= 32
    for s in (a, c):
        assert s.requests / 60.0 == pytest.approx(3000.0, rel=0.05)


def test_open_loop_seeds_draw_from_one_set_of_bursts():
    mix = {"generator": "open_loop", "rate_per_s": 500.0, "burst": [1, 32],
           "pool_spectra": 10}
    gaps, sizes = open_loop.master_bursts(mix, 20.0, 500.0)
    for seed in (1, 2, 2**40):
        s = open_loop.schedule(mix, 20.0, seed)
        left = collections.Counter(sizes.tolist())
        left.subtract(s.size.tolist())
        assert min(left.values()) >= 0
        got = np.diff(s.due, prepend=0.0)
        assert np.abs(got[:, None] - gaps[None, :]).min(axis=1).max() < 1e-9


@pytest.mark.parametrize("mix", [
    {"generator": "closed", "pool_spectra": 4},
    {"generator": "backlog", "pool_spectra": 4, "queued_batches": 0},
    {"generator": "open_loop", "pool_spectra": 4, "burst": [0, 3],
     "rate_per_s": 10.0},
    {"generator": "backlog", "pool_spectra": 0, "queued_batches": 2},
    {"generator": "backlog", "pool_spectra": 4, "queued_batches": 2,
     "append_fraction": 1.0},
])
def test_check_mix_refuses_what_it_cannot_run(mix):
    with pytest.raises(ValueError):
        loop.check_mix(mix)
