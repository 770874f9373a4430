"""The rate, percentile, spread and window-end arithmetic, with no device."""
from __future__ import annotations

import statistics
from types import SimpleNamespace

import pytest

from perfbench.harness import jobs
from perfbench.harness.stats import Reservoir, nearest_rank, spread


@pytest.mark.parametrize("n", [10, 100, 101, 250])
def test_nearest_rank_p90_leaves_a_tenth_beyond(n):
    vals = list(range(1, n + 1))
    p90 = nearest_rank(vals, 0.9)
    assert sum(v > p90 for v in vals) == n - -(-9 * n // 10)
    assert sum(v <= p90 for v in vals) >= 0.9 * n


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert spread(vals) == pytest.approx((q3 - q1) / 12.5)


def test_reservoir_is_drawn_from_the_seed_and_uniform():
    def sample(seed, n=50, k=3):
        r = Reservoir(k, seed)
        for i in range(n):
            r.offer(i)
        return sorted(r.items)

    assert sample(5) == sample(5)
    assert sample(5) != sample(6) or sample(5) != sample(7)
    counts = [0] * 20
    for seed in range(2000):
        for i in sample(seed, n=20, k=2):
            counts[i] += 1
    assert min(counts) > 0.7 * 200 and max(counts) < 1.3 * 200


class _FakeSetup:
    """A job of a fixed duration on a fake clock."""

    def __init__(self, clock, job_s):
        self.clock, self.job_s, self.pool_size = clock, job_s, 3

    def job(self, i):
        self.clock[0] += self.job_s
        info = SimpleNamespace(n_iter=100 + i, converged_at=90)
        return i % 3, info, None, dict.fromkeys(jobs.SPANS, 0.0)

    def release(self, x):
        pass


def test_the_window_ends_at_the_first_job_done_after_seconds(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(jobs.time, "perf_counter", lambda: clock[0])
    w = jobs.run_window(_FakeSetup(clock, 0.3), seconds=1.0, check_jobs=2, seed=1)
    # jobs end at 0.3, 0.6, 0.9, 1.2: the fourth is the first past 1 s
    assert len(w.jobs) == 4 and w.window_s == pytest.approx(1.2)
    assert len(w.sampled) == 2
    from perfbench.harness.main import Context
    from perfbench.metrics import images_per_s, iters_per_image, solve_ms_p90

    ctx = Context(cell=None, setup_s=1.0, window=w, trace=None, peaks=None, counts=None)
    assert images_per_s.read(ctx) == pytest.approx(4 / 1.2)
    assert solve_ms_p90.read(ctx) == pytest.approx(300.0)
    assert iters_per_image.read(ctx) == pytest.approx(101.5)


def test_a_failed_job_counts_as_attempted_not_done(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(jobs.time, "perf_counter", lambda: clock[0])
    setup = _FakeSetup(clock, 0.25)
    good = setup.job

    def job(i):
        if i == 1:
            clock[0] += 0.25
            raise RuntimeError("a planted failure")
        return good(i)

    setup.job = job
    w = jobs.run_window(setup, seconds=0.9, check_jobs=1, seed=1)
    assert len(w.jobs) == 4 and sum(j.failed for j in w.jobs) == 1
    from perfbench.harness.main import Context
    from perfbench.metrics import images_per_s

    ctx = Context(cell=None, setup_s=1.0, window=w, trace=None, peaks=None, counts=None)
    assert images_per_s.read(ctx) == pytest.approx(3 / 1.0)
