"""The window's arithmetic and the traffic generator's draws."""

import itertools

import pytest

from portbench import traffic, window


class Clock:
    """A clock that each call of the loop advances by its own duration."""

    def __init__(self, durations):
        self.t = 100.0
        self.durations = iter(durations)

    def __call__(self):
        return self.t

    def call(self, item):
        self.t += next(self.durations)
        return item


def test_window_closes_after_the_first_call_past_its_length():
    clk = Clock([0.4, 0.4, 0.4, 0.4, 0.4])
    win = window.closed_loop(clk.call, itertools.count(), 1.0, clock=clk)
    # calls end at 0.4, 0.8, 1.2: the third is the first past 1.0
    assert win.calls == 3 and win.outputs == [0, 1, 2]
    assert win.seconds == pytest.approx(1.2)


def test_rate_covers_all_work_and_all_time_of_the_window():
    clk = Clock([0.1, 0.5, 0.6])
    win = window.closed_loop(clk.call, itertools.count(), 1.0, clock=clk)
    assert window.rate(128 * win.calls, win) == pytest.approx(384 / 1.2)


def test_whole_proofs_only():
    clk = Clock([6.0, 6.2, 5.9, 6.1, 6.0])
    win = window.closed_loop(clk.call, itertools.count(), 20.0, clock=clk)
    assert win.calls == 4
    assert window.per_call(win) == pytest.approx(24.2 / 4)


@pytest.mark.parametrize("n,q,want", [(10, 90, 9), (100, 90, 90), (101, 90, 91),
                                      (1, 90, 1), (20, 50, 10)])
def test_percentile_by_nearest_rank_with_its_count(n, q, want):
    vals = list(range(n, 0, -1))
    assert window.percentile(vals, q) == (want, n)


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        window.percentile([], 90)


def test_lane_draws_are_distinct_proofs_and_follow_the_seed():
    a = traffic.take(traffic.lane_draws(7, "window", 160, 128), 5)
    b = traffic.take(traffic.lane_draws(7, "window", 160, 128), 5)
    c = traffic.take(traffic.lane_draws(8, "window", 160, 128), 5)
    assert a == b and a != c
    for lanes in a + c:
        assert len(set(lanes)) == 128 and set(lanes) <= set(range(160))
    assert set(a[0]) != set(a[1])
    warm = traffic.take(traffic.lane_draws(7, "warm", 160, 128), 1)
    assert warm[0] != a[0]


def test_lane_draws_refuse_a_pool_smaller_than_the_batch():
    with pytest.raises(ValueError, match="distinct"):
        next(traffic.lane_draws(7, "window", 4, 8))


def test_circuit_draws_in_range_for_large_seeds():
    seed = 2**31 + 12345
    draws = traffic.take(traffic.circuit_draws(seed, "window"), 50)
    assert draws == traffic.take(traffic.circuit_draws(seed, "window"), 50)
    for w, b in draws:
        assert traffic.SEED_LO <= w < traffic.SEED_HI
        assert traffic.SEED_LO <= b < traffic.SEED_HI


@pytest.mark.parametrize("n,k", [(5, 12), (12, 12), (100, 12), (1000, 16)])
def test_sample_holds_the_last_call(n, k):
    s = traffic.sample(99, n, k)
    assert s == sorted(set(s)) and len(s) == min(n, k) and s[-1] == n - 1
    assert s == traffic.sample(99, n, k)
