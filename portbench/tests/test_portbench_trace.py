"""Busy time, idle gaps and kernel time from device intervals."""

import pytest

from portbench import trace as tr


def test_union_clips_and_merges():
    assert tr.union([(5, 9), (0, 3), (2, 4), (8, 12), (20, 30)], 1, 25) == [
        [1, 4], [5, 12], [20, 25]]


def test_gaps_around_busy():
    busy = [[1, 4], [5, 12]]
    assert tr.gaps(busy, 0, 15) == [(0, 1), (4, 5), (12, 15)]


def test_summary_names_idle_by_innermost_span():
    ms = 1_000_000
    events = [(0, 2 * ms, "h2t::poseidon_chain_kernel(int*)"),
              (5 * ms, 6 * ms, "h2t::accumulate_kernel<8>(int*)"),
              (6 * ms, 7 * ms, "Memcpy DtoH (Device -> Pageable)")]
    spans = [("verify", 0, 10 * ms), ("entry_points", 2 * ms, 5 * ms),
             ("pairing", 7 * ms, 10 * ms)]
    s = tr.summarize(events, spans, 0, 10 * ms)
    assert s.window_s == pytest.approx(0.010) and s.busy_s == pytest.approx(0.004)
    assert s.idle_pct == pytest.approx(60.0)
    assert s.idle_by_span == pytest.approx({"entry_points": 0.003,
                                            "pairing": 0.003})
    assert s.kernel("poseidon_chain_kernel") == (1, pytest.approx(0.002))
    b = tr.breakdown(s)
    assert b["device_ops"][0] == ["h2t::poseidon_chain_kernel", pytest.approx(0.002)]
    assert len(b["device_ops"]) == 3 and len(b["idle_gaps"]) == 2


def test_idle_outside_every_span():
    s = tr.summarize([(4, 6, "k")], [], 0, 10)
    assert s.idle_by_span == {"between calls": pytest.approx(8e-9)}
