"""The device trace's arithmetic: busy time is the union of the operations'
intervals, so the idle share stays within [0, 1] however they overlap."""

from __future__ import annotations

import pytest

from perfbench.trace import DeviceTrace, from_events


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_overlapping_kernels_count_once():
    t = from_events([ev("a", 0, 10), ev("b", 5, 10), ev("c", 2, 3), ev("d", 30, 10), ev("host", 0, 100, "cpu_op")])
    busy, gaps = t.busy_and_gaps()
    assert busy == pytest.approx(25e-6)
    assert t.span_s == pytest.approx(40e-6)
    assert t.idle_share() == pytest.approx(1 - 25 / 40)
    assert gaps == [(pytest.approx(15e-6), "b")]
    assert t.top_gaps() == [["after b", pytest.approx(15e-6)]]


@pytest.mark.parametrize("events", [
    [ev("a", 0, 100), ev("b", 1, 1), ev("c", 2, 1), ev("d", 50, 60)],  # nested and spilling past the end
    [ev("a", 0, 10, "gpu_memcpy"), ev("b", 0, 10, "gpu_memset"), ev("c", 0, 10)],  # all at once
    [ev(str(i), 7 * i, 13) for i in range(50)],  # a chain of overlaps
    [ev(str(i), 20 * i, 1) for i in range(50)],  # mostly idle
])
def test_idle_share_within_zero_and_one(events):
    t = from_events(events)
    busy, _gaps = t.busy_and_gaps()
    assert 0.0 < busy <= t.span_s + 1e-15
    assert 0.0 <= t.idle_share() <= 1.0


def test_sums_by_name():
    t = from_events([ev("itpu_icp_kernel<false>", 0, 4), ev("itpu_icp_kernel<false>", 10, 6), ev("other", 20, 1)])
    assert t.seconds_of("itpu_icp_kernel") == pytest.approx(10e-6)
    assert t.top_ops(1) == [["itpu_icp_kernel<false>", pytest.approx(10e-6)]]
    assert DeviceTrace([]).idle_share() == 0.0
