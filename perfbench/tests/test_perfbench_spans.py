"""The span window's arithmetic (perfbench/span_window.py) and its readers on
hand-built summaries and trace events; a `--trace 0` run turns no spans on
and records none; a program without spans gives no span window."""

from __future__ import annotations

import types

import pytest

from conftest import tiny_config, tiny_traffic
from perfbench import registry, run, span_window

MS = 1_000_000  # ns


def frame(seq, begin, phases):
    """A decoded frame (engine/spans.py summary) from its begin and its
    phases' ns in order; its marks too."""
    t, marks = begin, [("begin", seq, begin)]
    for name, ns in phases:
        t += ns
        marks.append(("end" if name == "finish" else name, seq, t))
    return {"seq": seq, "begin_ns": begin, "end_ns": t, "phases": dict(phases)}, marks


def summary(frames_phases, gap, host=()):
    frames, marks, t = [], [], 10 * MS
    for i, phases in enumerate(frames_phases):
        f, m = frame(i + 1, t, phases)
        frames.append(f)
        marks += m
        t = f["end_ns"] + gap
    return {"clock": "globaltimer", "marks": marks, "frames": frames,
            "gaps_ns": [b["begin_ns"] - a["end_ns"] for a, b in zip(frames, frames[1:])], "loose": [],
            "host": list(host), "issues": [], "dropped": 0, "host_dropped": 0}


HASH = [("track", 4 * MS), ("alloc", 3 * MS), ("integrate", 1 * MS), ("raycast", 2 * MS), ("finish", MS // 2)]
DENSE = [("track", 4 * MS), ("integrate", 20 * MS), ("raycast", MS // 2), ("finish", MS // 10)]
DEV_OFF, HOST_OFF = 5_000_000_000, 7_000_000_000  # trace clock − program clock, ns


def events_for(s, replays=(), drift=0.0, host_jitter=0):
    """Trace events of a profiled pass: a kernel op for each mark at its
    stamp on the trace's clock (DEV_OFF, drifting by `drift` ns a ns from
    the first mark), a 'work' op inside each phase, and a cudaGraphLaunch
    2 µs after each replay span's start (`host_jitter` ns later for every
    other one)."""
    ev, base = [], s["marks"][0][2] if s["marks"] else 0
    for name, _seq, t in s["marks"]:
        ts = (t + DEV_OFF + drift * (t - base)) / 1e3
        ev.append({"ph": "X", "cat": "kernel", "name": "itpu_mark_kernel(unsigned long long*, long long*, int, int, "
                   "int)", "ts": ts, "dur": 1.0})
        if name != "begin":
            ev.append({"ph": "X", "cat": "kernel", "name": f"work_{name}", "ts": ts - 50.0, "dur": 10.0})
    for k, (_name, _step, t0, _t1) in enumerate(replays):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
                   "ts": (t0 + HOST_OFF + 2000 + (host_jitter if k % 2 else 0)) / 1e3, "dur": 5.0})
    return ev


def ctx_of(result, lanes=1):
    return run.Context(lanes=lanes, spans=result)


@pytest.mark.parametrize("lanes", [1, 4])
def test_readers_of_a_hash_summary(lanes):
    s = summary([HASH] * 5, gap=MS // 4)
    r = span_window.analyse(s, s, [], lanes, 80.0)
    ctx = ctx_of(r, lanes)
    want = {"track_ms": 4, "alloc_ms": 3, "integrate_ms": 1, "raycast_ms": 2}
    for q, ms in want.items():
        assert registry.reader(f"{q}.hash")(ctx) == pytest.approx(ms / lanes)
    # five frames of 10.5 ms and four gaps of 0.25 ms
    assert registry.reader("replay_gap_share.hash")(ctx) == pytest.approx(1 - 52.5 / 53.5)
    assert r["phases_ms"]["replay"] == pytest.approx(10.5 / lanes)
    assert sum(v for k, v in r["phases_ms"].items() if k != "replay") == pytest.approx(r["phases_ms"]["replay"])


def test_readers_of_a_dense_summary_have_no_alloc():
    s = summary([DENSE] * 3, gap=0)
    ctx = ctx_of(span_window.analyse(s, s, [], 1, 40.0))
    assert registry.reader("integrate_ms.dense")(ctx) == pytest.approx(20)
    assert registry.reader("alloc_ms.dense")(ctx) is None
    assert registry.reader("replay_gap_share.dense")(ctx) == 0.0


def test_readers_give_none_without_a_span_window_or_with_dropped_marks():
    for q in span_window.QUANTITIES:
        assert registry.reader(q)(run.Context(lanes=1)) is None
    s = summary([HASH] * 2, gap=MS)
    s["dropped"] = 3
    ctx = ctx_of(span_window.analyse(s, s, [], 1, 1.0))
    assert all(registry.reader(q)(ctx) is None for q in span_window.QUANTITIES)


def test_offsets_ops_by_phase_and_gaps_put_down_to_host_spans():
    frames = [HASH] * 4
    s = summary(frames, gap=MS)
    drift = 9e-6  # %globaltimer against the trace's clock, as measured

    def to_host(t):  # a device time on the host's clock, through the offsets analyse() fits below
        return t + DEV_OFF + drift * (t - s["marks"][0][2]) - HOST_OFF - 2000

    f = s["frames"]
    e = [to_host(x["end_ns"]) for x in f]
    s["host"] = [("replay", 1, e[0] - MS // 2, e[0] + 3 * MS // 4),  # over gap 1
                 ("stage", 2, e[1] + MS // 2, e[1] + MS),  # opens mid gap 2
                 ("read", 3, e[2] - 100, e[2] + 300)]  # overlaps gap 3 by 300 ns
    replays = [("replay", k, 1000 * k, 1000 * k + 5000) for k in range(1, 4)]
    traced = dict(s, host=replays)
    r = span_window.analyse(s, traced, events_for(traced, replays, drift=drift, host_jitter=800), 1, 1.0)
    off = r["offsets"]
    assert off["device_pairs"] == off["device_marks"] == 24 and off["host_pairs"] == off["host_replays"] == 3
    assert off["device"]["offset_ns"] == pytest.approx(DEV_OFF, abs=2)
    assert off["device"]["drift"] == pytest.approx(drift) and off["device"]["spread_ns"] < 1.0
    assert off["host"]["offset_ns"] == HOST_OFF + 2000 and off["host"]["drift"] == 0.0
    assert off["host"]["spread_ns"] == 800
    # each 'work' op starts 50 µs before the mark that closes its phase
    for name in ("track", "alloc", "integrate", "raycast", "finish"):
        assert r["top_ops"][name] == [[f"work_{'end' if name == 'finish' else name}", pytest.approx(10e-6)]]
    # gap 1 lies under the replay span; gap 2 starts before the stage span
    # opens; gap 3's overlap with read (300 ns) is under the spreads (800 ns)
    assert r["gaps"]["replay"] == {"n": 1, "ms": pytest.approx(1.0)}
    assert r["gaps"]["caller"] == {"n": 2, "ms": pytest.approx(2.0)}


def test_offsets_need_one_pair_a_mark():
    s = summary([HASH] * 2, gap=0)
    ev = events_for(s)[:-2]
    off = span_window.clock_offsets(s, ev)
    assert off["device"] is None and off["host"] is None
    assert span_window.ops_by_phase(s, ev, off) == {} and span_window.attribute_gaps(s, off) == {}


def test_spans_line_carries_the_cost():
    s = summary([HASH] * 2, gap=0)
    line = span_window.spans_line(span_window.analyse(s, s, [], 1, 99.0), 100.0)
    assert line["span_cost"] == pytest.approx(0.01) and line["fps_span_window"] == 99.0
    assert line["gaps_by_host_span"] == {} and line["dropped"] == 0


def test_trace_zero_run_turns_no_spans_on():
    from infinitam_tpu_torch.engine import spans

    before = spans._last
    bench = registry.load_benchmark()
    e2e = bench["end_to_end"]
    readers = {m["name"]: registry.reader(m["name"]) for m in e2e}
    r = run.run_cell({"name": "tiny", "chips": 1}, tiny_config("hash"), tiny_traffic(1, frames=4), 2**33 + 9, 0.1,
                     False, "cpu", e2e, [], readers)
    assert r["correct"], r["checks"]
    assert spans.ring() == () and spans._last is before


def test_program_without_spans_gives_no_span_window(monkeypatch):
    from perfbench import system

    assert span_window.program_spans() is not None
    monkeypatch.setattr(system, "captured", types.SimpleNamespace())
    assert span_window.program_spans() is None
    assert span_window.run(types.SimpleNamespace(dev=None), None, 1.0, ".") == ([], None)
