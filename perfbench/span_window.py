"""The span window: per-phase device time inside the captured frame, read
from the port's phase marks (infinitam_tpu_torch/engine/spans.py).

`run(system, inputs, seconds, directory)` comes after a traced run's window
and profiled pass, once the window's capture check has been made:

(a) Spans go on. Passes run until the graph with marks has been captured
    and a pass captures nothing more. A capture puts the card back in its
    slow graph-node latency (perfbench/run.py NODE_US_FAST; PERF.md §6), so
    passes then run until it has left it again, as before the
    window. Then passes for `seconds`, unprofiled, as the window runs them.
    Their records join the check, so a mark that changed a pose or the map
    fails the run. The span window's frames/s beside the window's is what
    tracing costs when it is on.
(b) One profiled pass with spans on. Each `itpu_mark` op's trace start is
    paired with its own %globaltimer stamp, and each `replay` host span with
    the `cudaGraphLaunch` runtime event inside it: the offsets that put the
    device marks and the host spans on the trace's clock, and the quartile
    spread of each kind.
(c) `spans_line(result)`: the mean device ms a lane-frame of each phase,
    the top device ops of each phase in (b), and (a)'s gaps between replays,
    each put down to the program's host span open at its start where the two
    overlap by more than the offsets' spread, else to "caller".

The metric readers (perfbench/metrics/track_ms.py, alloc_ms.py,
integrate_ms.py, raycast_ms.py, replay_gap_share.py) read `ctx.spans`,
run()'s result, and return None where there is none or the ring dropped
marks. The port's spans are reached through the captured module that
perfbench/system.py imports: a program without them gives no span window.

perfbench/run.py does not call run() yet (PERF.md §7 names the edit). The
same measurement runs on its own:

    python3 -m perfbench.span_window --workload <cell> --seed <n> --seconds <s>

set-up, the card's settle and the window as perfbench/run.py makes them,
then (a) and (b), then the check over the window's and the span window's
records; the spans line on stderr and the result as JSON on stdout.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import tempfile
import time

QUANTITIES = ("track_ms", "alloc_ms", "integrate_ms", "raycast_ms", "replay_gap_share")
MAX_CAPTURE_PASSES = 3
TOP_OPS = 5


def program_spans():
    """The port's spans module, or None for a program that has none."""
    from perfbench import system

    return getattr(system.captured, "spans", None)


def profile_events(fn, directory: str) -> list:
    """The Chrome-trace events of `fn` run under the profiler, host and
    device activities (the runtime's cudaGraphLaunch events with the
    kernels); the exported file is deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=directory)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def run(system, inputs, seconds: float, directory: str):
    """(a) and (b) on `system` (a kind's System, perfbench/kinds/) fed
    `inputs` (its kind's `frames`) after a traced run's
    profiled pass: (the span window's records, as the window's, and the
    result for analyse()'s readers), or ([], None) for a program without
    spans or a system off the card. Raises run.CardNotSettled where the
    card keeps its slow latency after the capture."""
    import torch

    from perfbench import run as bench

    spans = program_spans()
    if spans is None or system.dev.type != "cuda":
        return [], None
    n = system.n_frames

    def sync():
        torch.cuda.synchronize(system.dev)

    node = bench.NodeLatency(system.dev)
    spans.enable(system.dev)
    try:
        for _ in range(MAX_CAPTURE_PASSES):
            graphs = system.graphs()
            system.run_pass(inputs, system.new_record(n))
            sync()
            if system.graphs() == graphs:
                break
        else:
            raise RuntimeError(f"a graph was still captured in the span window's pass {MAX_CAPTURE_PASSES}")
        t = time.perf_counter()
        reads = [node.read_us()]
        while reads[-1] >= bench.NODE_US_FAST and time.perf_counter() - t < bench.SETTLE_S:
            system.run_pass(inputs, system.new_record(n))
            sync()
            reads.append(node.read_us())
        settle = {"settle_s": time.perf_counter() - t, "settle_passes": len(reads) - 1, "node_us_reads": reads}
        if reads[-1] >= bench.NODE_US_FAST:
            raise bench.CardNotSettled(f"after the capture with marks the card's graph-node latency read "
                                       f"{reads[-1]:.3f} µs after {bench.SETTLE_S} s of passes")
        spans.reset()
        records = []
        t0 = time.perf_counter()
        while True:
            rec = system.new_record(n)
            system.run_pass(inputs, rec)
            records.append(rec)
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
        if system.graphs() != graphs:
            raise RuntimeError("a graph was captured inside the span window")
        window = spans.summary()
        spans.reset()
        rec = system.new_record(n)
        events = profile_events(lambda: system.run_pass(inputs, rec), directory)
        records.append(rec)
        traced = spans.summary()
    finally:
        spans.disable()
    frames = (len(records) - 1) * n * system.lanes
    return records, analyse(window, traced, events, system.lanes, frames / window_s) | settle


# ----- the arithmetic, on summaries (engine/spans.py) and trace events -----

def quartile_spread(values) -> float:
    """Third quartile − first (statistics.quantiles, n=4); 0 for fewer than
    two values."""
    if len(values) < 2:
        return 0.0
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return q3 - q1


def phase_means_ms(summary: dict, lanes: int) -> dict:
    """Each phase's mean device ms a lane-frame over the summary's frames,
    and `replay`, the mean begin → end."""
    frames = summary["frames"]
    if not frames:
        return {}
    out = {}
    for f in frames:
        for name, ns in f["phases"].items():
            out[name] = out.get(name, 0) + ns
    out["replay"] = sum(f["end_ns"] - f["begin_ns"] for f in frames)
    return {k: v / len(frames) / lanes * 1e-6 for k, v in out.items()}


def gap_share(summary: dict):
    """1 − the frames' begin → end spans ÷ the first begin → the last end:
    the device's time outside the frame graphs; in [0, 1], None without a
    frame."""
    frames = summary["frames"]
    if not frames:
        return None
    whole = frames[-1]["end_ns"] - frames[0]["begin_ns"]
    inside = sum(f["end_ns"] - f["begin_ns"] for f in frames)
    return 1.0 - inside / whole if whole > 0 else 0.0


def clock_offsets(traced: dict, events: list) -> dict:
    """The offsets (trace clock − the program's clock, ns) of each device mark
    (its trace start against its stamp) and each `replay` host span (the
    cudaGraphLaunch event against the span's start), paired in order;
    None where the counts differ. %globaltimer drifts against the
    trace's clock (by −28 to +43 ppm in the runs on the H100, PERF.md
    §6), so the device's offset is a line fitted through its pairs; the
    host's spans and the trace read one clock, so its offset is their
    median. Each kind: `offset_ns` at `base_ns` (its first stamp),
    `drift` (ns a ns), and `spread_ns`, the quartile spread of the pairs
    about it (on_trace), and `residual_max_ns`, the farthest pair."""
    ops = sorted((float(e["ts"]), e.get("name", "")) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "kernel" and "itpu_mark" in e.get("name", ""))
    launches = sorted(float(e["ts"]) for e in events
                      if e.get("ph") == "X" and e.get("name", "").startswith("cudaGraphLaunch"))
    replays = [h for h in traced["host"] if h[0] == "replay"]
    out = {"device_pairs": len(ops), "device_marks": len(traced["marks"]), "host_pairs": len(launches),
           "host_replays": len(replays)}
    for kind, pairs in (("device", [(ts, m[2]) for (ts, _n), m in zip(ops, traced["marks"])]
                         if len(ops) == len(traced["marks"]) else None),
                        ("host", [(ts, h[2]) for ts, h in zip(launches, replays)]
                         if len(launches) == len(replays) else None)):
        if not pairs:
            out[kind] = None
            continue
        base = pairs[0][1]  # the stamps are large integers: offsets taken against the first, exactly
        x = [t - base for _ts, t in pairs]
        rel = [ts * 1e3 - dx for (ts, _t), dx in zip(pairs, x)]
        drift, at_base = 0.0, statistics.median(rel)
        if kind == "device" and len(pairs) > 2 and max(x) > 0:
            mx, my = statistics.fmean(x), statistics.fmean(rel)
            drift = (sum((a - mx) * (b - my) for a, b in zip(x, rel))
                     / sum((a - mx) ** 2 for a in x))
            at_base = my - drift * mx
        residuals = [r - at_base - drift * dx for r, dx in zip(rel, x)]
        out[kind] = {"offset_ns": round(at_base) - base, "base_ns": base, "drift": drift,
                     "spread_ns": quartile_spread(residuals), "residual_max_ns": max(map(abs, residuals))}
    return out


def on_trace(offset: dict, t: int) -> float:
    """A time `t` of the program's clock (ns) on the trace's clock (ns),
    through one kind of clock_offsets()."""
    return t + offset["offset_ns"] + offset["drift"] * (t - offset["base_ns"])


def ops_by_phase(traced: dict, events: list, offsets: dict, k: int = TOP_OPS) -> dict:
    """The device ops of the profiled pass (marks left out) by the phase
    their start falls in, on the trace's clock: {phase: [[op, seconds a
    frame], ...]}, the k largest; "outside" before a begin or after an end."""
    from perfbench.trace import from_events

    if offsets.get("device") is None or not traced["frames"]:
        return {}
    bounds = [on_trace(offsets["device"], t) * 1e-3 for _n, _s, t in traced["marks"]]  # µs, the trace's unit
    names = [n for n, _s, _t in traced["marks"]]
    by: dict = {}
    for op, s, d in from_events(events).ops:
        if "itpu_mark" in op:
            continue
        i = bisect.bisect_right(bounds, s)
        phase = "outside" if i >= len(names) or names[i] == "begin" else ("finish" if names[i] == "end" else names[i])
        ops = by.setdefault(phase, {})
        ops[op] = ops.get(op, 0.0) + d * 1e-6 / len(traced["frames"])
    return {p: sorted(([n, s] for n, s in ops.items()), key=lambda x: -x[1])[:k] for p, ops in by.items()}


def attribute_gaps(window: dict, offsets: dict) -> dict:
    """Each gap between consecutive frames of the span window put down to the
    host span open at the gap's start (the device's clock moved onto the
    host's through the two offsets) where the two overlap by more than the
    two offsets' spreads together, else to "caller": {label: {"n", "ms"}}."""
    if offsets.get("device") is None or offsets.get("host") is None:
        return {}
    dev, host = offsets["device"], offsets["host"]
    slack = dev["spread_ns"] + host["spread_ns"]
    spans = sorted(window["host"], key=lambda h: h[2])
    starts = [h[2] for h in spans]
    out: dict = {}
    frames = window["frames"]
    for a, b in zip(frames, frames[1:]):
        gs, ge = (on_trace(dev, t) - host["offset_ns"] for t in (a["end_ns"], b["begin_ns"]))

        label = "caller"
        i = bisect.bisect_right(starts, gs) - 1
        if i >= 0:
            name, _step, h0, h1 = spans[i]
            if h1 >= gs and min(h1, ge) - max(h0, gs) > slack:
                label = name
        slot = out.setdefault(label, {"n": 0, "ms": 0.0})
        slot["n"] += 1
        slot["ms"] += (b["begin_ns"] - a["end_ns"]) * 1e-6
    return out


def analyse(window: dict, traced: dict, events: list, lanes: int, fps: float) -> dict:
    """The span window's result: what the readers and the spans line read."""
    offsets = clock_offsets(traced, events)
    return {"fps": fps, "lanes": lanes, "frames": len(window["frames"]),
            "dropped": window["dropped"] + traced["dropped"],
            "host_dropped": window["host_dropped"] + traced["host_dropped"],
            "phases_ms": phase_means_ms(window, lanes), "gap_share": gap_share(window), "offsets": offsets,
            "top_ops": ops_by_phase(traced, events, offsets), "gaps": attribute_gaps(window, offsets)}


def phase_ms(spans, name: str):
    """A reader's value: the mean device ms a lane-frame of phase `name` in
    the span window, None without one, without the phase, or where the
    ring dropped marks."""
    if spans is None or spans["dropped"]:
        return None
    return spans["phases_ms"].get(name)


def spans_line(result: dict, window_fps: float) -> dict:
    """The `spans` stderr line of a cell."""
    return {"phases_ms_a_lane_frame": result["phases_ms"], "gap_share": result["gap_share"],
            "fps_window": window_fps, "fps_span_window": result["fps"],
            "span_cost": 1.0 - result["fps"] / window_fps if window_fps else None,
            "settle": {k: result.get(k) for k in ("settle_s", "settle_passes", "node_us_reads")},
            "dropped": result["dropped"], "clock_offsets": result["offsets"], "top_ops_by_phase": result["top_ops"],
            "gaps_by_host_span": result["gaps"]}



# ----- on its own -----------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.span_window", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from perfbench import run as bench

    bench.point_caches()
    from perfbench import registry

    b = registry.load_benchmark()
    cell = registry.cell(b, args.workload)
    cfg = registry.config(b, cell["config"])
    traffic = registry.traffic(cell["traffic"])

    import torch

    if not torch.cuda.is_available():
        bench.log("no result: the span window runs on a CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from perfbench import compare

    dev = torch.device("cuda:0")
    n, lanes = traffic["frames"], traffic["lanes"]
    kind = registry.kind(cfg["kind"])
    gt, inputs = kind.frames(traffic, args.seed, dev)
    system = kind.System(cfg, traffic, dev)
    for _ in range(1 + bench.WARM_PASSES):
        system.run_pass(inputs, system.new_record(n))
    torch.cuda.synchronize(dev)
    node, t = bench.NodeLatency(dev), time.perf_counter()
    while node.read_us() >= bench.NODE_US_FAST and time.perf_counter() - t < bench.SETTLE_S:
        system.run_pass(inputs, system.new_record(n))
        torch.cuda.synchronize(dev)
    bench.log(f"settle_s {time.perf_counter() - t}")

    records, graphs = [], system.graphs()
    t0 = time.perf_counter()
    while True:
        rec = system.new_record(n)
        system.run_pass(inputs, rec)
        records.append(rec)
        if time.perf_counter() - t0 >= args.seconds:
            break
    torch.cuda.synchronize(dev)
    window_fps = len(records) * n * lanes / (time.perf_counter() - t0)
    if system.graphs() != graphs:
        raise RuntimeError("a graph was captured inside the window")
    span_records, result = run(system, inputs, args.seconds, os.environ.get("TMPDIR", str(bench.ROOT)))
    if result is None:
        bench.log("no result: the program has no spans")
        return 3
    records += span_records
    outputs = system.outputs()
    poses = torch.stack([r["poses"] for r in records]).cpu().numpy()
    counters = torch.stack([r["counters"] for r in records]).cpu().numpy() if kind.COUNTERS else None
    system.close()
    del system
    nums, failed = kind.judge(cfg, inputs, gt, poses, outputs, counters, tuple(traffic["image"]),
                              traffic["intrinsics"], dev)
    ctx = bench.Context(lanes=lanes, spans=result)
    metrics = {q: registry.reader(q)(ctx) for q in QUANTITIES}
    bench.log("spans " + json.dumps(spans_line(result, window_fps)))
    print(json.dumps({"correct": compare.verdict(nums, compare.limits_of(cfg)), "failed": failed,
                      "workload": args.workload, "device": torch.cuda.get_device_name(dev), "metrics": metrics,
                      "fps_window": window_fps, "fps_span_window": result["fps"],
                      "checks": {k: {"value": v, "limit": compare.limits_of(cfg)[k]} for k, v in nums.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
