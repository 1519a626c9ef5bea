"""The device trace of a traced pass and the numbers read from it.

`profile(fn)` runs `fn` under torch.profiler with CUDA activities, exports
the Chrome trace to a temporary file and keeps its device operations
(kernels, copies, memsets) as (name, start µs, duration µs). The trace's
device timeline is the span from the first operation's start to the last
one's end; the device is busy over the union of the operations' intervals,
so overlapping kernels count once and busy ≤ span by construction.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, List, NamedTuple, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace(NamedTuple):
    ops: List[Tuple[str, float, float]]  # (name, start µs, duration µs), by start

    @property
    def span_s(self) -> float:
        if not self.ops:
            return 0.0
        return (max(s + d for _n, s, d in self.ops) - self.ops[0][1]) * 1e-6

    def busy_and_gaps(self):
        """(busy seconds: the union of the operations' intervals, the idle
        gaps between them as (seconds, the operation before the gap))."""
        busy = 0.0
        gaps = []
        cur_s = cur_e = None
        last_name = ""
        for name, s, d in self.ops:
            e = s + d
            if cur_e is None:
                cur_s, cur_e, last_name = s, e, name
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append(((s - cur_e) * 1e-6, last_name))
                cur_s, cur_e, last_name = s, e, name
            else:
                if e >= cur_e:
                    last_name = name
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy * 1e-6, gaps

    def idle_share(self) -> float:
        busy, _gaps = self.busy_and_gaps()
        return 1.0 - busy / self.span_s if self.span_s > 0 else 0.0

    def seconds_of(self, pattern: str) -> float:
        """Summed device seconds of the operations whose name holds `pattern`."""
        return sum(d for n, _s, d in self.ops if pattern in n) * 1e-6

    def top_ops(self, k: int = 10):
        by = {}
        for n, _s, d in self.ops:
            by[n] = by.get(n, 0.0) + d * 1e-6
        return sorted(([n, t] for n, t in by.items()), key=lambda x: -x[1])[:k]

    def top_gaps(self, k: int = 10):
        _busy, gaps = self.busy_and_gaps()
        return [["after " + n, g] for g, n in sorted(gaps, key=lambda x: -x[0])[:k]]


def profile(fn: Callable[[], None], directory: str) -> DeviceTrace:
    """Run `fn` under the profiler (device activities only) and read its
    device operations back from the exported trace, which is deleted."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=directory)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return from_events(events)


def from_events(events) -> DeviceTrace:
    """The device operations of Chrome-trace events."""
    ops = [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0))) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    ops.sort(key=lambda o: o[1])
    return DeviceTrace(ops)
