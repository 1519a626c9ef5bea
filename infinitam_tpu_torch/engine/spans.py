"""Phase spans of the frame steps: a device mark at each phase boundary,
inside the captured graph, and host spans, decoded after a run.

While spans are on (`enable(device)`, one device a process):

- `phase(name)`, which the frame steps call as each phase has been issued
  (hash: track, alloc, integrate, raycast; dense: track, integrate,
  raycast; the swap step also swap; MainEngine view; a batched step once
  for all its lanes, inside the torch.vmap body), launches `itpu_mark`
  (csrc/mark.cu) on the current stream. The one-thread kernel appends
  (phase id, frame sequence number, %globaltimer in ns) to a ring on the
  device. Under stream capture it becomes one kernel node of the graph:
  a graph captured from one stream is a chain, so the node runs when the
  phase before it has ended and before the next one starts. It has no
  launch counter (build.counter_of maps no mark). On the CPU a mark writes
  the host's clock (time.perf_counter_ns) in the timer's place.
- captured.run adds `begin` before the step's body and `end` after its
  copy-back and packing, and keeps a graph with marks apart from the one
  without (its key holds the ring's addresses, `ring()`). The stretch from
  the last named phase to `end` is `finish`: the diagnostics, the
  copy-back, the packing. A begin mark counts the device's frame sequence
  number on; a capture's warm-up frame runs with the marks paused, so on
  the card every frame the ring holds is a graph replay.
- Host spans (name, the host's step number, start ns, end ns) on
  time.perf_counter_ns: captured.run's `stage` (the frame's copies into the
  graph's static inputs) and `replay` (graph.replay()), `read`
  (Outputs.read), and the swap exchange's host half
  (swapping.SwapExchange.after_frame): `swap_wait` (the wait for a frame's
  copies to land), `swap_scatter` (the evicted blocks into the host
  store), `swap_gather` (the needed blocks gathered and packed into a
  slab) and `swap_upload` (the slab's copy to the device). Each phase
  call keeps its host issue time, except under
  capture; an op-by-op run reads its laps from them (cold_start.py).

While spans are off, `phase`, `step`, `start` and `host` only test a
global: no mark is launched, no node captured, nothing recorded.

`summary()` decodes the ring and the host lists after a run (one read of
the device). Everything stays in memory; nothing is written out.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

from infinitam_tpu_torch.ops.kernels import build

PHASES = ("begin", "view", "track", "alloc", "integrate", "swap", "raycast", "end")
PHASE_ID = {name: i for i, name in enumerate(PHASES)}
FINISH = "finish"  # the stretch from the last named phase of a frame to its end
CAPACITY = 1 << 16  # marks the ring holds, and host spans and issue times each list holds


class Recorder:
    """The ring of device marks and the host lists of one device.

    `head` (int64 [3]): marks appended (the ring's cursor), marks dropped
    because the ring was full, the device's frame sequence number; `rows`
    (int64 [capacity, 3]): phase id, sequence number, stamp in ns."""

    def __init__(self, device, capacity: int = CAPACITY):
        self.device = torch.device(device)
        self.capacity = capacity
        self.on_card = self.device.type == "cuda"
        self.head = torch.zeros(3, dtype=torch.int64, device=self.device)
        self.rows = torch.zeros((capacity, 3), dtype=torch.int64, device=self.device)
        self.host_spans: list = [None] * capacity  # (name, step, start ns, end ns)
        self.issues: list = [None] * capacity  # (phase name, step, ns)
        self.paused = False
        if self.on_card:
            self._mark(PHASE_ID["begin"], True)  # loads the kernel before any capture needs it
            torch.cuda.synchronize(self.device)
        else:
            # the CPU's marks write through numpy: no torch op, so none under vmap or a dispatch mode
            self._head_np, self._rows_np = self.head.numpy(), self.rows.numpy()
        self.clear()

    def clear(self) -> None:
        """Empty the ring and the host lists (on the card, on the current stream)."""
        self.head.zero_()
        self.n_host = self.n_issues = self.host_dropped = self.step_no = 0

    def _mark(self, pid: int, begin: bool) -> None:
        if self.on_card:
            build.check("itpu_mark", build.library().itpu_mark(
                self.head.data_ptr(), self.rows.data_ptr(), self.capacity, pid, int(begin),
                torch.cuda.current_stream(self.device).cuda_stream))
            return
        t = time.perf_counter_ns()
        h = self._head_np
        if begin:
            h[2] += 1
        i = h[0]
        h[0] += 1
        if i < self.capacity:
            self._rows_np[i] = (pid, h[2], t)
        else:
            h[1] += 1

    def phase(self, name: str) -> None:
        if self.paused:
            return
        pid = PHASE_ID[name]
        if not (self.on_card and torch.cuda.is_current_stream_capturing()):
            if self.n_issues < self.capacity:
                self.issues[self.n_issues] = (name, self.step_no, time.perf_counter_ns())
                self.n_issues += 1
            else:
                self.host_dropped += 1
        self._mark(pid, name == "begin")

    def host(self, name: str, t0: int) -> None:
        if self.n_host < self.capacity:
            self.host_spans[self.n_host] = (name, self.step_no, t0, time.perf_counter_ns())
            self.n_host += 1
        else:
            self.host_dropped += 1

    def summary(self) -> dict:
        """The run as recorded (the module docstring's quantities):

        - `marks`: every device mark in the order it ran, (phase, sequence
          number, stamp ns);
        - `frames`: each `begin` → `end` of the ring, in order: its sequence
          number, `begin_ns`, `end_ns` and `phases` {phase: ns from the mark
          before it}, `finish` last; the phases sum to end − begin;
        - `gaps_ns`: from each frame's end to the next frame's begin;
        - `loose`: marks outside any frame (MainEngine's view, op-by-op steps);
        - `host`: the host spans, `issues`: the phase calls' host times;
        - `dropped`: device marks the full ring dropped; `host_dropped`: host
          records the full lists dropped;
        - `clock`: "globaltimer" on the card, "perf_counter" on the CPU."""
        head = self.head.tolist()
        marks = [(PHASES[p], s, t) for p, s, t in self.rows[:min(head[0], self.capacity)].tolist()]
        frames, loose, cur = [], [], None
        for name, seq, t in marks:
            if name == "begin":
                if cur is not None:  # a frame whose end was dropped
                    loose.append(("begin", cur["seq"], cur["begin_ns"]))
                cur, last = {"seq": seq, "begin_ns": t, "end_ns": None, "phases": {}}, t
            elif cur is None:
                loose.append((name, seq, t))
            else:
                key = FINISH if name == "end" else name
                cur["phases"][key] = cur["phases"].get(key, 0) + t - last
                last = t
                if name == "end":
                    cur["end_ns"] = t
                    frames.append(cur)
                    cur = None
        return {"clock": "globaltimer" if self.on_card else "perf_counter", "marks": marks, "frames": frames,
                "gaps_ns": [b["begin_ns"] - a["end_ns"] for a, b in zip(frames, frames[1:])], "loose": loose,
                "host": self.host_spans[:self.n_host], "issues": self.issues[:self.n_issues],
                "dropped": head[1], "host_dropped": self.host_dropped}


# the recorder while spans are on; the last one stays readable after disable()
_on: Optional[Recorder] = None
_last: Optional[Recorder] = None


def enable(device, capacity: int = CAPACITY) -> Recorder:
    """Turn spans on for `device` with an empty ring of `capacity` marks (the
    last one's, emptied, where it has that device and capacity: a graph
    captured with marks writes to the ring it was captured with)."""
    global _on, _last
    device = torch.device(device)
    if _last is None or _last.device != device or _last.capacity != capacity:
        _last = Recorder(device, capacity)
    _on = _last
    _on.clear()
    return _on


def disable() -> None:
    """Turn spans off; summary() still reads what was recorded."""
    global _on
    _on = None


def ring() -> tuple:
    """The tensors the marks write while spans are on, () while off: a
    captured step's key holds their addresses, and its graph lives no
    longer than they do (engine/captured.py)."""
    return () if _on is None else (_on.head, _on.rows)


def reset() -> None:
    """Empty the ring and the host lists of the spans that are on."""
    if _on is not None:
        _on.clear()


def phase(name: str) -> None:
    """A phase of the current frame step has been issued (module docstring)."""
    if _on is not None:
        _on.phase(name)


def step() -> None:
    """A frame step begins: counts the host's step number on."""
    if _on is not None:
        _on.step_no += 1


def start() -> int:
    """The start of a host span: perf_counter_ns(), or 0 while spans are off."""
    return time.perf_counter_ns() if _on is not None else 0


def host(name: str, t0: int) -> None:
    """Record the host span `name` from `t0` (start()) to now."""
    if t0 and _on is not None:
        _on.host(name, t0)


@contextlib.contextmanager
def paused():
    """No mark or issue time inside the block (a capture's warm-up frame)."""
    rec = _on
    if rec is None:
        yield
        return
    rec.paused = True
    try:
        yield
    finally:
        rec.paused = False


def summary() -> dict:
    """Recorder.summary() of the spans that are on, or were on last."""
    if _last is None:
        raise RuntimeError("no spans were recorded: call spans.enable(device) before the run")
    return _last.summary()
