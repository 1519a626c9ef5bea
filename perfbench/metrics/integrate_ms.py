"""Mean device ms a lane-frame of the integrate phase inside the captured
frame, alloc → integrate (dense: track → integrate): the fusion (K2; dense:
the whole-array torch ops); from the port's phase marks in the span window
(perfbench/span_window.py). None without a span window, or where the ring
dropped marks."""

from perfbench.span_window import phase_ms


def read(ctx):
    return phase_ms(getattr(ctx, "spans", None), "integrate")
