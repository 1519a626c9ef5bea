"""Mean device ms a lane-frame of the alloc phase inside the captured frame,
track → alloc: the hash allocator (its torch ops and scatters); from the
port's phase marks in the span window (perfbench/span_window.py). None
without a span window, or where the ring dropped marks."""

from perfbench.span_window import phase_ms


def read(ctx):
    return phase_ms(getattr(ctx, "spans", None), "alloc")
