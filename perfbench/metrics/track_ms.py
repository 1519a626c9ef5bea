"""Mean device ms a lane-frame of the track phase inside the captured frame,
begin → track: the tracker (K1 and its torch ops), the divergence gate; from
the port's phase marks in the span window (perfbench/span_window.py). None
without a span window, or where the ring dropped marks."""

from perfbench.span_window import phase_ms


def read(ctx):
    return phase_ms(getattr(ctx, "spans", None), "track")
