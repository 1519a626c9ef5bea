"""Mean device ms a lane-frame of the swap phase inside the captured frame,
integrate → swap: the needed list over the visible list, the eviction of
one rotating window, the swap counters; from the port's phase marks in the
span window (perfbench/span_window.py). None without a span window, for a
step without the phase, or where the ring dropped marks."""

from perfbench.span_window import phase_ms


def read(ctx):
    return phase_ms(getattr(ctx, "spans", None), "swap")
