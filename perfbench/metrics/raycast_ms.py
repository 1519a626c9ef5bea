"""Mean device ms a lane-frame of the raycast phase inside the captured frame,
integrate → raycast: the raycast (K3 / K3d) and the next frame's maps; from
the port's phase marks in the span window (perfbench/span_window.py). None
without a span window, or where the ring dropped marks."""

from perfbench.span_window import phase_ms


def read(ctx):
    return phase_ms(getattr(ctx, "spans", None), "raycast")
