"""1 − the frame graphs' begin → end spans ÷ the span window's first begin
→ last end: the device's time outside the frame graphs (stage-in copies,
the pass's map refill, the caller's copies, idle); in [0, 1] by
construction (perfbench/span_window.py). None without a span window, or
where the ring dropped marks."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    return None if spans is None or spans["dropped"] else spans["gap_share"]
