"""Device ms a frame of the traced pass's copies between the device and
pinned host memory: the swap exchange's downloads (the needed list and the
eviction pack) and its data-slab uploads (the profiler's `Memcpy DtoH
(Device -> Pinned)` and `Memcpy HtoD (Pinned -> Device)`). None where the
pass made no such copy."""

NAMES = ("Memcpy DtoH (Device -> Pinned)", "Memcpy HtoD (Pinned -> Device)")


def read(ctx):
    if ctx.trace is None:
        return None
    s = sum(d for n, _s, d in ctx.trace.ops if n in NAMES)
    return s * 1e-3 / ctx.traced_steps if s > 0 else None
