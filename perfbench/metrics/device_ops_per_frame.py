"""Device operations (kernels, copies, memsets) of the traced pass per
lane-frame."""


def read(ctx):
    return len(ctx.trace.ops) / ctx.traced_frames if ctx.trace.ops else None
