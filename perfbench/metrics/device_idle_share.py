"""1 − the union of the device operations' intervals ÷ the device timeline
of the traced pass."""


def read(ctx):
    return ctx.trace.idle_share() if ctx.trace.ops else None
