"""Hand-kernel launches per lane-frame, from the captured graph's own kernel
nodes."""


def read(ctx):
    return ctx.launches_per_replay / ctx.lanes
