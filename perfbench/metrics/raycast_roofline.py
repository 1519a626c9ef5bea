"""K3 / K3d (ops/kernels/raycast.py): the least time of the raycast work ÷
the itpu_raycast kernels' device time, in %."""


def read(ctx):
    return ctx.roofline("raycast")
