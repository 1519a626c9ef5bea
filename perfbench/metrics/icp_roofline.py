"""K1 (ops/kernels/icp.py): the least time of the ICP work the frames need ÷
the itpu_icp kernels' device time, in %."""


def read(ctx):
    return ctx.roofline("icp")
