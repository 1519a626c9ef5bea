"""K2 (ops/kernels/integrate.py): the least time of the fusion work ÷
the itpu_integrate kernels' device time, in %."""


def read(ctx):
    return ctx.roofline("integrate")
