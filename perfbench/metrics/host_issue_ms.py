"""Host milliseconds of a step's call (input copies, graph replay, output
copy-out), averaged over the window's steps."""


def read(ctx):
    return ctx.issue_ms
