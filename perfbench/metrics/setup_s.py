"""Seconds from the process's start to the end of set-up (the card's settle
before the window is not set-up: perfbench/run.py)."""


def read(ctx):
    return ctx.setup_s
