"""Frames completed in the window ÷ the window (every lane's frames)."""


def read(ctx):
    return ctx.frames / ctx.window_s
