"""Milliseconds a frame in which some operation ran on the device: the
union of the traced frames' device intervals, over the frames."""


def read(ctx):
    return ctx.trace.busy_s / ctx.trace.frames * 1e3
