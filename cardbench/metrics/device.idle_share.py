"""Percent of the traced frames' wall time in which no operation ran on
the device (1 - busy / wall, both from the same traced stretch). A traced
reading: the profiler slows the host's pace, so this counts its overhead
too; ``device.idle_share.unprofiled`` is the window's own."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
