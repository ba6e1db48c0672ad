"""Percent of the unprofiled window's wall time in which no operation ran
on the device: 1 - (device busy seconds a frame, from the traced stretch)
x (the window's frames a second). The profiler slows the host's pace but
not the device's work a frame, so this is the program's own idle share,
where ``device.idle_share`` also reads the profiler's overhead."""


def read(ctx):
    busy = ctx.trace.busy_s / ctx.trace.frames
    return 100.0 * (1.0 - busy * ctx.window.frames / ctx.window.elapsed)
