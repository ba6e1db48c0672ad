"""Median host milliseconds of the served demo's device stage
(``ReconEngine.frame`` and the packed display, with no stream sync: the
host's dispatch of the frame, and its waits) over its last 64 frames at
the window's close (``runtime.StageStats.median_ms``). Nothing to read in
a cell that serves no demo."""


def read(ctx):
    stages = getattr(ctx.window, "stages", None)
    return None if stages is None else stages.get("device_frame")
