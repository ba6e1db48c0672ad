"""Median host milliseconds of the served demo's composite stage (the
floor render, the composite, the frame's one fetch, which waits for the
device, the JPEG and its publication) over its last 64 frames at the
window's close (``runtime.StageStats.median_ms``). Nothing to read in a
cell that serves no demo."""


def read(ctx):
    stages = getattr(ctx.window, "stages", None)
    return None if stages is None else stages.get("composite")
