"""Median host milliseconds of the served demo's segment stage (MatteNet,
DetectNet, the camera and calib, netG's and netC's inputs) over its last
64 frames at the window's close (``runtime.StageStats.median_ms``).
Nothing to read in a cell that serves no demo."""


def read(ctx):
    stages = getattr(ctx.window, "stages", None)
    return None if stages is None else stages.get("segment")
