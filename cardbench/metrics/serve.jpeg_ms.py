"""Median milliseconds of the composite stage's JPEG encoding (the
served frame's ``jpeg_ms``, ``pipeline/jpeg.py``'s numpy encoder) over
every served frame of the window. Nothing to read in a cell that serves
no demo."""

import statistics


def read(ctx):
    ms = getattr(ctx.window, "jpeg_ms", None)
    return statistics.median(ms) if ms else None
