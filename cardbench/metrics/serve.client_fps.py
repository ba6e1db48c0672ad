"""Parts of ``/video_feed`` a second that the local client received over
the window's seconds. The demo's MJPEG handler sends the latest JPEG and
then sleeps 1/30 s (``rtl_main.MJPEGHandler``), so this reads near 30
whenever the pipeline publishes at least that fast: it moves only where
the host starves the server's thread or the pipeline publishes slower.
Nothing to read in a cell that serves no demo."""


def read(ctx):
    parts = getattr(ctx.window, "client_parts", None)
    return None if parts is None else parts / ctx.window.elapsed
