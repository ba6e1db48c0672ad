"""Device milliseconds a frame of the operations launched inside the
program's ``texture.*`` span (the colour query on the texture canvas),
in the spans' traced stretch of the frame loop (``harness/spans.py``).
Nothing to read where the program records no spans or the cell has no
netC."""

from cardbench.harness import spans


def read(ctx):
    r = spans.readings(ctx)
    return None if r is None else r.layer_device_ms("texture.")
