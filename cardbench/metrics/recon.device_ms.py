"""Device milliseconds a frame of the operations launched inside the
program's ``recon.*`` spans (the march, each refine level, or the
hierarchy and its peel: their queries' kernels and the map work around
them), in the spans' traced stretch of the frame loop
(``harness/spans.py``). Nothing to read where the program records no
spans."""

from cardbench.harness import spans


def read(ctx):
    r = spans.readings(ctx)
    return None if r is None else r.layer_device_ms("recon.")
