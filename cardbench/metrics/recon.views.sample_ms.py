"""Device milliseconds a frame of the operations launched inside the
program's ``recon.views.sample`` span (a multi-view query's projection of
each point into every view and the bilinear sampling of every view's
maps), in the spans' traced stretch of the frame loop
(``harness/spans.py``). Nothing to read where the program records no such
span: a single-view net, or a program without it."""

from cardbench.harness import spans

SPAN = "recon.views.sample"


def read(ctx):
    r = spans.readings(ctx)
    if r is None or SPAN not in r.host_ms:
        return None
    return r.device_ms.get(SPAN, 0.0)
