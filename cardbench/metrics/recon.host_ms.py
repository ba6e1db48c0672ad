"""Host milliseconds a frame inside the program's ``recon.*`` spans (the
march, each refine level, or the hierarchy and its peel), in the spans'
recorder-only stretch of the frame loop (``harness/spans.py``). Nothing
to read where the program records no spans."""

from cardbench.harness import spans


def read(ctx):
    r = spans.readings(ctx)
    return None if r is None else r.layer_host_ms["recon."]
