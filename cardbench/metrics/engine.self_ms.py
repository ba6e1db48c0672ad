"""Host milliseconds a frame in the program's ``engine.frame`` span that
no child span covers (building the query closures, the output dict, the
telemetry stack: the engine's own Python), in the spans' recorder-only
stretch of the frame loop (``harness/spans.py``). Nothing to read where
the program records no spans."""

from cardbench.harness import spans


def read(ctx):
    r = spans.readings(ctx)
    if r is None or spans.ROOT not in r.host_ms:
        return None
    return r.host_ms[spans.ROOT][1]
