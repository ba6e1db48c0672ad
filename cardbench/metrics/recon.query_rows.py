"""Head-query rows a frame asked for inside the program's ``recon.*``
spans (points of a per-point query, rays of a ray query; the program's
``query`` records), in the spans' recorder-only stretch of the frame
loop (``harness/spans.py``). The rung and the anchor plan set them on a
rotated frame. Nothing to read where the program records no queries."""

from cardbench.harness import spans


def read(ctx):
    r = spans.readings(ctx)
    if r is None or r.layer_host_ms["recon."] is None:
        return None
    return r.layer_rows.get("recon.", 0.0)
