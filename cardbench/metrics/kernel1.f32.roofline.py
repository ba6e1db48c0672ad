"""Kernel 1's share of its roofline on the f32 route, in percent: netC's
colour of the peeled lattice (one tap a ray on a frontal calib, a point
each otherwise; the reference path's ``queries``) over the device time of
the f32 route's kernels launched inside the program's ``texture.query``
span (``harness.spans.roofline``; kernel 2's f32 route shares their
names, so the span tells them apart). Nothing to read under bf16, on
the 'ray' path, without spans, or where the kernel did not run."""

from cardbench.harness import spans

KERNELS = ("xproj_kernel", "mlp_kernel")


def read(ctx):
    if ctx.cell.config["profile"]["compute_dtype"] != "float32":
        return None
    return spans.roofline(ctx, "texture.query", "netC", KERNELS)
