"""Kernel 2's share of its roofline over the hierarchy's levels, in
percent: netG's per-point queries of the levels, at the rows the
reference's copy of the hierarchy gives each traced frame's image, over
the device time of the port's MLP kernels launched inside the program's
``recon.hierarchy`` span (``harness.spans.roofline``). Nothing to read on
the 'ray' path, without spans, or where the kernel did not run."""

from cardbench.harness import spans

KERNELS = ("wgmma_mlp_kernel", "xproj_kernel", "mlp_kernel")


def read(ctx):
    return spans.roofline(ctx, "recon.hierarchy", "netG", KERNELS)
