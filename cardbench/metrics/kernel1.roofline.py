"""Kernel 1's share of its roofline on a frontal frame, in percent: the
least time of the frame's ray-MLP launches (the march, each refine level,
the windowed fine level and netC's colour; ``harness.work``: operations at
the bf16 peak or bytes at the HBM rate, the larger, from the profile's
static shapes) over the device time of the kernel's launches in the
traced frames (the wgmma kernel's ray-epilogue instantiation), a frame.
Nothing to read where the kernel did not run."""

from cardbench.harness import work

KERNEL = ("wgmma_mlp_kernel", "RayEpilogue")


def read(ctx):
    seconds = sum(s for name, (s, _) in ctx.trace.by_name.items()
                  if all(k in name for k in KERNEL))
    if seconds <= 0.0:
        return None
    bound = sum(work.bound_s(work.ray_mlp_work(w, r, t))
                for w, r, t in work.frontal_ray_launches(ctx.cell.config))
    return 100.0 * bound * ctx.trace.frames / seconds
