"""Kernel 1's share of its roofline on the f32 route of a frontal 'ray'
frame, in percent: the least time of the frame's ray-MLP launches (the
march, each refine level, the windowed fine level, and netC's colour
where the configuration has netC; ``harness.work``: operations at the
67 TFLOP/s f32 peak with 4-byte operands, or bytes at the HBM rate, the
larger, from the profile's static shapes) over the device time of the f32
route's kernels (``xproj_kernel`` + ``mlp_kernel``) in the traced frames,
a frame. A frontal frame launches neither kernel 2 nor kernel 3, so those
names are kernel 1's alone there. Nothing to read under bf16, off the
'ray' path, or where the kernels did not run."""

from cardbench.harness import work

KERNELS = ("xproj_kernel", "mlp_kernel")


def read(ctx):
    config = ctx.cell.config
    p = config["profile"]
    if p["compute_dtype"] != "float32" or p["mode"] != "ray":
        return None
    seconds = sum(s for name, (s, _) in ctx.trace.by_name.items()
                  if any(k in name for k in KERNELS))
    if seconds <= 0.0:
        return None
    bound = sum(work.bound_s(work.ray_mlp_work(w, r, t, op_bytes=4,
                                               peak=work.PEAK_F32))
                for w, r, t in work.frontal_ray_launches(config))
    return 100.0 * bound * ctx.trace.frames / seconds
