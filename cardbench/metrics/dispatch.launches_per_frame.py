"""Device kernels launched a frame: every kernel the profiler recorded in
the traced frames (copies and fills not counted), over the frames. Counts
kernels on the device, so a CUDA-graph replay counts as the kernels it
runs."""


def read(ctx):
    return ctx.trace.launches / ctx.trace.frames
